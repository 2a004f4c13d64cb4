"""The port's StableHLO lowering (``repro_torch.ir.stablehlo``, traced by
PyTorch on fake tensors and printed by the port) against the reference's
(``repro.ir.stablehlo``, lowered by JAX) on the CPU: every per-layer
subgraph of the ten registered architectures has the reference's
signature, products and compute opcodes through the front door; the
sample corpus draws the reference's shapes, counts XLA's flops and ranks
latency as XLA does; the op-level flop conventions hold against
``cost_analysis()``; the reference's service tests of the pathway pass
on the port; and lowering materializes no tensor data."""
import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from repro.ir import stablehlo as R_SH
from repro_torch import params as P
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import tokenizer as TOK
from repro_torch.core import trainer as TR
from repro_torch.ir import dataset as DS
from repro_torch.ir import frontdoor as FD
from repro_torch.ir import stablehlo as SH

LAYERS = ("attention", "mlp_swiglu", "rmsnorm_residual", "lm_head")
ARCH_ROWS = [(a, layer) for a in sorted(ARCHS)
             for layer in LAYERS + (("moe_router",) if get_arch(a).moe
                                    else ())]
# opcodes (after the front door's OPCODE_MAP) that move or make data
# without computing; the compute multiset leaves them out
NON_COMPUTE = {"constant", "broadcast", "reshape", "transpose"}
FLOP_RTOL = 0.05          # port flops against XLA's cost_analysis()
MIN_SPEARMAN = 0.9        # latency_us ranks against the reference's
_MAIN = re.compile(r"func\.func public @main\(([^)]*)\) -> \(?"
                   r"(tensor<[^>]*>)")


def _signature(text):
    m = _MAIN.search(text)
    assert m is not None, text[:200]
    return re.findall(r"tensor<[^>]*>", m.group(1)), m.group(2)


def _compute_ops(graph):
    return collections.Counter(op.opcode for op in graph.ops
                               if op.opcode not in NON_COMPUTE)


def _spearman(a, b):
    def ranks(x):
        x = np.asarray(x, dtype=np.float64)
        r = np.empty(len(x))
        r[x.argsort(kind="stable")] = np.arange(len(x))
        for v in np.unique(x):             # ties share their mean rank
            r[x == v] = r[x == v].mean()
        return r
    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


@pytest.fixture(scope="module")
def ref_arch():
    return {(a, layer): t for a, layer, t in R_SH.lower_arch_corpus()}


@pytest.fixture(scope="module")
def port_arch():
    return {(a, layer): t for a, layer, t in SH.lower_arch_corpus()}


@pytest.fixture(scope="module")
def samples():
    rows = 32
    return (R_SH.sample_stablehlo_corpus(np.random.default_rng(0), rows),
            SH.sample_stablehlo_corpus(np.random.default_rng(0), rows))


# ------------------------------------------------------------ arch corpus
def test_arch_corpus_covers_every_registered_arch(port_arch, ref_arch):
    assert len(ARCH_ROWS) == 43
    assert list(port_arch) == list(ref_arch) == ARCH_ROWS


@pytest.mark.parametrize("arch,layer", ARCH_ROWS)
def test_arch_row_matches_reference(arch, layer, port_arch, ref_arch):
    """Signature, one dot_general a product, and the compute opcodes the
    front door recovers all equal the reference's; so does the full
    opcode sequence with its shapes (the struct key)."""
    text, want = port_arch[(arch, layer)], ref_arch[(arch, layer)]
    assert "stablehlo." in text and "func.func" in text
    assert "jax" not in text and "@jit_" not in text
    g, rg = FD.parse_mlir(text), FD.parse_mlir(want)
    assert g is not None and rg is not None
    assert _signature(text) == _signature(want)
    assert text.count("stablehlo.dot_general") == \
        want.count("stablehlo.dot_general")
    assert _compute_ops(g) == _compute_ops(rg)
    assert g.struct_key() == rg.struct_key()


def test_arch_specs_are_meta_and_lowering_allocates_nothing():
    """Every spec is a meta tensor (shape and dtype, no storage), and
    lowering all ten archs allocates under 1% of the bytes the specs
    describe (measured: 160 bytes, torch's scalar wrappers)."""
    spec_bytes = 0
    for name in sorted(ARCHS):
        for _, _, specs in SH.arch_subgraphs(name):
            for s in specs:
                assert s.device.type == "meta"
                spec_bytes += s.numel() * s.element_size()
    SH.lower_arch_corpus(["qwen3-0.6b"])             # first-use set-up
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        rows = SH.lower_arch_corpus(None)
    allocated = sum(e.cpu_memory_usage for e in prof.events()
                    if e.cpu_memory_usage > 0)
    assert len(rows) == 43
    assert allocated < spec_bytes / 100, (allocated, spec_bytes)


# ---------------------------------------------------------- sample corpus
def test_sample_corpus_draws_the_references_shapes(samples):
    want, got = samples
    assert len(got) == len(want) == 32
    for (t, _), (r, _) in zip(got, want):
        assert _signature(t) == _signature(r)
        assert t.count("stablehlo.dot_general") == \
            r.count("stablehlo.dot_general")
        assert FD.parse_mlir(t).struct_key() == \
            FD.parse_mlir(r).struct_key()


def test_sample_flops_match_xla(samples):
    """Within 5% of XLA's cost_analysis() on every row where XLA counts
    flops, the norm-residual rows (no product at all) included."""
    want, got = samples
    checked = 0
    for i, ((_, g), (_, r)) in enumerate(zip(got, want)):
        if r["flops"] > 0:
            assert g["flops"] == pytest.approx(r["flops"], rel=FLOP_RTOL), i
            checked += 1
        assert g["bytes"] > 0 and g["latency_us"] > 0
    assert checked == 32


def test_sample_latency_ranks_as_the_reference(samples):
    want, got = samples
    rho = _spearman([g["latency_us"] for _, g in got],
                    [r["latency_us"] for _, r in want])
    assert rho >= MIN_SPEARMAN, rho


# One op at a time: (jax function, torch function, argument shapes).
# XLA's cost analysis of the JAX function is the yardstick for the
# port's count over its own printed ops.
N3 = (4, 8, 32)
OPS = {
    "add": (lambda a, b: a + b, lambda a, b: a + b, (N3, N3)),
    "multiply": (lambda a, b: a * b, lambda a, b: a * b, (N3, N3)),
    "divide": (lambda a, b: a / b, lambda a, b: a / b, (N3, N3)),
    "maximum": (jnp.maximum, torch.maximum, (N3, N3)),
    "negate": (lambda a: -a, lambda a: -a, (N3,)),
    "exponential": (jnp.exp, torch.exp, (N3,)),
    "tanh": (jnp.tanh, torch.tanh, (N3,)),
    "rsqrt": (jax.lax.rsqrt, torch.rsqrt, (N3,)),
    "log": (jnp.log, torch.log, (N3,)),
    "sqrt": (jnp.sqrt, torch.sqrt, (N3,)),
    "abs": (jnp.abs, torch.abs, (N3,)),
    "minimum": (jnp.minimum, torch.minimum, (N3, N3)),
    "sigmoid": (jax.nn.sigmoid, torch.sigmoid, (N3,)),
    "power": (lambda a: a ** 0.5, lambda a: a ** 0.5, (N3,)),
    "expand_dims": (lambda a: jnp.broadcast_to(a[:, None], (4, 3, 8, 32)),
                    lambda a: a.unsqueeze(1).expand(4, 3, 8, 32), (N3,)),
    "transpose": (lambda a: a.transpose(0, 2, 1),
                  lambda a: a.permute(0, 2, 1), (N3,)),
    "scalar": (lambda a: a * 3.0 + 1.0, lambda a: a * 3.0 + 1.0, (N3,)),
    "sum": (lambda a: a.sum(-1), lambda a: a.sum(-1), (N3,)),
    "max_reduce": (lambda a: a.max(-1), lambda a: a.amax(-1), (N3,)),
    "mean": (lambda a: a.mean(-1, keepdims=True),
             lambda a: a.mean(-1, keepdim=True), (N3,)),
    "square": (lambda a: a ** 2, lambda a: a ** 2, (N3,)),
    "cube": (lambda a: a ** 3, lambda a: a ** 3, (N3,)),
    "matmul": (lambda a, w: a @ w, lambda a, w: a @ w, (N3, (32, 48))),
    "batched": (lambda q, k: jnp.einsum("bqhd,bkhd->bhqk", q, k),
                lambda q, k: q.permute(0, 2, 1, 3) @ k.permute(0, 2, 3, 1),
                ((2, 8, 4, 16), (2, 8, 4, 16))),
    "conv_same": (
        lambda x, w: jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")),
        lambda x, w: F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                              padding=1).permute(0, 2, 3, 1),
        ((2, 9, 9, 8), (3, 3, 8, 16))),
    "relu": (jax.nn.relu, lambda a: F.relu(a), (N3,)),
    "silu": (jax.nn.silu, lambda a: F.silu(a), (N3,)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_flop_convention_matches_xla(name):
    jfn, tfn, shapes = OPS[name]
    got = SH.lower_fn(tfn, *[SH._spec(*s) for s in shapes])[1]["flops"]
    compiled = jax.jit(jfn).lower(
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    assert got == float(ca.get("flops", 0.0))


def test_lower_fn_names_an_op_it_cannot_print():
    with pytest.raises(NotImplementedError, match="cumsum"):
        SH.lower_fn(lambda a: torch.cumsum(a, 0), SH._spec(4, 4))


# --------------------------------- mirrors of tests/test_service.py:111-135
def test_stablehlo_pathway_tokenizes():
    """The port's lowered MLIR text is real and tokenizable; its targets
    follow the roofline constants."""
    rows = SH.sample_stablehlo_corpus(np.random.default_rng(0), n=4)
    assert len(rows) == 4
    for text, targets in rows:
        assert "stablehlo" in text or "func.func" in text
        assert len(TOK.tokenize_text(text)) > 10
        assert targets["latency_us"] >= 0


def test_text_dataset_from_stablehlo():
    """build_text_dataset over the port's lowered MLIR, then a tiny
    model trained on its latency targets on the CPU."""
    rows = SH.sample_stablehlo_corpus(np.random.default_rng(1), n=8)
    ds = DS.build_text_dataset(rows, max_seq=256, vocab_size=1024)
    assert ds.ids.shape == (8, 256)
    assert ds.mode == "text"
    assert "latency_us" in ds.targets and (ds.targets["flops"] >= 0).all()
    cfg = CostModelConfig(name="text", vocab_size=1024, max_seq=256,
                          embed_dim=16, conv_channels=(16,) * 2,
                          fc_dims=(16,))
    res = TR.TrainEngine("conv1d", cfg, "latency_us", steps=5,
                         batch_size=4, device="cpu").fit(ds)
    assert res.stats["steps"] == 5
    assert all(np.isfinite(leaf).all()
               for leaf in P.tree_leaves(P.to_numpy(res.params)))
