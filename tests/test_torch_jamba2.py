"""``jamba2-3b`` (AI21-Jamba2-3B, a port-only arch) against the plain
reference the benchmark holds it to, ``bench/reference/jamba.py``, on the
CPU: the port's reduced config at one whole 14-layer period (width 64,
d_state 16, one KV head), seeded weights with every leaf moved off its
init, float32 on both sides (the reference's bfloat16 rounding of
product inputs off). The logits, the loss and every gradient; the
chunked scan against the reference's recurrence; three planted faults
that each must fail a comparison; the per-slot recomputation; the LM
step's spans; the scan kernel's wrapper checks (the kernel itself runs
on the card only: ``tests/test_torch_chip.py``)."""
import dataclasses
import functools
import sys
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import jamba as RJ  # noqa: E402
from repro_torch import configs as CFG  # noqa: E402
from repro_torch.kernels import selective_scan as SS  # noqa: E402
from repro_torch.models import mamba as MB  # noqa: E402
from repro_torch.models import model as MODEL  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.obs import trace as OBS  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.params import tree_flatten, tree_unflatten  # noqa: E402

S = 300             # over one 256-step chunk of either scan, not a multiple
ROWS = 2
# float32 on both sides; the sums run in other orders (online softmax
# against softmax, the chunked log-depth scan against the recurrence,
# other matmul blockings): readings 5.6e-6 (logits, over the largest
# logit), 8.1e-8 (loss), 2.4e-5 (the worst gradient leaf, over its
# largest entry); each limit ~10x its reading, each fault >= 1e-4 on the
# loss and >= 0.1 on the logits and gradients
TOL = {"logits": 5e-5, "loss": 1e-6, "grads": 2e-4}


def small_cfg(**kw):
    arch = CFG.get_arch("jamba2-3b")
    return dataclasses.replace(
        arch.reduced(), n_layers=14,
        hybrid=dataclasses.replace(arch.hybrid, d_state=16), **kw)


def ref_dims(cfg):
    return {"eps": cfg.norm_eps, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
            "dt_rank": cfg.d_model // 16, "d_state": cfg.hybrid.d_state,
            "period": cfg.hybrid.period, "attn_index": cfg.hybrid.attn_index}


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    cfg = small_cfg()
    g = torch.Generator().manual_seed(0)
    p = MODEL.init_params(g, cfg)
    # every leaf off its init: gains off 1, biases off 0
    p = tree_unflatten(p, [x + 0.1 * torch.randn(x.shape, generator=g)
                           for x in tree_flatten(p)])
    tok = torch.randint(0, cfg.vocab, (ROWS, S + 1), generator=g)
    return cfg, p, tok[:, :-1], tok[:, 1:]


def _port(cfg, tokens, labels):
    def fn(p):
        logits, _ = MODEL.forward(p, cfg, {"tokens": tokens},
                                  cdt=torch.float32, remat=False)
        return logits, steps.cross_entropy_loss(logits, labels, cfg.vocab)
    return fn


def _ref(cfg, tokens, labels, fault=None):
    plain = RJ.Plain(ref_dims(cfg), bf16=False, fault=fault)

    def fn(p):
        with RJ.ieee():
            return plain.logits(p, tokens), plain.loss(p, tokens, labels)
    return fn


def _run(fn, p):
    flat = [x.detach().clone().requires_grad_() for x in tree_flatten(p)]
    logits, loss = fn(tree_unflatten(p, flat))
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    return logits.detach(), float(loss.detach()), grads


def _gaps(got, want):
    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    return {"logits": rel(got[0], want[0]),
            "loss": abs(got[1] - want[1]) / abs(want[1]),
            "grads": max(rel(a, b) for a, b in zip(got[2], want[2]))}


@pytest.fixture(scope="module")
def reference(setup):
    cfg, p, tokens, labels = setup
    return _run(_ref(cfg, tokens, labels), p)


def test_get_arch_finds_the_port_only_arch():
    cfg = CFG.get_arch("jamba2-3b")
    assert "jamba2-3b" not in CFG.ARCHS and "jamba2-3b" in CFG.PORT_ARCHS
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab, cfg.n_layers) == \
        (2560, 20, 1, 128, 8192, 65536, 28)
    hb = cfg.hybrid
    assert (hb.period, hb.attn_index, hb.d_state, hb.d_conv, hb.expand,
            hb.inner_norms) == (14, 7, 16, 4, 2, True)
    assert cfg.moe is None and not cfg.rope and cfg.tie_embeddings
    assert cfg.norm_eps == 1e-6
    one = steps.abstract_params(dataclasses.replace(cfg, n_layers=14))
    n = sum(x.numel() for x in tree_flatten(one))
    assert 1.59e9 < n < 1.61e9          # one period with the embedding
    mb = one["periods"]["mamba"]
    assert mb["dt_proj"].shape == (1, 13, 160, 5120)
    assert mb["dt_norm"].shape == (1, 13, 160)
    assert mb["b_norm"].shape == mb["c_norm"].shape == (1, 13, 16)
    assert "moe" not in one["periods"]


def test_logits_loss_and_gradients_match_the_reference(setup, reference):
    cfg, p, tokens, labels = setup
    got = _gaps(_run(_port(cfg, tokens, labels), p), reference)
    assert all(got[k] <= TOL[k] for k in TOL), got


@pytest.mark.parametrize("fault", ["bf16_scan", "no_inner_norms",
                                   "chunk_reset", "rope"])
def test_each_fault_fails_a_comparison(setup, reference, fault):
    """A bfloat16 scan state, the inner norms left out or the state
    restarted at each chunk (the reference's), or RoPE applied (the
    port's): each is out of some limit."""
    cfg, p, tokens, labels = setup
    if fault == "rope":
        got = _run(_port(small_cfg(rope=True), tokens, labels), p)
    else:
        got = _run(_ref(cfg, tokens, labels, fault), p)
    gaps = _gaps(got, reference)
    assert any(gaps[k] > TOL[k] for k in TOL), gaps


@pytest.mark.parametrize("B,L,chunk", [(1, 37, 8), (2, 300, 256),
                                       (3, 64, 16)])
def test_chunked_scan_matches_the_recurrence(B, L, chunk):
    g = torch.Generator().manual_seed(L)
    di, N = 12, 16
    x = torch.randn(B, L, di, generator=g)
    dt = torch.rand(B, L, di, generator=g) * 0.3
    A = -torch.exp(torch.randn(di, N, generator=g) * 0.5)
    Bm, Cm = (torch.randn(B, L, N, generator=g) for _ in range(2))
    got = MB.chunked_scan(x, dt, A, Bm, Cm, chunk=chunk)
    plain = RJ.Plain(ref_dims(small_cfg()), bf16=False)
    want = plain.scan(x, dt, A, Bm, Cm)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_per_slot_recomputation_gives_the_same_gradients(setup):
    cfg, p, tokens, labels = setup
    batch = {"tokens": tokens, "labels": labels}
    outs = []
    for remat in (False, True):
        loss_fn = steps.make_loss_fn(cfg, remat=remat)
        flat = [x.detach().clone().requires_grad_() for x in tree_flatten(p)]
        with mock.patch.object(MODEL, "forward", functools.partial(
                MODEL.forward, cdt=torch.float32)):
            total, _ = loss_fn(tree_unflatten(p, flat), batch)
        outs.append(torch.autograd.grad(total, flat))
    # the same sums but for the order in which autograd adds the slots'
    # contributions to a leaf and to the residual stream
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_a_hybrid_without_moe_decodes_as_it_runs_whole(setup):
    cfg, p, tokens, _ = setup
    cache = MODEL.init_cache(cfg, ROWS, 8, kv_dtype=torch.float32)
    full, _ = MODEL.forward(p, cfg, {"tokens": tokens[:, :8]},
                            cdt=torch.float32, remat=False)
    for i in range(8):
        step, cache = MODEL.decode_forward(p, cfg, tokens[:, i:i + 1],
                                           cache, i, cdt=torch.float32)
    torch.testing.assert_close(step, full[:, 7], rtol=1e-4, atol=1e-4)


def test_lm_step_records_its_spans(setup):
    cfg, p, tokens, labels = setup
    tracer = OBS.Tracer(sample_every=1, proc="trainer")
    with mock.patch.object(OBS, "default_tracer", lambda: tracer):
        step = steps.make_train_step(cfg, adamw.AdamWConfig())
    step(p, adamw.init_state(p), {"tokens": tokens[:, :32],
                                  "labels": labels[:, :32]})
    trees = list(OBS.assemble(tracer.recorder.snapshot()).values())
    assert len(trees) == 1
    tree = trees[0]
    root = tree.roots[0]
    assert root["name"] == "lm.step" and root["tags"]["profiled"] is False
    kids = [k["name"] for k in tree.children[root["span"]]]
    assert kids == ["lm.loss_grad", "lm.optimizer"]


def test_scan_wrapper_checks_and_plan():
    x = torch.zeros(2, 5, 8)
    A, D = torch.zeros(8, 16), torch.zeros(8)
    B = torch.zeros(2, 5, 16)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        SS.selective_scan(x, x, A, B, B, D)
    with pytest.raises(ValueError, match="N must be one of"):
        SS.selective_scan(x, x, torch.zeros(8, 12), torch.zeros(2, 5, 12),
                          torch.zeros(2, 5, 12), D)
    with pytest.raises(ValueError, match="float32"):
        SS.selective_scan(x.double(), x, A, B, B, D)
    with pytest.raises(ValueError, match="channels"):
        SS.selective_scan(x, x, A, B, B, torch.zeros(7))
    # 32 channels a block at N=16 (4 lanes a channel), 64 at N=8
    assert SS.n_blocks(5120, 16) == 160 and SS.n_blocks(5120, 8) == 80
    assert SS.n_blocks(70, 8) == 2
    assert SS.n_chunks(4096) == 256 and SS.n_chunks(4097) == 257
    assert SS.workspace_floats(4, 4096, 5120, 16) == \
        4 * 4096 * 160 * 32 + 4 * 5120 * 16 + 4 * 5120


def test_mamba_takes_the_plain_scan_off_the_card(setup):
    cfg, p, tokens, _ = setup
    mp = {k: v[0, 0] for k, v in p["periods"]["mamba"].items()}
    x = torch.randn(ROWS, 40, cfg.d_model)
    with mock.patch.object(SS, "selective_scan",
                           side_effect=AssertionError("kernel on the CPU")):
        out, _ = MB.mamba_apply(mp, x, cfg, cdt=torch.float32)
        y = MB.selective_scan(x[..., :8], x[..., :8].abs(),
                              -torch.ones(8, 16), x[..., :16], x[..., :16],
                              torch.ones(8))
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert y.shape == (ROWS, 40, 8)
