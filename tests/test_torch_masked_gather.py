"""The conv1d lookup with the PAD mask folded in (kernels/embed_grad.py)
on the CPU: its forward is the lookup times the mask bit for bit, its
plain backward is autograd's table gradient through that expression, PAD's
row gets none, the wrapper refuses what the kernel does not take, and
only the conv1d encoder goes through the op. The CUDA kernel is tested on
the card by tests/test_torch_chip.py."""
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import params as P
from repro_torch.configs import costmodel as CFGS
from repro_torch.core import models as CM
from repro_torch.kernels import embed_grad as EG
from repro_torch.models import layers as LAYERS
from repro_torch.runtime import sharding as SH

V, E = 512, 16
DTYPES = [torch.float32, torch.bfloat16, torch.float64]
# PAD's share of the positions, and the share of the other positions that
# one id fills
CASES = {"pad0": (0.0, 0.0), "pad50": (0.5, 0.0), "pad95": (0.95, 0.0),
         "pad50_hot90": (0.5, 0.9)}


def case_ids(case: str, seed: int = 0, B: int = 24, S: int = 40):
    pad, hot = CASES[case]
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, (B, S))
    ids[rng.random((B, S)) < hot] = 7
    ids[rng.random((B, S)) < pad] = 0
    return torch.from_numpy(ids)


def table_and_grad(dtype, ids, seed=1):
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((V, E), generator=g).to(dtype)
    grad = torch.randn((*ids.shape, E), generator=g).to(dtype)
    return table, grad


def expression(table, ids):
    """The conv1d encoder's lookup as it ran before the op."""
    return table[ids] * (ids != 0).to(table.dtype)[..., None]


def autograd_table_grad(table, ids, grad):
    t = table.detach().requires_grad_(True)
    return torch.autograd.grad(expression(t, ids), t, grad)[0]


@pytest.fixture
def one_thread():
    """CPU autograd sums a float32 index_put_ with atomic adds across
    threads, in no fixed order; on one thread it adds in position order."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_is_lookup_times_mask(case, dtype):
    ids = case_ids(case)
    table, _ = table_and_grad(dtype, ids)
    got = EG.masked_gather(table, ids)
    assert got.dtype == dtype
    assert torch.equal(got, expression(table, ids))
    assert torch.equal(got, SH.gather_rows(table, ids)
                       * CM._mask(ids).to(dtype)[..., None])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_backward_is_autograds(one_thread, dtype, case):
    """Bit for bit: both add each id's rows into zeros of the rows' dtype
    in position order."""
    ids = case_ids(case)
    table, grad = table_and_grad(dtype, ids)
    want = autograd_table_grad(table, ids, grad)
    assert torch.equal(EG.embed_grad(grad, ids, V), want)
    t = table.clone().requires_grad_(True)
    EG.masked_gather(t, ids).backward(grad)
    assert torch.equal(t.grad, want)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_in_bfloat16_sums_in_float32(one_thread, case):
    """The op sums bf16 rows in float32 and rounds once: bit for bit
    autograd's float32 gradient of the widened expression, rounded to
    bf16. Autograd's own bf16 gradient rounds every partial sum to bf16
    (8 bits), so it sits up to (count - 1) x 2^-8 x the id's sum of
    |rows| away from the op's, plus the op's one rounding."""
    ids = case_ids(case)
    table, grad = table_and_grad(torch.bfloat16, ids)
    got = EG.embed_grad(grad, ids, V)
    assert got.dtype == torch.bfloat16
    want32 = autograd_table_grad(table.float(), ids, grad.float())
    assert torch.equal(got, want32.to(torch.bfloat16))
    bf16 = autograd_table_grad(table, ids, grad).float()
    keep = (ids != 0).reshape(-1)
    flat = ids.reshape(-1)[keep]
    count = torch.zeros(V).index_add_(0, flat, torch.ones(len(flat)))
    mass = torch.zeros(V, E).index_add_(
        0, flat, grad.reshape(-1, E)[keep].float().abs())
    bound = (count[:, None] * 2.0 ** -8 + 2.0 ** -8) * mass
    assert bool(((got.float() - bf16).abs() <= bound).all())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_pad_row_gets_no_gradient(case, dtype):
    ids = case_ids(case)
    table, grad = table_and_grad(dtype, ids)
    t = table.requires_grad_(True)
    EG.masked_gather(t, ids).backward(grad)
    assert t.grad.dtype == dtype
    assert not t.grad[0].any()
    absent = torch.ones(V, dtype=torch.bool)
    absent[ids.reshape(-1)] = False
    assert not t.grad[absent].any()
    if CASES[case][0] < 0.9:
        assert t.grad[1:].any()


def test_ids_get_no_gradient_and_int32_ids_match_int64():
    ids = case_ids("pad50_hot90")
    table, grad = table_and_grad(torch.float32, ids)
    assert torch.equal(EG.embed_grad(grad, ids, V),
                       EG.embed_grad(grad, ids.to(torch.int32), V))
    t = table.requires_grad_(True)
    out = EG.masked_gather(t, ids.to(torch.int32))
    assert out.requires_grad and not ids.requires_grad


def test_plain_path_counts_no_launch():
    ids = case_ids("pad50")
    _, grad = table_and_grad(torch.float32, ids)
    before = EG.embed_grad.launches
    EG.embed_grad(grad, ids, V)
    assert EG.embed_grad.launches == before


def test_the_op_imports_only_the_build_module():
    """embed_grad sits below core.models, which imports it: in a fresh
    interpreter, importing it and running its launch path on an empty
    lookup imports neither core.models nor conv1d_stack."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys, torch\n"
        "from repro_torch.kernels import embed_grad as EG\n"
        "out = EG._launch(torch.zeros((0, 4)), torch.zeros(0, "
        "dtype=torch.int32), 8)\n"
        "assert out.shape == (8, 4)\n"
        "print(' '.join(m for m in sys.modules "
        "if m.startswith('repro_torch')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(src)))
    assert proc.returncode == 0, proc.stderr
    loaded = set(proc.stdout.split())
    assert "repro_torch.kernels.embed_grad" in loaded
    assert not loaded & {"repro_torch.core.models",
                         "repro_torch.kernels.conv1d_stack"}, loaded


@pytest.mark.parametrize("bad", ["half", "float_ids", "shape", "width",
                                 "strided", "vocab0", "device", "meta"])
def test_wrapper_refuses(bad):
    ids = case_ids("pad50")
    _, grad = table_and_grad(torch.float32, ids)
    vocab = V
    if bad == "half":
        grad = grad.half()
    elif bad == "float_ids":
        ids = ids.float()
    elif bad == "shape":
        ids = ids[:, :-1].contiguous()
    elif bad == "width":
        grad = grad[..., 0].contiguous()
    elif bad == "strided":
        grad = grad.transpose(0, 1)
        ids = ids.t().contiguous()
    elif bad == "vocab0":
        vocab = 0
    elif bad == "device":
        ids = ids.to("meta")
    else:
        grad, ids = grad.to("meta"), ids.to("meta")
    with pytest.raises(ValueError):
        EG.embed_grad(grad, ids, vocab)


def _params(kind, seed=0):
    init, _ = CM.get_model(kind)
    return init(CFGS.COSTMODEL_SMALL, None,
                generator=torch.Generator().manual_seed(seed))


def test_conv_encode_goes_through_the_op():
    ids = case_ids("pad50", B=4, S=24)
    p = _params("conv1d")
    with mock.patch.object(EG, "masked_gather",
                           wraps=EG.masked_gather) as spy:
        CM.conv_encode(p, ids)
    assert spy.call_count == 1


@pytest.mark.parametrize("kind", ["fc", "lstm", "xformer"])
def test_other_families_keep_their_lookup(kind):
    ids = case_ids("pad50", B=4, S=24)
    p = _params(kind)
    with mock.patch.object(EG, "masked_gather",
                           wraps=EG.masked_gather) as spy, \
            mock.patch.object(SH, "gather_rows",
                              wraps=SH.gather_rows) as rows:
        CM.ENCODERS[kind](p, ids)
    assert spy.call_count == 0 and rows.call_count == 1


def test_lm_lookup_keeps_gather_rows():
    """Id 0 is a token in the LM: its lookup takes no mask."""
    table = torch.randn(V, E)
    ids = case_ids("pad50", B=2, S=8)
    with mock.patch.object(EG, "masked_gather",
                           wraps=EG.masked_gather) as spy:
        out = LAYERS.embed_apply({"table": table}, ids, torch.float32)
    assert spy.call_count == 0
    assert torch.equal(out[ids == 0], table[0].expand(int((ids == 0).sum()),
                                                     E))


def test_conv_model_gradients_unchanged(one_thread):
    """Every leaf's gradient through conv_apply with the op equals the
    gradient through the expression it replaced, bit for bit."""
    ids = case_ids("pad50_hot90", B=6, S=24)
    y = torch.randn(6)
    p = _params("conv1d", seed=3)

    def grads():
        flat = [x.detach().requires_grad_(True) for x in P.tree_flatten(p)]
        out = CM.conv_apply(P.tree_unflatten(p, flat), ids)
        return torch.autograd.grad(((out - y) ** 2).mean(), flat)

    got = grads()
    with mock.patch.object(EG, "masked_gather", expression):
        want = grads()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
