"""The plain conv path's float32 precision guard (the card's TF32 repair)
on the CPU: the guarded convolution computes what ``F.conv1d`` computes,
forward and backward, and the guard sets cuDNN's float32 precision to
IEEE inside and gives the caller's switches back, from any thread. The
card itself is held against the CPU in ``tests/test_torch_chip.py``."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.core import models as CM

CUDNN = torch.backends.cudnn


def switches():
    try:
        legacy = CUDNN.allow_tf32
    except RuntimeError:         # mixed legacy and per-op settings
        legacy = "mixed"
    return legacy, (CUDNN.conv.fp32_precision, CUDNN.rnn.fp32_precision)


@pytest.fixture
def restore_switches():
    legacy = CUDNN.allow_tf32
    per_op = switches()[1]
    yield
    CUDNN.allow_tf32 = legacy
    CUDNN.conv.fp32_precision, CUDNN.rnn.fp32_precision = per_op


def test_guarded_conv_equals_conv1d_forward_and_backward():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 17)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 5, 2)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((3, 7, 16)).astype(np.float32))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    ya = CM._IEEEConv1d.apply(xa, wa)
    yb = F.conv1d(xb, wb)
    ga = torch.autograd.grad(ya, (xa, wa), gy)
    gb = torch.autograd.grad(yb, (xb, wb), gy)
    assert torch.equal(ya, yb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    # only the weight's gradient asked for
    (gw,) = torch.autograd.grad(CM._IEEEConv1d.apply(x, wa), (wa,), gy)
    assert torch.equal(gw, gb[1])
    # and no graph under inference mode
    with torch.inference_mode():
        assert torch.equal(CM._IEEEConv1d.apply(x, w), yb.detach())


def test_guarded_conv_gradcheck():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 9))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((4, 3, 3))).requires_grad_()
    assert torch.autograd.gradcheck(CM._IEEEConv1d.apply, (x, w))


@pytest.mark.parametrize("start", ["default", "legacy_off", "mixed"])
def test_guard_sets_ieee_and_restores(start, restore_switches):
    if start == "legacy_off":
        CUDNN.allow_tf32 = False
    elif start == "mixed":
        CUDNN.conv.fp32_precision = "tf32"
        CUDNN.rnn.fp32_precision = "ieee"
    before = switches()
    with CM.ieee_convolutions():
        assert switches() == (False, ("ieee", "ieee"))
    assert switches() == before
    with pytest.raises(ValueError):
        with CM.ieee_convolutions():
            raise ValueError("inside")
    assert switches() == before


def test_guard_restores_across_threads(restore_switches):
    """Threads entering the guard at once never leave IEEE behind."""
    CUDNN.allow_tf32 = True
    before = switches()
    seen = []

    def worker():
        for _ in range(200):
            with CM.ieee_convolutions():
                seen.append(switches()[0])
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen and not any(seen)
    assert switches() == before
