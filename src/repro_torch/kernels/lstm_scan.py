"""The masked LSTM recurrence as a hand-written CUDA kernel.

:func:`lstm_scan_fused` takes the precomputed input gates ``xw = x @ wx
+ b``, the mask and the recurrent weights, and returns the final hidden
state of every row, or with stacked heads their predictions, in one
launch of ``csrc/lstm_scan.cu``. The source's header says what bounds
the kernel on an H100 and how the design follows from that.

For a tensor on the CPU the wrapper computes the same function with its
plain PyTorch version (``kernels/ref.py::lstm_scan_ref``); for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as REF

LIB = "lstm_scan"

_count_lock = threading.Lock()
_ENTRY = {torch.float32: "lstm_scan_f32", torch.bfloat16: "lstm_scan_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def max_hidden() -> int:
    """The largest hidden size the kernel takes (``kMaxHidden`` in
    ``csrc/lstm_scan.cu``; it asks the built library)."""
    fn = _build.load(LIB).lstm_scan_max_hidden
    fn.restype = ctypes.c_int
    return fn()


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load(LIB), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def _check(xw, mask, wh, heads) -> None:
    for t in (xw, mask, wh, *heads):
        if t.device != xw.device:
            raise ValueError(f"all tensors must be on {xw.device}, got one "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    if xw.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"need xw (B, S, 4H) and wh (H, 4H), got "
                         f"{tuple(xw.shape)} and {tuple(wh.shape)}")
    hidden = wh.shape[0]
    if wh.shape[1] != 4 * hidden or xw.shape[2] != 4 * hidden:
        raise ValueError(f"xw {tuple(xw.shape)} and wh {tuple(wh.shape)} "
                         f"need 4H == xw.shape[-1] == wh.shape[1]")
    if tuple(mask.shape) != tuple(xw.shape[:2]):
        raise ValueError(f"mask must be (B, S) = {tuple(xw.shape[:2])}, "
                         f"got {tuple(mask.shape)}")
    if mask.dtype != torch.float32:
        raise ValueError(f"mask must be float32, got {mask.dtype}")
    if {t.dtype for t in (xw, wh, *heads)} != {xw.dtype} or \
            xw.dtype not in _ENTRY:
        raise ValueError(
            f"xw, wh and the heads must all be float32 or all bfloat16, "
            f"got {[str(t.dtype) for t in (xw, wh, *heads)]}")
    if heads:
        head_w, head_b = heads
        if head_w.dim() != 2 or head_w.shape[0] != hidden or \
                head_w.shape[1] < 1 or \
                tuple(head_b.shape) != (head_w.shape[1],):
            raise ValueError(f"heads {tuple(head_w.shape)} + "
                             f"{tuple(head_b.shape)} do not follow "
                             f"hidden size {hidden}")


def lstm_scan_fused(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor,
                    head_w: Optional[torch.Tensor] = None,
                    head_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked LSTM recurrence: precomputed gates in, final hidden out.

    xw: (B, S, 4H) = x @ wx + b, float32 or bfloat16; mask: (B, S)
    float32, 1 = valid, 0 = pad (a pad step carries (h, c) through);
    wh: (H, 4H) in xw's dtype. Gates in i, f, g, o order, forget gate +1.
    Returns the final h, (B, H) float32; the carry and the gate math are
    float32 either way. With stacked heads ``head_w`` (H, n) and
    ``head_b`` (n,) in xw's dtype, the same launch applies them to h and
    returns the (B, n) float32 predictions instead, each row's sum in one
    fixed order (batch-invariant, which a matmul after the kernel is not).
    Each launch of the kernel adds one to ``lstm_scan_fused.launches``.
    On a CUDA tensor the kernel takes H <= :func:`max_hidden` and raises
    ValueError above it."""
    if (head_w is None) != (head_b is None):
        raise ValueError("head_w and head_b come together")
    heads = () if head_w is None else (head_w, head_b)
    _check(xw, mask, wh, heads)
    if xw.device.type == "cpu":
        return REF.lstm_scan_ref(xw, mask, wh, *heads)
    if xw.device.type != "cuda":
        raise ValueError(f"no kernel for device {xw.device}")
    return _launch(xw, mask, wh, *heads)


def _launch(xw, mask, wh, head_w=None, head_b=None) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors (no checks here: call
    :func:`lstm_scan_fused`). Counts the launch."""
    B, S, _ = xw.shape
    hidden = int(wh.shape[0])
    out = torch.empty((B, hidden), dtype=torch.float32, device=xw.device)
    pred, n_heads = None, 0
    if head_w is not None:
        n_heads = int(head_w.shape[1])
        pred = torch.empty((B, n_heads), dtype=torch.float32,
                           device=xw.device)
    fn = _entry(xw.dtype)
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = fn(xw.data_ptr(), mask.data_ptr(), wh.data_ptr(),
                None if head_w is None else head_w.data_ptr(),
                None if head_b is None else head_b.data_ptr(), n_heads,
                B, S, hidden, out.data_ptr(),
                None if pred is None else pred.data_ptr(), stream)
    if rc == -1:
        raise ValueError(
            f"lstm_scan_fused: hidden size {hidden} is above the kernel's "
            f"limit kMaxHidden = {max_hidden()} (csrc/lstm_scan.cu)")
    if rc != 0:
        raise RuntimeError(f"lstm_scan kernel launch failed ({rc}): "
                           f"{_build.error_string(LIB, rc)}")
    if B > 0:
        with _count_lock:
            lstm_scan_fused.launches += 1
    return out if pred is None else pred


lstm_scan_fused.launches = 0
