"""The Conv1D cost model's two hand-written CUDA kernels.

* :func:`conv_forward_fused` takes token ids and returns the
  ``(B, n_heads)`` float32 predictions in one launch of
  ``csrc/conv_forward.cu``: embedding gather with the PAD mask, the conv
  tower, the max-pool over every position, the hidden FC stack and the
  stacked heads.
* :func:`conv1d_stack_fused` is the tower alone, in one launch of
  ``csrc/conv_tower.cu``: embedded activations in, pooled features out,
  with a masked max-pool.

Each source's header says what bounds its kernel on an H100 and how the
design follows from that. For tensors on the CPU each wrapper computes
the same function with its plain PyTorch version (``kernels/ref.py``);
for CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as REF

LIB = "conv_forward"
TOWER_LIB = "conv_tower"

_count_lock = threading.Lock()
_ENTRY = {torch.float32: "conv_forward_f32",
          torch.bfloat16: "conv_forward_bf16"}
_TOWER_ENTRY = {torch.float32: "conv_tower_f32",
                torch.bfloat16: "conv_tower_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_PLAN_ERRORS = {
    -1: "layer counts or sizes the kernel does not take (see kMaxConv "
        "and kMaxFc in csrc/conv_forward.cu)",
    -2: "activations that do not fit in shared memory even at one "
        "position per tile"}


def _ints(xs):
    return (ctypes.c_int * max(len(xs), 1))(*xs)


def _plan_error(code: int, seq, embed, filter_sizes, channels,
                fc_dims) -> ValueError:
    return ValueError(
        f"conv_forward_fused: {_PLAN_ERRORS[code]} (seq {seq}, embed "
        f"{embed}, filters {tuple(filter_sizes)}, channels "
        f"{tuple(channels)}, fc {tuple(fc_dims)})")


def plan_tile(seq: int, embed: int, filter_sizes: Sequence[int],
              channels: Sequence[int], fc_dims: Sequence[int]) -> int:
    """Output positions per tile: all of ``seq`` when the kernel's two
    ping-pong activation buffers fit in shared memory, else as many as
    fit. The layout and its limits live in ``csrc/conv_forward.cu``
    (``plan``); this asks the built library. Raises ValueError when not
    even one position fits (COSTMODEL_100M's 1024 channels) or the
    kernel does not take these layer counts."""
    fn = _build.load(LIB).conv_forward_plan_tile
    fn.argtypes = [_I, _I, _I, _IP, _IP, _I, _IP]
    fn.restype = ctypes.c_int
    tile = fn(seq, embed, len(filter_sizes), _ints(filter_sizes),
              _ints(channels), len(fc_dims), _ints(fc_dims))
    if tile < 1:
        raise _plan_error(tile, seq, embed, filter_sizes, channels, fc_dims)
    return tile


def _entry(dtype: torch.dtype):
    """The library's ctypes entry point for ``dtype`` params."""
    fn = getattr(_build.load(LIB), _ENTRY[dtype])
    if fn.argtypes is None:
        pp = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = [_P, _I, _I, _P, _I, _I, _I, pp, pp, _IP, _IP, _I,
                       pp, pp, _IP, _P, _P, _I, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def _check(ids, emb, conv_weights, conv_biases, fc_weights, fc_biases,
           head_w, head_b, check_ids: bool) -> None:
    """Device, dtype, contiguity and shape checks, and with ``check_ids``
    the id range (on a CUDA tensor that reads a reduction back, so the
    host waits for the card)."""
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be (B, S), got {tuple(ids.shape)}")
    if not conv_weights or len(conv_weights) != len(conv_biases):
        raise ValueError("need one bias per conv layer and >= 1 layer")
    if len(fc_weights) != len(fc_biases):
        raise ValueError("need one bias per FC layer")
    params = [emb, *conv_weights, *conv_biases, *fc_weights, *fc_biases,
              head_w, head_b]
    for t in [ids, *params]:
        if t.device != ids.device:
            raise ValueError(f"all tensors must be on {ids.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    dtypes = {t.dtype for t in params}
    if len(dtypes) != 1 or dtypes.pop() not in _ENTRY:
        raise ValueError(f"params must all be float32 or all bfloat16, "
                         f"got {sorted(str(t.dtype) for t in params)}")
    if emb.dim() != 2:
        raise ValueError(f"emb must be (V, E), got {tuple(emb.shape)}")
    width = emb.shape[1]
    for w, b in zip(conv_weights, conv_biases):
        if w.dim() != 3 or w.shape[1] != width or \
                tuple(b.shape) != (w.shape[2],):
            raise ValueError(
                f"conv layer (fs, Cin, Cout)={tuple(w.shape)} with bias "
                f"{tuple(b.shape)} does not follow width {width}")
        width = w.shape[2]
    for w, b in zip(fc_weights, fc_biases):
        if w.dim() != 2 or w.shape[0] != width or \
                tuple(b.shape) != (w.shape[1],):
            raise ValueError(
                f"FC layer {tuple(w.shape)} with bias {tuple(b.shape)} "
                f"does not follow width {width}")
        width = w.shape[1]
    if head_w.dim() != 2 or head_w.shape[0] != width or \
            tuple(head_b.shape) != (head_w.shape[1],):
        raise ValueError(
            f"heads {tuple(head_w.shape)} + {tuple(head_b.shape)} do not "
            f"follow width {width}")
    if check_ids:
        check_id_range(ids, emb.shape[0])


def check_id_range(ids: torch.Tensor, vocab: int) -> None:
    """Raise ValueError unless every id lies in [0, vocab). On a CUDA
    tensor this reads a reduction back, so the host waits for the card."""
    if ids.numel():
        lo, hi = torch.stack(torch.aminmax(ids)).tolist()
        if lo < 0 or hi >= vocab:
            raise ValueError(
                f"token ids must lie in [0, {vocab}), got [{lo}, {hi}]")


def conv_forward_fused(ids: torch.Tensor, emb: torch.Tensor,
                       conv_weights: Sequence[torch.Tensor],
                       conv_biases: Sequence[torch.Tensor],
                       fc_weights: Sequence[torch.Tensor],
                       fc_biases: Sequence[torch.Tensor],
                       head_w: torch.Tensor,
                       head_b: torch.Tensor, *,
                       check_ids: bool = True) -> torch.Tensor:
    """The fused serving forward: token ids -> (B, n_heads) float32.

    ids: (B, S) int32, PAD id 0; emb: (V, E); conv weights (fs, Cin,
    Cout); FC weights (Fin, Fout); head_w: (F, n_heads) with the
    per-target columns stacked. Params are all float32 or all bfloat16;
    arithmetic is float32 either way. Each launch of the kernel adds one
    to ``conv_forward_fused.launches``.

    ``check_ids=False`` skips the id-range check, which on a CUDA tensor
    makes the host wait for the card: for a caller that has checked the
    ids on the host (the service, before it copies them). The kernel
    reads an id outside [0, V) as PAD; it never reads outside the table."""
    _check(ids, emb, conv_weights, conv_biases, fc_weights, fc_biases,
           head_w, head_b, check_ids)
    if ids.device.type == "cpu":
        return REF.conv_forward_fused_ref(
            ids, emb, conv_weights, conv_biases, fc_weights, fc_biases,
            head_w, head_b)
    if ids.device.type != "cuda":
        raise ValueError(f"no kernel for device {ids.device}")
    return _launch(ids, emb, conv_weights, conv_biases, fc_weights,
                   fc_biases, head_w, head_b)


def _launch(ids, emb, conv_weights, conv_biases, fc_weights, fc_biases,
            head_w, head_b) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors (no checks here: call
    :func:`conv_forward_fused`). Counts the launch."""
    B, S = ids.shape
    fs = [int(w.shape[0]) for w in conv_weights]
    c_out = [int(w.shape[2]) for w in conv_weights]
    fc_out = [int(w.shape[1]) for w in fc_weights]
    out = torch.empty((B, head_w.shape[1]), dtype=torch.float32,
                      device=ids.device)

    def ptrs(ts):
        return (ctypes.c_void_p * max(len(ts), 1))(
            *[t.data_ptr() for t in ts])

    fn = _entry(emb.dtype)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        rc = fn(ids.data_ptr(), B, S, emb.data_ptr(), int(emb.shape[0]),
                int(emb.shape[1]), len(fs), ptrs(conv_weights),
                ptrs(conv_biases), _ints(fs), _ints(c_out), len(fc_out),
                ptrs(fc_weights), ptrs(fc_biases), _ints(fc_out),
                head_w.data_ptr(), head_b.data_ptr(), int(head_w.shape[1]),
                out.data_ptr(), stream)
    if rc in _PLAN_ERRORS:
        raise _plan_error(rc, S, int(emb.shape[1]), fs, c_out, fc_out)
    if rc != 0:
        raise RuntimeError(f"conv_forward kernel launch failed ({rc}): "
                           f"{_build.error_string(LIB, rc)}")
    if B == 0:
        return out
    with _count_lock:
        conv_forward_fused.launches += 1
    return out


conv_forward_fused.launches = 0


# ------------------------------------------------------------------ tower
_TOWER_PLAN_ERRORS = {
    -1: "layer counts or sizes the kernel does not take (see kMaxConv in "
        "csrc/conv_tower.cu)",
    -2: "activations that do not fit in shared memory even at one "
        "position per tile"}


def _tower_plan_error(code: int, seq, c_in, filter_sizes,
                      channels) -> ValueError:
    return ValueError(
        f"conv1d_stack_fused: {_TOWER_PLAN_ERRORS[code]} (seq {seq}, "
        f"channels in {c_in}, filters {tuple(filter_sizes)}, channels "
        f"{tuple(channels)})")


def tower_plan_tile(seq: int, c_in: int, filter_sizes: Sequence[int],
                    channels: Sequence[int]) -> int:
    """Output positions per tile of the tower kernel (``plan`` in
    ``csrc/conv_tower.cu``; this asks the built library). Raises
    ValueError when not even one position fits or the kernel does not
    take these layer counts."""
    fn = _build.load(TOWER_LIB).conv_tower_plan_tile
    fn.argtypes = [_I, _I, _I, _IP, _IP]
    fn.restype = ctypes.c_int
    tile = fn(seq, c_in, len(filter_sizes), _ints(filter_sizes),
              _ints(channels))
    if tile < 1:
        raise _tower_plan_error(tile, seq, c_in, filter_sizes, channels)
    return tile


def _tower_entry(dtype: torch.dtype):
    fn = getattr(_build.load(TOWER_LIB), _TOWER_ENTRY[dtype])
    if fn.argtypes is None:
        pp = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = [_P, _P, _I, _I, _I, _I, pp, pp, _IP, _IP, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def _check_tower(x, weights, biases, mask) -> None:
    if not weights or len(weights) != len(biases):
        raise ValueError("need one bias per conv layer and >= 1 layer")
    for t in [x, mask, *weights, *biases]:
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    dtypes = {t.dtype for t in [x, *weights, *biases]}
    if len(dtypes) != 1 or dtypes.pop() not in _TOWER_ENTRY:
        raise ValueError(
            f"x and the params must all be float32 or all bfloat16, got "
            f"{sorted(str(t.dtype) for t in [x, *weights, *biases])}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, C), got {tuple(x.shape)}")
    if mask.dtype != torch.float32 or tuple(mask.shape) != tuple(
            x.shape[:2]):
        raise ValueError(f"mask must be float32 (B, S) = "
                         f"{tuple(x.shape[:2])}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    width = x.shape[2]
    for w, b in zip(weights, biases):
        if w.dim() != 3 or w.shape[1] != width or \
                tuple(b.shape) != (w.shape[2],):
            raise ValueError(
                f"conv layer (fs, Cin, Cout)={tuple(w.shape)} with bias "
                f"{tuple(b.shape)} does not follow width {width}")
        width = w.shape[2]


def conv1d_stack_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor],
                       mask: torch.Tensor) -> torch.Tensor:
    """The conv tower with a masked max-pool: (B, S, C0) -> (B, C_last).

    x: embedded activations; weights (fs, Cin, Cout) and biases (Cout,),
    all float32 or all bfloat16 with x; mask: (B, S) float32, 1 = valid.
    Positions where the mask is 0 never enter the max, and the result is
    floored at 0 (an all-masked row pools to 0). Arithmetic is float32;
    the output has x's dtype. Each launch of the kernel adds one to
    ``conv1d_stack_fused.launches``."""
    _check_tower(x, weights, biases, mask)
    if x.device.type == "cpu":
        return REF.conv1d_stack_ref(
            x.float(), [w.float() for w in weights],
            [b.float() for b in biases], mask).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch_tower(x, weights, biases, mask)


def _launch_tower(x, weights, biases, mask) -> torch.Tensor:
    """Launch the tower kernel on checked CUDA tensors (no checks here:
    call :func:`conv1d_stack_fused`). Counts the launch."""
    B, S, c_in = (int(n) for n in x.shape)
    fs = [int(w.shape[0]) for w in weights]
    c_out = [int(w.shape[2]) for w in weights]
    out = torch.empty((B, c_out[-1]), dtype=x.dtype, device=x.device)

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

    fn = _tower_entry(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), mask.data_ptr(), B, S, c_in, len(fs),
                ptrs(weights), ptrs(biases), _ints(fs), _ints(c_out),
                out.data_ptr(), stream)
    if rc in _TOWER_PLAN_ERRORS:
        raise _tower_plan_error(rc, S, c_in, fs, c_out)
    if rc != 0:
        raise RuntimeError(f"conv_tower kernel launch failed ({rc}): "
                           f"{_build.error_string(TOWER_LIB, rc)}")
    if B == 0:
        return out
    with _count_lock:
        conv1d_stack_fused.launches += 1
    return out


conv1d_stack_fused.launches = 0
