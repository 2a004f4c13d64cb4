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
import functools
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as REF

LIB = "conv_forward"
TOWER_LIB = "conv_tower"

_ENTRY = {torch.float32: "conv_forward_f32",
          torch.bfloat16: "conv_forward_bf16"}
_TOWER_ENTRY = {torch.float32: "conv_tower_f32",
                torch.bfloat16: "conv_tower_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_LLP = ctypes.POINTER(ctypes.c_longlong)
_PP = ctypes.POINTER(ctypes.c_void_p)
_ARGS = (_P, _I, _I, _P, _I, _I, _I, _PP, _PP, _IP, _IP, _I, _PP, _PP, _IP,
         _P, _P, _I, _P, _P, ctypes.c_size_t, _P)
_TOWER_ARGS = (_P, _P, _I, _I, _I, _I, _PP, _PP, _IP, _IP, _P, _P,
               ctypes.c_size_t, _P)
_SMEM = ("activations and a staged tap of weights that do not fit in "
         "shared memory even at one position per tile")
_SIZES = " (seq {}, embed {}, filters {}, channels {}, fc {})"
_TOWER_SIZES = " (seq {}, channels in {}, filters {}, channels {})"
_WORKSPACE = "kernel launch failed (-3): workspace smaller than the plan's"
# each library's own return codes (its plan's and its launch's): the
# exception and its message, formatted with the sizes
_ERRORS = {
    -1: (ValueError, "conv_forward_fused: layer counts or sizes the kernel "
         "does not take (see kMaxConv in csrc/conv_tile.cuh and kMaxFc in "
         "csrc/conv_forward.cu)" + _SIZES),
    -2: (ValueError, "conv_forward_fused: " + _SMEM + _SIZES),
    -3: (RuntimeError, f"{LIB} {_WORKSPACE}")}
_TOWER_ERRORS = {
    -1: (ValueError, "conv1d_stack_fused: layer counts or sizes the kernel "
         "does not take (see kMaxConv in csrc/conv_tile.cuh)" + _TOWER_SIZES),
    -2: (ValueError, "conv1d_stack_fused: " + _SMEM + _TOWER_SIZES),
    -3: (RuntimeError, f"{TOWER_LIB} {_WORKSPACE}")}


PLAN_KEYS = ("tile", "n_tiles", "blocks", "smem", "workspace")


def plan(batch: int, seq: int, embed: int, filter_sizes: Sequence[int],
         channels: Sequence[int], fc_dims: Sequence[int]) -> dict:
    """The kernel's tile plan for a (batch, seq) launch: ``tile`` output
    positions a block, ``n_tiles`` blocks a row, ``blocks`` in all,
    ``smem`` bytes of shared memory a block and ``workspace`` bytes of
    pooled partials and row counters. The rules live in
    ``csrc/conv_tile.cuh`` (``tile_plan``); this asks the built library.
    Raises ValueError when not even one position fits (COSTMODEL_100M's
    1024 channels) or the kernel does not take these layer counts."""
    return dict(zip(PLAN_KEYS, _forward_plan(
        batch, seq, embed, tuple(filter_sizes), tuple(channels),
        tuple(fc_dims))))


@functools.lru_cache(maxsize=1024)
def _forward_plan(batch, seq, embed, filter_sizes, channels, fc_dims):
    fn = _build.bind(_build.load(LIB), "conv_forward_plan",
                     (_I, _I, _I, _I, _IP, _IP, _I, _IP, _LLP))
    info = (ctypes.c_longlong * len(PLAN_KEYS))()
    rc = fn(batch, seq, embed, len(filter_sizes), _ints(filter_sizes),
            _ints(channels), len(fc_dims), _ints(fc_dims), info)
    _build.check(LIB, rc, _ERRORS, (seq, embed, filter_sizes, channels,
                                    fc_dims))
    return tuple(info)


def _ptrs(ts) -> tuple:
    return tuple(t.data_ptr() for t in ts)


# ctypes arrays for a launch's pointer and size lists, built once for each
# tuple of values (a service's params repeat on every call); an array
# depends only on its key, so a cached one is never stale
@functools.lru_cache(maxsize=256)
def _ptr_array(ptrs: tuple):
    return (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)


@functools.lru_cache(maxsize=256)
def _ints(xs: tuple):
    return (ctypes.c_int * max(len(xs), 1))(*xs)


def _workspace(info, device) -> torch.Tensor:
    """A launch's pooled partials and row counters, from PyTorch's caching
    allocator on the current stream (the kernel zeroes the counters on
    that stream), so launches on two streams never share one."""
    return torch.empty(max(info[PLAN_KEYS.index("workspace")], 16),
                       dtype=torch.uint8, device=device)


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
    fs = tuple(w.shape[0] for w in conv_weights)
    c_out = tuple(w.shape[2] for w in conv_weights)
    fc_out = tuple(w.shape[1] for w in fc_weights)
    E = emb.shape[1]
    out = torch.empty((B, head_w.shape[1]), dtype=torch.float32,
                      device=ids.device)
    info = _forward_plan(B, S, E, fs, c_out, fc_out)
    if B == 0:
        return out
    work = _workspace(info, ids.device)
    _build.launch(
        conv_forward_fused, LIB,
        _build.bind(_build.load(LIB), _ENTRY[emb.dtype], _ARGS), ids.device,
        (ids.data_ptr(), B, S, emb.data_ptr(), emb.shape[0], E, len(fs),
         _ptr_array(_ptrs(conv_weights)), _ptr_array(_ptrs(conv_biases)),
         _ints(fs), _ints(c_out), len(fc_out), _ptr_array(_ptrs(fc_weights)),
         _ptr_array(_ptrs(fc_biases)), _ints(fc_out), head_w.data_ptr(),
         head_b.data_ptr(), head_w.shape[1], out.data_ptr(),
         work.data_ptr(), work.numel()),
        _ERRORS, (S, E, fs, c_out, fc_out))
    return out


conv_forward_fused.launches = 0


# ------------------------------------------------------------------ tower
def tower_plan(batch: int, seq: int, c_in: int, filter_sizes: Sequence[int],
               channels: Sequence[int]) -> dict:
    """The tower kernel's tile plan, with :func:`plan`'s keys (the same
    rules, ``csrc/conv_tile.cuh``; this asks the built library). Raises
    ValueError when not even one position fits or the kernel does not
    take these layer counts."""
    return dict(zip(PLAN_KEYS, _tower_plan(
        batch, seq, c_in, tuple(filter_sizes), tuple(channels))))


@functools.lru_cache(maxsize=1024)
def _tower_plan(batch, seq, c_in, filter_sizes, channels):
    fn = _build.bind(_build.load(TOWER_LIB), "conv_tower_plan",
                     (_I, _I, _I, _I, _IP, _IP, _LLP))
    info = (ctypes.c_longlong * len(PLAN_KEYS))()
    rc = fn(batch, seq, c_in, len(filter_sizes), _ints(filter_sizes),
            _ints(channels), info)
    _build.check(TOWER_LIB, rc, _TOWER_ERRORS,
                 (seq, c_in, filter_sizes, channels))
    return tuple(info)


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
    B, S, c_in = x.shape
    fs = tuple(w.shape[0] for w in weights)
    c_out = tuple(w.shape[2] for w in weights)
    out = torch.empty((B, c_out[-1]), dtype=x.dtype, device=x.device)
    info = _tower_plan(B, S, c_in, fs, c_out)
    if B == 0:
        return out
    work = _workspace(info, x.device)
    _build.launch(
        conv1d_stack_fused, TOWER_LIB,
        _build.bind(_build.load(TOWER_LIB), _TOWER_ENTRY[x.dtype],
                    _TOWER_ARGS), x.device,
        (x.data_ptr(), mask.data_ptr(), B, S, c_in, len(fs),
         _ptr_array(_ptrs(weights)), _ptr_array(_ptrs(biases)), _ints(fs),
         _ints(c_out), out.data_ptr(), work.data_ptr(), work.numel()),
        _TOWER_ERRORS, (S, c_in, fs, c_out))
    return out


conv1d_stack_fused.launches = 0
