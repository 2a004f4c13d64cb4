"""The masked LSTM recurrence as a hand-written CUDA kernel.

Two entries launch the one kernel of ``csrc/lstm_scan.cu``; they differ
only in how a step finds its input gates:

* :func:`lstm_scan_fused` takes the precomputed input gates ``xw = x @
  wx + b`` and the mask: the counterpart of the TPU kernel, with its
  signature.
* :func:`lstm_scan_ids` takes the (V, 4H) projection table ``emb @ wx +
  b`` and the token ids, and gathers each step's gates inside the kernel
  (the serving path: no (B, S, 4H) copy, no mask tensor).

Each returns the final hidden state of every row, or with stacked heads
their predictions, in one launch. The source's header says what bounds
the kernel on an H100 and how the design follows from that; its plan
(one block or a 2-block cluster a row, by H) is asked by :func:`plan`.

For tensors on the CPU each wrapper computes the same function with its
plain PyTorch version (``kernels/ref.py``); for CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as REF

LIB = "lstm_scan"

_ENTRY = {torch.float32: "lstm_scan_f32", torch.bfloat16: "lstm_scan_bf16"}
_IDS_ENTRY = {torch.float32: "lstm_scan_ids_f32",
              torch.bfloat16: "lstm_scan_ids_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P)
_IDS_ARGS = (_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P)
# the library's own return code, formatted with (H, kMaxHidden)
_ERRORS = {-1: (ValueError, "lstm_scan: hidden size {} is above the "
                "kernel's limit kMaxHidden = {} (csrc/lstm_scan.cu)")}


@functools.lru_cache(maxsize=None)
def max_hidden() -> int:
    """The largest hidden size the kernel takes (``kMaxHidden`` in
    ``csrc/lstm_scan.cu``; it asks the built library)."""
    return _build.bind(_build.load(LIB), "lstm_scan_max_hidden", ())()


def plan(hidden: int) -> Dict[str, int]:
    """The kernel's plan for ``hidden``, from ``plan()`` in
    ``csrc/lstm_scan.cu`` (it asks the built library): ``ctas`` blocks a
    row (1, or a 2-block cluster), ``rows`` of k each lane keeps of ``wh``
    in registers (for four gate columns), ``units`` hidden units a block,
    ``threads`` a block.
    Raises ValueError for a size the kernel does not take."""
    fn = _build.bind(_build.load(LIB), "lstm_scan_plan",
                     (_I, ctypes.POINTER(ctypes.c_int)))
    out = (ctypes.c_int * 4)()
    if fn(hidden, out) != 0:
        raise ValueError(f"lstm_scan: hidden size {hidden} is outside the "
                         f"kernel's range [1, kMaxHidden = {max_hidden()}] "
                         f"(csrc/lstm_scan.cu)")
    return dict(zip(("ctas", "rows", "units", "threads"), out))


def _check_common(lead, wh, heads, gates_name: str) -> int:
    """Device and contiguity of every tensor, wh (H, 4H) in ``lead``'s
    float dtype, and the heads; returns H."""
    for t in (lead, wh, *heads):
        if t.device != lead.device:
            raise ValueError(f"all tensors must be on {lead.device}, got "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("all tensors must be contiguous")
    if wh.dim() != 2 or wh.shape[1] != 4 * wh.shape[0]:
        raise ValueError(f"wh must be (H, 4H), got {tuple(wh.shape)}")
    hidden = wh.shape[0]
    if lead.shape[-1] != 4 * hidden:
        raise ValueError(f"{gates_name} {tuple(lead.shape)} and wh "
                         f"{tuple(wh.shape)} need 4H == {gates_name}"
                         f".shape[-1] == wh.shape[1]")
    if {t.dtype for t in (lead, wh, *heads)} != {lead.dtype} or \
            lead.dtype not in _ENTRY:
        raise ValueError(
            f"{gates_name}, wh and the heads must all be float32 or all "
            f"bfloat16, got {[str(t.dtype) for t in (lead, wh, *heads)]}")
    if heads:
        head_w, head_b = heads
        if head_w.dim() != 2 or head_w.shape[0] != hidden or \
                head_w.shape[1] < 1 or \
                tuple(head_b.shape) != (head_w.shape[1],):
            raise ValueError(f"heads {tuple(head_w.shape)} + "
                             f"{tuple(head_b.shape)} do not follow "
                             f"hidden size {hidden}")
    return hidden


def _heads(head_w, head_b) -> tuple:
    if (head_w is None) != (head_b is None):
        raise ValueError("head_w and head_b come together")
    return () if head_w is None else (head_w, head_b)


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
    heads = _heads(head_w, head_b)
    if xw.dim() != 3:
        raise ValueError(f"xw must be (B, S, 4H), got {tuple(xw.shape)}")
    _check_common(xw, wh, heads, "xw")
    if mask.device != xw.device or not mask.is_contiguous():
        raise ValueError("mask must be contiguous and on xw's device")
    if tuple(mask.shape) != tuple(xw.shape[:2]):
        raise ValueError(f"mask must be (B, S) = {tuple(xw.shape[:2])}, "
                         f"got {tuple(mask.shape)}")
    if mask.dtype != torch.float32:
        raise ValueError(f"mask must be float32, got {mask.dtype}")
    if xw.device.type == "cpu":
        return REF.lstm_scan_ref(xw, mask, wh, *heads)
    if xw.device.type != "cuda":
        raise ValueError(f"no kernel for device {xw.device}")
    return _launch(xw, mask, wh, *heads)


def lstm_scan_ids(table: torch.Tensor, ids: torch.Tensor, wh: torch.Tensor,
                  head_w: Optional[torch.Tensor] = None,
                  head_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same recurrence with the gather inside the launch.

    table: (V, 4H) input projection of every token id (``emb @ wx + b``),
    float32 or bfloat16; ids: (B, S) int32. Step t of row b takes the
    gates ``table[ids[b, t]]`` and is valid where the id lies in [1, V):
    PAD (0) and an id outside the table carry (h, c) through, so the
    kernel never reads outside the table. Otherwise as
    :func:`lstm_scan_fused`, which on ``(table[ids], (ids != 0).float())``
    gives the same bits for in-range ids. Each launch of the kernel adds
    one to ``lstm_scan_ids.launches``."""
    heads = _heads(head_w, head_b)
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be (B, S), got {tuple(ids.shape)}")
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"table must be (V, 4H) with V >= 1, got "
                         f"{tuple(table.shape)}")
    if ids.device != table.device or not ids.is_contiguous():
        raise ValueError("ids must be contiguous and on the table's device")
    _check_common(table, wh, heads, "table")
    if table.device.type == "cpu":
        return REF.lstm_scan_ids_ref(table, ids, wh, *heads)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    return _launch_ids(table, ids, wh, *heads)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(xw, mask, wh, head_w=None, head_b=None) -> torch.Tensor:
    """Launch the kernel's xw entry on checked CUDA tensors (no checks
    here: call :func:`lstm_scan_fused`). Counts the launch."""
    return _run(lstm_scan_fused, _ENTRY, _ARGS, xw, xw.shape[:2],
                (xw.data_ptr(), mask.data_ptr()), wh, head_w, head_b)


def _launch_ids(table, ids, wh, head_w=None, head_b=None) -> torch.Tensor:
    """Launch the kernel's ids entry on checked CUDA tensors (no checks
    here: call :func:`lstm_scan_ids`). Counts the launch."""
    return _run(lstm_scan_ids, _IDS_ENTRY, _IDS_ARGS, table, ids.shape,
                (table.data_ptr(), ids.data_ptr(), int(table.shape[0])),
                wh, head_w, head_b)


def _run(counted, entries, arg_types, lead, shape, lead_args, wh, head_w,
         head_b) -> torch.Tensor:
    """One launch of the entry for ``lead``'s dtype, its own arguments
    ``lead_args`` first, on (B, S) = ``shape``; the final h, or the
    heads' predictions."""
    (B, S), hidden = shape, int(wh.shape[0])
    out = torch.empty((B, hidden), dtype=torch.float32, device=lead.device)
    n_heads = 0 if head_w is None else int(head_w.shape[1])
    pred = None if head_w is None else torch.empty(
        (B, n_heads), dtype=torch.float32, device=lead.device)
    # at B = 0 the entry checks H and launches nothing, so counts nothing
    _build.launch(
        counted if B else None, LIB,
        _build.bind(_build.load(LIB), entries[lead.dtype], arg_types),
        lead.device,
        (*lead_args, wh.data_ptr(), _ptr(head_w), _ptr(head_b), n_heads, B,
         S, hidden, out.data_ptr(), _ptr(pred)),
        _ERRORS, (hidden, max_hidden()))
    return out if pred is None else pred


lstm_scan_fused.launches = 0
lstm_scan_ids.launches = 0
