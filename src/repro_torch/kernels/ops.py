"""Public wrappers for the kernels: drop-ins for ``core/models.py``.

* :func:`conv_forward_apply` — the full fusion for kind="conv1d": token
  ids in, per-target predictions out, one launch of the CUDA kernel
  (embedding gather, pad mask, conv tower, max-pool, FC stack and the
  stacked heads).
* :func:`lstm_forward_apply` — kind="lstm": one launch of the LSTM
  kernel's ids entry, which reads each step's input projection from the
  table ``emb @ wx + b`` (:func:`lstm_xw_table`) by id and runs the
  recurrence and the stacked heads.
* :func:`conv_tower_apply` — the "half-fused" rung of kind="conv1d": the
  gather in PyTorch, the conv tower and a masked max-pool in one launch
  of the tower kernel, the FC stack and heads in PyTorch.
* :func:`forward_apply` — dispatch by model kind (see KERNEL_KINDS).

Params may be float32 or bfloat16; arithmetic is float32 in the kernels
either way. On the CPU the wrappers compute the same function with the
kernels' plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.models import fc_finish, model_heads
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d_stack as K_CONV
from repro_torch.kernels import lstm_scan as K_LSTM
from repro_torch.kernels import ref as REF
from repro_torch.kernels.conv1d_stack import (conv1d_stack_fused,
                                              conv_forward_fused)
from repro_torch.kernels.lstm_scan import lstm_scan_fused, lstm_scan_ids
from repro_torch.params import tree_leaves

# Model kinds with a fused serving forward (see forward_apply), and the
# kernel library each one's forward launches.
KERNEL_KINDS = ("conv1d", "lstm")
_KERNEL_LIB = {"conv1d": K_CONV.LIB, "lstm": K_LSTM.LIB}

# The reference's names for the two kernels that ops composes.
conv1d_stack = conv1d_stack_fused
lstm_scan = lstm_scan_fused


def build(kind: str) -> None:
    """Compile (or load) the library of ``kind``'s fused forward now
    rather than at its first launch."""
    _build.load(_KERNEL_LIB[kind])


def _stacked_heads(params):
    """(head_w, head_b, names) with per-target columns stacked so every
    head is one matmul, in ``params["heads"]`` order: callers map the
    columns back by the names returned here, never by position.
    Single-head layout: the head is the LSTM's ``head``, or the conv
    model's ``fc[-1]``."""
    names = model_heads(params)
    if names is None:
        head = params["head"] if "head" in params else params["fc"][-1]
        return head["w"], head["b"], None
    hs = [params["heads"][t] for t in names]
    return (torch.cat([h["w"] for h in hs], dim=1),
            torch.cat([h["b"] for h in hs], dim=0), names)


def fused_args(params):
    """:func:`conv_forward_fused`'s arguments after the ids, from a param
    tree, and the head names of the output columns (None: single-head).
    ``params["stacked_heads"]`` is used when the caller precomputed it
    (:func:`serving_params`, as the service does)."""
    head_w, head_b, names = params.get("stacked_heads") or \
        _stacked_heads(params)
    hidden_fc = params["fc"] if names is not None else params["fc"][:-1]
    return (params["emb"],
            [lyr["w"] for lyr in params["convs"]],
            [lyr["b"] for lyr in params["convs"]],
            [lyr["w"] for lyr in hidden_fc],
            [lyr["b"] for lyr in hidden_fc],
            head_w, head_b), names


def conv_forward_apply(params, ids: torch.Tensor, *,
                       check_ids: bool = True):
    """Full fused serving forward for kind="conv1d": ids -> predictions.

    Output matches ``conv_apply``: a ``{target: (B,)}`` dict for the
    multi-head layout, a ``(B,)`` tensor for single-head, but always
    float32 (the kernel accumulates f32 even for bf16 params).
    ``check_ids`` as in :func:`conv_forward_fused`."""
    args, names = fused_args(params)
    out = conv_forward_fused(ids, *args, check_ids=check_ids)
    if names is None:
        return out[:, 0]
    return {t: out[:, i] for i, t in enumerate(names)}


def lstm_xw_table(params) -> torch.Tensor:
    """The LSTM's input projection of every token id, ``emb @ wx + b``:
    (V, 4H) in the params' dtype. Row 0 is PAD's projection, which the
    kernel never reads (a PAD step is masked), as in ``lstm_encode``."""
    return params["emb"] @ params["wx"] + params["b"]


def lstm_serving_params(params):
    """``params`` with what every served LSTM batch reads computed once:
    the projection table (``xw_table``) and the stacked heads
    (``stacked_heads``), so a batch is one kernel launch."""
    return dict(params, xw_table=lstm_xw_table(params),
                stacked_heads=_stacked_heads(params))


def serving_params(kind: str, params):
    """``params`` with what every served batch of ``kind``'s fused forward
    reads computed once, so no batch recomputes it: the stacked heads
    (conv1d), and the projection table too (lstm,
    :func:`lstm_serving_params`)."""
    if kind == "lstm":
        return lstm_serving_params(params)
    return dict(params, stacked_heads=_stacked_heads(params))


def lstm_forward_apply(params, ids: torch.Tensor, *,
                       check_ids: bool = True):
    """Fused serving forward for kind="lstm": int32 ids -> predictions.

    The input projection of each position depends only on its id, so the
    kernel reads it from the table :func:`lstm_xw_table` by id, inside
    its launch (:func:`lstm_scan_ids`): no (B, S, 4H) copy and no mask
    tensor. ``params["xw_table"]`` and ``params["stacked_heads"]`` are
    used when the caller precomputed them (:func:`lstm_serving_params`,
    as the service does), else computed here. A table row has the same
    bits in any batch, which a matmul over the batch's B*S rows does not
    give: cuBLAS picks its algorithm by the shape. The recurrence and
    the stacked heads are one launch. Output matches ``lstm_apply``,
    always float32. ``check_ids`` checks the id range first; on a CUDA
    tensor that waits for the card, and the service, which checks on the
    host, passes False (the kernel reads an id outside the table as
    PAD)."""
    if check_ids:
        K_CONV.check_id_range(ids, params["emb"].shape[0])
    table = params.get("xw_table")
    if table is None:
        table = lstm_xw_table(params)
    head_w, head_b, names = params.get("stacked_heads") or \
        _stacked_heads(params)
    out = lstm_scan_ids(table, ids, params["wh"], head_w, head_b)
    if names is None:
        return out[:, 0]
    return {t: out[:, i] for i, t in enumerate(names)}


def conv_tower_apply(params, ids: torch.Tensor, *, use_kernel: bool = True):
    """Drop-in for ``conv_apply`` through the tower kernel, with the
    gather outside it. Its pool is masked (pads never enter the max),
    which ``conv_apply``'s is not: the two agree only where no pad
    position wins the max, as with zero biases. ``use_kernel=False`` runs
    the tower's plain version instead."""
    mask = (ids != 0).to(torch.float32)
    x = params["emb"][ids] * mask[..., None].to(params["emb"].dtype)
    weights = [lyr["w"] for lyr in params["convs"]]
    biases = [lyr["b"] for lyr in params["convs"]]
    if use_kernel:
        h = conv1d_stack_fused(x, weights, biases, mask)
    else:
        h = REF.conv1d_stack_ref(x, weights, biases, mask)
    return fc_finish(params, h)


def forward_apply(kind: str, params, ids: torch.Tensor, *,
                  check_ids: bool = True):
    """Dispatch to the fused forward for ``kind``.

    Raises ValueError for kinds without a kernel (see KERNEL_KINDS)."""
    if kind == "conv1d":
        return conv_forward_apply(params, ids, check_ids=check_ids)
    if kind == "lstm":
        return lstm_forward_apply(params, ids, check_ids=check_ids)
    raise ValueError(
        f"use_kernel supports kinds {KERNEL_KINDS}, not {kind!r}")


def fused_forward_bytes(params, batch: int, seq: int) -> int:
    """Modeled device-memory traffic of one fused conv forward: ids +
    one read of every param + the predictions."""
    names = model_heads(params)
    n_heads = len(names) if names else 1
    p_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    return batch * seq * 4 + p_bytes + batch * n_heads * 4
