"""Public wrappers for the kernels: drop-ins for ``core/models.py``.

* :func:`conv_forward_apply` — the full fusion for kind="conv1d": token
  ids in, per-target predictions out, one launch of the CUDA kernel
  (embedding gather, pad mask, conv tower, max-pool, FC stack and the
  stacked heads).
* :func:`forward_apply` — dispatch by model kind (see KERNEL_KINDS).

Params may be float32 or bfloat16; arithmetic is float32 in the kernel
either way. On the CPU the wrappers compute the same function with the
kernels' plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.models import model_heads
from repro_torch.kernels.conv1d_stack import conv_forward_fused
from repro_torch.params import tree_leaves

# Model kinds with a fused serving forward (see forward_apply).
KERNEL_KINDS = ("conv1d", "lstm")


def _stacked_heads(params):
    """(head_w, head_b, names) with per-target columns stacked so every
    head is one matmul, in ``params["heads"]`` order: callers map the
    columns back by the names returned here, never by position.
    Single-head layout: the head is ``fc[-1]``."""
    names = model_heads(params)
    if names is None:
        head = params["fc"][-1]
        return head["w"], head["b"], None
    hs = [params["heads"][t] for t in names]
    return (torch.cat([h["w"] for h in hs], dim=1),
            torch.cat([h["b"] for h in hs], dim=0), names)


def fused_args(params):
    """:func:`conv_forward_fused`'s arguments after the ids, from a param
    tree, and the head names of the output columns (None: single-head)."""
    head_w, head_b, names = _stacked_heads(params)
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


def forward_apply(kind: str, params, ids: torch.Tensor, *,
                  check_ids: bool = True):
    """Dispatch to the fused forward for ``kind``.

    Raises ValueError for kinds without a kernel (see KERNEL_KINDS) and
    NotImplementedError for the LSTM, whose recurrence kernel is not
    ported yet."""
    if kind == "conv1d":
        return conv_forward_apply(params, ids, check_ids=check_ids)
    if kind == "lstm":
        raise NotImplementedError(
            "the fused LSTM forward (lstm_scan_fused) is not ported yet")
    raise ValueError(
        f"use_kernel supports kinds {KERNEL_KINDS}, not {kind!r}")


def fused_forward_bytes(params, batch: int, seq: int) -> int:
    """Modeled device-memory traffic of one fused conv forward: ids +
    one read of every param + the predictions."""
    names = model_heads(params)
    n_heads = len(names) if names else 1
    p_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    return batch * seq * 4 + p_bytes + batch * n_heads * 4
