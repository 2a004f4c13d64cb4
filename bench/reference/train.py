"""The plain training step of a cost model: the joint MSE over the heads
(the mean of each head's MSE on normalized targets), autograd over the
model kind's plain forward (conv1d's by default,
:func:`bench.reference.conv1d.forward`), then AdamW as the paper's
trainer configures it, written out term for term:

* the gradients clipped by their global norm over all leaves (1.0);
* ``count`` incremented before the learning rate is read; the rate
  warms up linearly over ``warmup_steps`` and then follows a cosine to
  ``min_lr_ratio`` of itself at ``total_steps``;
* ``m`` and ``v`` with b1 0.9 and b2 0.95, bias-corrected, ``eps``
  added after ``sqrt(v_hat)``;
* weight decay added to the step, inside the rate's multiply, for
  leaves of two or more dimensions only.

And the targets' normalization: log1p, then a z-score with the
population standard deviation plus 1e-8, in float32 as numpy computes it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench.reference import conv1d as RC


@dataclass(frozen=True)
class AdamW:
    lr: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    min_lr_ratio: float = 0.1


def normalize(targets: Dict[str, np.ndarray], heads: Sequence[str]
              ) -> np.ndarray:
    """(N, n_heads) float32 normalized targets, column i = heads[i]."""
    cols = []
    for t in heads:
        ly = np.log1p(targets[t])
        mu, sigma = float(ly.mean()), float(ly.std() + 1e-8)
        cols.append((ly - mu) / sigma)
    return np.stack(cols, axis=1).astype(np.float32)


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs, dict keys sorted at every level."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, x) for k in sorted(tree)
                for p, x in leaves(tree[k])]
    if isinstance(tree, list):
        return [(f"{i}/{p}" if p else str(i), x)
                for i, v in enumerate(tree) for p, x in leaves(v)]
    return [("", tree)]


def rebuild(like, flat: List[torch.Tensor]):
    """``like``'s structure with its leaves (in :func:`leaves` order)
    replaced by ``flat``."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)
    return build(like)


def loss_and_grads(params, ids: torch.Tensor, y: torch.Tensor,
                   precision: str = "ieee", forward=RC.forward):
    """(loss, grads in :func:`leaves` order) of the joint MSE."""
    flat = [x.detach().clone().requires_grad_(True)
            for _, x in leaves(params)]
    pred = forward(rebuild(params, flat), ids, precision)
    loss = torch.mean(torch.stack([torch.mean(torch.square(
        pred[:, i] - y[:, i])) for i in range(y.shape[1])]))
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), list(grads)


def lr_at(cfg: AdamW, step: int) -> float:
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    frac = min(max((step - cfg.warmup_steps) /
                   max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + math.cos(math.pi * frac))
    return cfg.lr * warm * decay


def adamw_step(params_flat, grads, m, v, step: int, cfg: AdamW,
               ndims: Sequence[int]):
    """One AdamW step on flat leaf lists; returns (params, m, v, clipped
    grads)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(norm, min=1e-9),
                        max=1.0)
    grads = [g * scale for g in grads]
    lr = lr_at(cfg, step)
    b1c, b2c = 1 - cfg.b1 ** step, 1 - cfg.b2 ** step
    new_p, new_m, new_v = [], [], []
    for p, g, mm, vv, nd in zip(params_flat, grads, m, v, ndims):
        mm = cfg.b1 * mm + (1 - cfg.b1) * g
        vv = cfg.b2 * vv + (1 - cfg.b2) * g * g
        s = (mm / b1c) / (torch.sqrt(vv / b2c) + cfg.eps)
        if cfg.weight_decay and nd >= 2:
            s = s + cfg.weight_decay * p
        new_p.append(p - lr * s)
        new_m.append(mm)
        new_v.append(vv)
    return new_p, new_m, new_v, grads


def run_steps(params, batches, cfg: AdamW, precision: str = "ieee",
              keep_rows: float = 1.0, forward=RC.forward):
    """The first ``len(batches)`` steps from ``params`` on ``batches``,
    each ``(ids, y)``. Returns the losses, the clipped first gradients
    (the optimizer's input at step 1) and the params after the last step,
    both in :func:`leaves` order. ``keep_rows`` < 1 plants a fault: each
    loss takes the mean over that share of the batch's rows only."""
    flat = [x.detach().clone() for _, x in leaves(params)]
    ndims = [x.ndim for x in flat]
    m = [torch.zeros_like(x) for x in flat]
    v = [torch.zeros_like(x) for x in flat]
    losses, first = [], None
    for step, (ids, y) in enumerate(batches, start=1):
        n = max(1, int(round(ids.shape[0] * keep_rows)))
        loss, grads = loss_and_grads(rebuild(params, flat), ids[:n], y[:n],
                                     precision, forward)
        flat, m, v, clipped = adamw_step(flat, grads, m, v, step, cfg,
                                         ndims)
        losses.append(float(loss))
        if first is None:
            first = clipped
    return losses, first, flat
