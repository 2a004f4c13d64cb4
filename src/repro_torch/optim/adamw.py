"""AdamW + schedules + global-norm clipping on tensor trees (no
``torch.optim`` here).

State layout mirrors the param tree: ``{"m": tree, "v": tree, "count":
int32}``. All moments are fp32 regardless of param dtype. The update is
the reference's, term for term: ``count`` is incremented before the
learning rate is read, the gradients are clipped by their global norm
over all leaves at once, ``eps`` is added after ``sqrt(v_hat)``, and
weight decay is added to the step, inside the learning-rate multiply,
for leaves with ``ndim >= 2`` only. ``torch.optim.AdamW`` differs on the
last three (it decays ``p *= 1 - lr * wd`` before the step, on every
leaf, and leaves clipping to the caller), so it is not used.

Leaves are paired in the reference's flatten order (sorted dict keys),
and the scalars (count, learning rate, bias corrections) stay tensors on
the params' device, so a step never waits for the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.params import tree_flatten, tree_map, tree_unflatten

# float32 bytes of the leaves updated together: bounds the update's
# temporaries (at 1.6 B parameters a whole-tree set is 6.4 GB)
GROUP_BYTES = 1 << 30


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"   # cosine | linear | constant
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine or linear decay to ``min_lr_ratio`` of
    ``lr`` at ``total_steps`` (or no decay). float32, on ``step``'s
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((step - cfg.warmup_steps) /
                           max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * \
                0.5 * (1 + torch.cos(math.pi * frac))
        else:
            decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    return cfg.lr * warm * decay


def init_state(params):
    """Zero fp32 moments shaped like ``params`` and a 0-d int32 count,
    on the params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree_flatten(params)[0]
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=first.device)}


def _norm(leaves) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(leaves)))


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf (as float32) taken together."""
    return _norm([x.float() for x in tree_flatten(tree)])


def _clip(leaves, max_norm: float):
    norm = _norm(leaves)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return torch._foreach_mul(leaves, scale), norm


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / global_norm)``; returns
    ``(clipped tree, norm)``."""
    flat, norm = _clip([g.float() for g in tree_flatten(grads)], max_norm)
    return tree_unflatten(grads, flat), norm


def _groups(leaves, limit: int):
    """Runs of consecutive leaf indices whose float32 bytes stay within
    ``limit`` together (a larger leaf alone)."""
    out, size = [[]], 0
    for i, x in enumerate(leaves):
        n = 4 * x.numel()
        if out[-1] and size + n > limit:
            out.append([])
            size = 0
        out[-1].append(i)
        size += n
    return out


def apply_updates(params, grads, state, cfg: AdamWConfig):
    """Returns ``(new_params, new_state, metrics)``; the inputs are not
    modified.

    The leaves are updated a group at a time, each group at most
    ``GROUP_BYTES`` of float32, so the update's temporaries (the clipped
    gradients, the bias-corrected moments, the step) hold one group's
    size, not the whole tree's; each leaf's arithmetic is the same, and a
    tree within one group takes the same launches."""
    count = state["count"] + 1
    flat_g = [g.float() for g in tree_flatten(grads)]
    gnorm = _norm(flat_g)
    scale = None if cfg.clip_norm is None else torch.clamp(
        cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule_lr(cfg, count)
    step = count.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, step)
    b2c = 1 - torch.pow(cfg.b2, step)

    flat_p = tree_flatten(params)
    old_m, old_v = tree_flatten(state["m"]), tree_flatten(state["v"])
    new_p, m, v = [], [], []
    for idx in _groups(flat_p, GROUP_BYTES):
        g = [flat_g[i] for i in idx]
        if scale is not None:
            g = torch._foreach_mul(g, scale)
        gm = torch._foreach_add(
            torch._foreach_mul([old_m[i] for i in idx], cfg.b1),
            torch._foreach_mul(g, 1 - cfg.b1))
        gv = torch._foreach_add(
            torch._foreach_mul([old_v[i] for i in idx], cfg.b2),
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - cfg.b2))
        del g
        mhat = torch._foreach_div(gm, b1c)
        vhat = torch._foreach_div(gv, b2c)
        steps = torch._foreach_div(
            mhat, torch._foreach_add(torch._foreach_sqrt(vhat), cfg.eps))
        del mhat, vhat
        for i, s in zip(idx, steps):
            p = flat_p[i]
            p32 = p.float()
            if cfg.weight_decay and p.ndim >= 2:   # decay matrices only
                s = s + cfg.weight_decay * p32
            new_p.append((p32 - lr * s).to(p.dtype))
        del steps
        m += gm
        v += gv
    new_state = {"m": tree_unflatten(state["m"], m),
                 "v": tree_unflatten(state["v"], v),
                 "count": count}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return tree_unflatten(params, new_p), new_state, metrics
