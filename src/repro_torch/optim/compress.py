"""int8 error-feedback gradient compression for the data-parallel axis.

For small models (like the cost model) the data-parallel all-reduce
dominates step time at scale. Gradients are quantized to int8 with a
per-tensor scale before the reduction, and the quantization error is
carried into the next step (error feedback preserves convergence;
Karimireddy et al. 2019).

Used as a gradient transform in the train step. ``torch.round`` rounds
half to even, as the reference's rounding does, so both give the same
codes. :func:`make_compressed_psum` is the explicit compressed all-reduce
over a process group.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.params import tree_flatten, tree_map, tree_unflatten


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, error_state):
    """Returns (compressed-then-decompressed grads, new error state).

    The int8 representation is what crosses the data-parallel axis; the
    residual is accumulated locally (error feedback)."""
    def one(g, e):
        g = g.to(torch.float32) + e
        q, scale = quantize(g)
        g_hat = dequantize(q, scale)
        return g_hat, g - g_hat

    outs = [one(g, e) for g, e in zip(tree_flatten(grads),
                                      tree_flatten(error_state))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def make_compressed_psum(group=None):
    """Explicit compressed all-reduce over ``group`` (the default group
    when None): each rank quantizes at its own scale, the int8 payloads
    are summed as int32, and the sum is multiplied by the largest of the
    ranks' scales, then divided by the group size.

    This is the reference's arithmetic, kept as it is: where the ranks'
    scales differ, a rank's codes are read at another rank's scale, so
    the result is not the mean of the dequantized gradients."""
    def compressed_psum(g: torch.Tensor) -> torch.Tensor:
        q, scale = quantize(g)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        scale_max = scale.clone()
        dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
        n = torch.tensor(float(dist.get_world_size(group)),
                         device=g.device)
        return total.to(torch.float32) * scale_max / n
    return compressed_psum
