"""Token-choice top-k MoE with chunked capacity-based dispatch.

Dispatch/combine are dense one-hot einsums (no data-dependent shapes),
applied per sequence chunk so the (tokens, experts, capacity) dispatch
tensor stays small even at 32k sequence length. With ``rules`` the
experts are sharded over the ``model`` mesh axis (expert parallelism).

Routing is the reference's: top-k breaks ties toward the lower expert
index, a (token, k) pair's slot in its expert is its rank in the chunk's
token-major order, and pairs past the capacity are dropped, so which
tokens drop depends on the chunk size (only a dropless capacity factor
makes the output chunk-invariant).

Active-FLOPs accounting: per token, top_k experts * capacity_factor slack,
matching the 6*N_active*D convention used in the roofline.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init
from repro_torch.runtime import sharding as SH

MOE_CHUNK = 1024  # sequence chunk for dispatch (memory knob)


def moe_init(generator, cfg) -> Dict[str, Any]:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    return {
        "router": _init(generator, (d, e), scale=0.02),
        "w_gate": _init(generator, (e, d, f)),
        "w_up": _init(generator, (e, d, f)),
        "w_down": _init(generator, (e, f, d), scale=1.0 / math.sqrt(f)),
    }


def moe_axes(cfg):
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "ffn"),
        "w_up": ("experts", "embed", "ffn"),
        "w_down": ("experts", "ffn", "embed"),
    }


def _capacity(chunk_tokens: int, cfg) -> int:
    m = cfg.moe
    cap = int(math.ceil(
        chunk_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(cap, m.top_k)


def moe_route(p, h, cfg, cap: int):
    """Routing of one chunk h: (B, c, D) in the compute dtype. Returns
    (probs (B,c,E), top-k weights (B,c,K) renormalized, the one-hot
    experts (B,c,K,E), keep (B,c,K): the pair got a slot, its slot
    one-hot (B,c,K,cap))."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    B, c, _ = h.shape
    logits = (h @ p["router"].to(h.dtype)).float()                # B,c,E
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts equal probabilities in index order
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :K], topi[..., :K]                     # B,c,K
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # slot position of each (token, k) within its expert, via cumsum
    onehot = F.one_hot(topi, E).float()                          # B,c,K,E
    flat = onehot.reshape(B, c * K, E)
    pos = torch.cumsum(flat, dim=1) - flat                        # B,cK,E
    pos = pos.reshape(B, c, K, E)
    slot = (pos * onehot).sum(-1)                                 # B,c,K
    keep = slot < cap
    slot_oh = F.one_hot(torch.where(keep, slot, float(cap)).long(),
                        cap + 1).float()[..., :cap]             # B,c,K,cap
    return probs, topv, onehot, keep, slot_oh


def moe_apply(p, x, cfg, *, rules=None, cdt=torch.bfloat16):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar). The sequence
    stays whole inside (a sequence-split DTensor is joined first): the
    dispatch einsums pair tokens across it, as in the FFN."""
    x = SH.join_tokens(x)
    B, S, D = x.shape
    K = cfg.moe.top_k
    E = cfg.moe.n_experts
    chunk = min(MOE_CHUNK, S)
    cap = _capacity(chunk, cfg)
    outs, auxs = [], []
    for start in range(0, S, chunk):
        xch = x[:, start:start + chunk]
        if xch.shape[1] < chunk:     # the reference pads the last chunk
            xch = F.pad(xch, (0, 0, 0, chunk - xch.shape[1]))
        h = xch.to(cdt)
        probs, topv, onehot, keep, slot_oh = moe_route(p, h, cfg, cap)
        disp = torch.einsum("bcke,bckp->bcep", onehot, slot_oh)  # B,c,E,cap
        comb = torch.einsum("bcke,bckp,bck->bcep", onehot, slot_oh, topv)
        # dispatch tokens to expert slots
        xin = torch.einsum("bcep,bcd->ebpd", disp.to(cdt), h)   # E,B,cap,D
        if rules is not None:
            xin = rules.constrain(xin, "experts", "batch", None, None)
        gate = F.silu(torch.einsum("ebpd,edf->ebpf", xin,
                                   p["w_gate"].to(cdt)))
        up = torch.einsum("ebpd,edf->ebpf", xin, p["w_up"].to(cdt))
        eout = torch.einsum("ebpf,efd->ebpd", gate * up,
                            p["w_down"].to(cdt))
        if rules is not None:
            eout = rules.constrain(eout, "experts", "batch", None, None)
        outs.append(torch.einsum("bcep,ebpd->bcd", comb.to(cdt), eout))
        # load-balance aux (Switch-style): mean prob * mean assigned fraction
        me = probs.mean(dim=(0, 1))                                   # E
        ce = onehot.mean(dim=(0, 1, 2)) * K                           # E
        auxs.append((me * ce).sum() * E)
    out = torch.cat(outs, dim=1)[:, :S]
    return out, torch.stack(auxs).mean() * cfg.moe.router_aux_weight
