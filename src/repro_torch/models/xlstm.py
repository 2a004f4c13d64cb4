"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential scan with exponential gating).

* mLSTM trains with the stabilized *chunkwise* formulation — quadratic only
  within a chunk, O(d_head^2) carried state across chunks — so most of
  its work is matmuls instead of a length-S serial scan. Decode is the
  O(1) recurrent update.
* sLSTM is inherently sequential: a loop over time steps.

The stabilizers start at ``m = -1e30``, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init, rms_norm
from repro_torch.runtime import sharding as SH
from repro_torch.models.mamba import _causal_conv

MLSTM_CHUNK = 256


# ------------------------------------------------------------------- mLSTM
def mlstm_init(generator, cfg) -> Dict[str, Any]:
    d = cfg.d_model
    H, dh = cfg.n_heads, cfg.resolved_head_dim
    x = cfg.xlstm
    di = int(x.proj_factor_mlstm * d)
    return {
        "norm": torch.ones((d,)),
        "up_proj": _init(generator, (d, 2 * di)),
        "conv_w": _init(generator, (x.conv1d_kernel, di), scale=0.5),
        "conv_b": torch.zeros((di,)),
        "wq": _init(generator, (di, H, dh)),
        "wk": _init(generator, (di, H, dh)),
        "wv": _init(generator, (di, H, dh)),
        "w_if": _init(generator, (di, 2 * H), scale=0.02),
        "b_i": torch.zeros((H,)) - 3.0,
        "b_f": torch.zeros((H,)) + 3.0,
        "out_norm": torch.ones((H * dh,)),
        "down_proj": _init(generator, (H * dh, d)),
        "skip": torch.ones((di,)),
    }


def mlstm_axes(cfg):
    return {
        "norm": (None,), "up_proj": ("embed", "ffn"),
        "conv_w": (None, "ffn"), "conv_b": ("ffn",),
        "wq": ("ffn", "heads", None), "wk": ("ffn", "heads", None),
        "wv": ("ffn", "heads", None),
        "w_if": ("ffn", None), "b_i": (None,), "b_f": (None,),
        "out_norm": (None,), "down_proj": (None, "embed"), "skip": ("ffn",),
    }


def _mlstm_cell_chunkwise(q, k, v, li, lf):
    """Stabilized chunkwise mLSTM. q,k,v: (B,H,S,dh); li,lf: (B,H,S) log-gates.
    Returns h: (B,H,S,dh)."""
    B, H, S, dh = q.shape
    L = min(MLSTM_CHUNK, S)
    n_chunks = -(-S // L)
    pad = n_chunks * L - S
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        li = F.pad(li, (0, pad), value=-1e30)
        lf = F.pad(lf, (0, pad))
    q = q * (dh ** -0.5)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))

    C = torch.zeros((B, H, dh, dh), device=q.device)
    n = torch.zeros((B, H, dh), device=q.device)
    m = torch.full((B, H), -1e30, device=q.device)
    hs = []
    for c in range(n_chunks):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc, lic, lfc = q[:, :, sl], k[:, :, sl], v[:, :, sl], \
            li[..., sl], lf[..., sl]
        # (row by row on a mesh: cumsum's backward flips, and torch 2.11's
        # DTensor has no strategy for flip)
        b = SH.rowwise(_cumsum, lfc)                        # B,H,L inclusive
        # intra-chunk log weights: D[i,j] = b_i - b_j + li_j  (j<=i)
        logD = b[..., :, None] - b[..., None, :] + lic[..., None, :]
        logD = torch.where(tri, logD, -1e30)
        inter = b + m[..., None]                            # B,H,L
        m_i = torch.maximum(inter, logD.amax(dim=-1))       # B,H,L
        d_intra = torch.exp(logD - m_i[..., None])
        w_inter = torch.exp(inter - m_i)                    # B,H,L
        scores = torch.einsum("bhid,bhjd->bhij", qc, kc) * d_intra
        h_intra = torch.einsum("bhij,bhjd->bhid", scores, vc)
        h_inter = w_inter[..., None] * torch.einsum("bhid,bhde->bhie", qc, C)
        norm_intra = scores.sum(-1)
        norm_inter = w_inter * torch.einsum("bhid,bhd->bhi", qc, n)
        denom = torch.maximum(torch.abs(norm_intra + norm_inter),
                              torch.exp(-m_i))
        hs.append((h_intra + h_inter) / denom[..., None])
        # update carried state to end of chunk
        bL = b[..., -1]                                     # B,H
        a = bL[..., None] - b + lic                         # B,H,L
        m_new = torch.maximum(bL + m, a.amax(dim=-1))
        scale_old = torch.exp(bL + m - m_new)
        wa = torch.exp(a - m_new[..., None])                # B,H,L
        C = scale_old[..., None, None] * C + \
            torch.einsum("bhj,bhjd,bhje->bhde", wa, kc, vc)
        n = scale_old[..., None] * n + torch.einsum("bhj,bhjd->bhd", wa, kc)
        m = m_new
    return torch.cat(hs, dim=2)[:, :, :S]


def _mlstm_cell_step(state, q, k, v, li, lf):
    """O(1) decode update. q,k,v: (B,H,dh); li,lf: (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    dh = q.shape[-1]
    q = q * (dh ** -0.5)
    m_new = torch.maximum(lf + m, li)
    f_ = torch.exp(lf + m - m_new)
    i_ = torch.exp(li - m_new)
    C_new = f_[..., None, None] * C + \
        i_[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = f_[..., None] * n + i_[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)),
                        torch.exp(-m_new))
    h = num / den[..., None]
    return {"C": C_new, "n": n_new, "m": m_new}, h


def _cumsum(x):
    return torch.cumsum(x, dim=-1)


def mlstm_block_apply(p, x, cfg, *, rules=None, cdt=torch.bfloat16,
                      state: Optional[Dict] = None):
    """x: (B,S,D) -> (out, new_state). The sequence stays whole inside (a
    sequence-split DTensor is joined first): the cell runs along it."""
    x = SH.join_tokens(x)
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.resolved_head_dim
    xi = rms_norm(x, p["norm"], cfg.norm_eps).to(cdt)
    up = xi @ p["up_proj"].to(cdt)
    inner, z = torch.chunk(up, 2, dim=-1)
    if rules is not None:
        inner = rules.constrain(inner, "batch", None, "ffn")
    conv_state = state["conv"] if state is not None else None
    cx, new_conv = _causal_conv(inner, p["conv_w"].to(cdt),
                                p["conv_b"].to(cdt), conv_state)
    cx = F.silu(cx)
    q = torch.einsum("bsi,ihd->bshd", cx, p["wq"].to(cdt))
    k = torch.einsum("bsi,ihd->bshd", cx, p["wk"].to(cdt))
    v = torch.einsum("bsi,ihd->bshd", inner, p["wv"].to(cdt))
    gates = (cx @ p["w_if"].to(cdt)).float()
    gi, gf = torch.chunk(gates, 2, dim=-1)                   # B,S,H
    li = (gi + p["b_i"]).transpose(1, 2)                     # B,H,S
    # no DTensor strategy for log-sigmoid's backward: replicated
    lf = SH.replicated(F.logsigmoid, gf + p["b_f"]).transpose(1, 2)
    qT = q.transpose(1, 2).float()
    kT = k.transpose(1, 2).float()
    vT = v.transpose(1, 2).float()
    if state is None:
        h = _mlstm_cell_chunkwise(qT, kT, vT, li, lf)
        new_cell = None
    else:
        new_cell, h1 = _mlstm_cell_step(state["cell"], qT[:, :, 0],
                                        kT[:, :, 0], vT[:, :, 0],
                                        li[:, :, 0], lf[:, :, 0])
        h = h1[:, :, None, :]
    h = h.transpose(1, 2).reshape(B, S, H * dh).to(cdt)
    h = rms_norm(h, p["out_norm"], cfg.norm_eps)
    h = h + p["skip"].to(cdt)[:H * dh] * cx[..., :H * dh]
    out = (h * F.silu(z[..., :H * dh])) @ p["down_proj"].to(cdt)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "cell": new_cell}
    return x + out.to(x.dtype), new_state


def mlstm_init_state(cfg, batch):
    x = cfg.xlstm
    H, dh = cfg.n_heads, cfg.resolved_head_dim
    di = int(x.proj_factor_mlstm * cfg.d_model)
    return {
        "conv": torch.zeros((batch, x.conv1d_kernel - 1, di)),
        "cell": {"C": torch.zeros((batch, H, dh, dh)),
                 "n": torch.zeros((batch, H, dh)),
                 "m": torch.full((batch, H), -1e30)},
    }


# ------------------------------------------------------------------- sLSTM
def slstm_init(generator, cfg) -> Dict[str, Any]:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    x = cfg.xlstm
    df = int(x.proj_factor_slstm * d)
    return {
        "norm": torch.ones((d,)),
        "w_gates": _init(generator, (d, 4 * d)),          # i,f,z,o
        "r_gates": _init(generator, (H, dh, 4 * dh),   # block-diag recurrent
                         scale=1.0 / math.sqrt(dh)),
        "b_gates": torch.cat([torch.zeros((d,)) - 3.0,
                              torch.zeros((d,)) + 3.0,
                              torch.zeros((2 * d,))]),
        "gn": torch.ones((d,)),
        "ffn_up": _init(generator, (d, 2 * df)),
        "ffn_down": _init(generator, (df, d)),
    }


def slstm_axes(cfg):
    return {
        "norm": (None,), "w_gates": ("embed", "ffn"),
        "r_gates": (None, None, None), "b_gates": (None,),
        "gn": (None,),
        "ffn_up": ("embed", "ffn"), "ffn_down": ("ffn", "embed"),
    }


def _slstm_scan(wx, r, state):
    """wx: (B,S,4d) input contributions; r: (H,dh,4dh).
    state: dict(c,n,h,m) each (B,d). Sequential loop over S."""
    B, S, d4 = wx.shape
    d = d4 // 4
    H = r.shape[0]
    dh = d // H
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(S):
        hh = h.reshape(B, H, dh)
        rec = torch.einsum("bhd,hde->bhe", hh, r)          # (B, H, 4*dh)
        # reorder per-head (i,f,z,o) blocks into global (i,f,z,o) layout
        rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * d)
        gates = wx[:, t] + rec
        gi, gf, gz, go = torch.chunk(gates, 4, dim=-1)
        m_new = torch.maximum(gf + m, gi)
        i_ = torch.exp(gi - m_new)
        f_ = torch.exp(gf + m - m_new)
        z = torch.tanh(gz)
        o = torch.sigmoid(go)
        c = f_ * c + i_ * z
        n = f_ * n + i_
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"c": c, "n": n, "h": h, "m": m}


def slstm_block_apply(p, x, cfg, *, rules=None, cdt=torch.bfloat16,
                      state: Optional[Dict] = None):
    x = SH.join_tokens(x)      # the sequence stays whole, as in mLSTM
    B, S, D = x.shape
    xi = rms_norm(x, p["norm"], cfg.norm_eps)
    wx = (xi.to(cdt) @ p["w_gates"].to(cdt)).float()
    wx = wx + p["b_gates"]
    if state is None:
        with torch.device(x.device):
            st = slstm_init_state(cfg, B)
    else:
        st = state
    hs, new_state = _slstm_scan(wx, p["r_gates"], st)
    hs = rms_norm(hs.float(), p["gn"], cfg.norm_eps).to(cdt)
    up = hs @ p["ffn_up"].to(cdt)
    a, b = torch.chunk(up, 2, dim=-1)
    out = (F.gelu(a, approximate="tanh") * b) @ p["ffn_down"].to(cdt)
    return x + out.to(x.dtype), (new_state if state is not None else None)


def slstm_init_state(cfg, batch):
    d = cfg.d_model
    z = torch.zeros((batch, d))
    return {"c": z, "n": z + 1e-6, "h": z, "m": z - 1e30}


def count_params(cfg) -> int:
    """Analytic param count for the xLSTM LM (embedding tied): the block
    pair's shapes on the meta device (nothing allocated)."""
    n_pairs = max(cfg.n_layers // 2, 1)
    with torch.device("meta"):
        shapes = [*mlstm_init(None, cfg).values(),
                  *slstm_init(None, cfg).values()]
    per_pair = sum(t.numel() for t in shapes)
    emb = cfg.vocab * cfg.d_model
    return n_pairs * per_pair + emb + cfg.d_model
