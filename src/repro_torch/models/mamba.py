"""Selective SSM (Mamba) block for the Jamba hybrid architecture.

Training/prefill uses a chunked scan: a loop over sequence chunks with a
log-depth (Hillis-Steele) inclusive scan inside each chunk, so the
(B, S, d_inner, d_state) tensor never exists at full sequence length.
The scan composes the pairs ``(a, b)`` of ``s' = a * s + b`` by
products and sums only: the cumulative product of ``exp(dt * A)``
divided out would underflow to 0 and give inf or NaN. Its combine order
is not the reference's, so the two agree to float32 rounding. Decode is
the O(1) recurrent update.

On a CUDA card, with plain tensors, training and prefill run the scan
as one hand-written kernel instead
(:func:`repro_torch.kernels.selective_scan.selective_scan`, forward and
backward); the chunked scan here stays for the CPU and DTensors, and is
the kernel's oracle. With ``cfg.hybrid.inner_norms`` the mixer
normalises dt, B and C after ``x_proj`` (Jamba's ``dt_layernorm``,
``b_layernorm``, ``c_layernorm``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import selective_scan as SS
from repro_torch.models.layers import _init, rms_norm
from repro_torch.runtime import sharding as SH

MAMBA_CHUNK = 256


def mamba_init(generator, cfg) -> Dict[str, Any]:
    h = cfg.hybrid
    d = cfg.d_model
    di = h.expand * d
    dt_rank = max(d // 16, 1)
    lo, hi = math.log(1e-3), math.log(1e-1)
    p = {
        "in_proj": _init(generator, (d, 2 * di)),
        "conv_w": _init(generator, (h.d_conv, di), scale=0.5),
        "conv_b": torch.zeros((di,)),
        "x_proj": _init(generator, (di, dt_rank + 2 * h.d_state)),
        "dt_proj": _init(generator, (dt_rank, di), scale=dt_rank ** -0.5),
        "dt_bias": torch.log(torch.expm1(torch.exp(
            torch.rand((di,), generator=generator) * (hi - lo) + lo))),
        "A_log": torch.log(torch.arange(
            1, h.d_state + 1, dtype=torch.float32).repeat(di, 1)),
        "D": torch.ones((di,)),
        "out_proj": _init(generator, (di, d)),
    }
    if h.inner_norms:
        p.update(dt_norm=torch.ones((dt_rank,)),
                 b_norm=torch.ones((h.d_state,)),
                 c_norm=torch.ones((h.d_state,)))
    return p


def mamba_axes(cfg):
    a = {
        "in_proj": ("embed", "ffn"),
        "conv_w": (None, "ffn"),
        "conv_b": ("ffn",),
        "x_proj": ("ffn", None),
        "dt_proj": (None, "ffn"),
        "dt_bias": ("ffn",),
        "A_log": ("ffn", None),
        "D": ("ffn",),
        "out_proj": ("ffn", "embed"),
    }
    if cfg.hybrid.inner_norms:
        a.update(dt_norm=(None,), b_norm=(None,), c_norm=(None,))
    return a


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, di); w: (k, di).
    state: (B, k-1, di)."""
    k = w.shape[0]
    if state is None:
        # zeros joined on, not padded: padding a DTensor fails in torch 2.11
        state = torch.zeros_like(x[:, :1]).expand(x.shape[0], k - 1,
                                                  x.shape[2])
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return out + b, new_state


def _ssm_params(p, x, cfg, cdt):
    """x: (B, S, di) -> dt (B,S,di), B_ (B,S,N), C (B,S,N), A (di,N)."""
    h = cfg.hybrid
    dt_rank = p["dt_proj"].shape[0]
    # both products' partial sums reduced at once: torch 2.11's DTensor
    # cannot add a split bias to a pending sum
    proj = SH.settle(x @ p["x_proj"].to(cdt))
    dt_in, Bm, Cm = torch.split(proj, [dt_rank, h.d_state, h.d_state],
                                dim=-1)
    if h.inner_norms:
        dt_in = rms_norm(dt_in, p["dt_norm"], cfg.norm_eps)
        Bm = rms_norm(Bm, p["b_norm"], cfg.norm_eps)
        Cm = rms_norm(Cm, p["c_norm"], cfg.norm_eps)
    dt = F.softplus(SH.settle(dt_in @ p["dt_proj"].to(cdt)).float()
                    + p["dt_bias"])
    A = -torch.exp(p["A_log"])  # (di, N)
    return dt, Bm.float(), Cm.float(), A


def _kernel_scan(*ts) -> bool:
    """The scan kernel runs on plain (not DTensor) CUDA tensors."""
    return all(not isinstance(t, SH.DTensor) and t.is_cuda for t in ts)


def _scan(a, b):
    """Inclusive scan of s_t = a_t * s_{t-1} + b_t from s = 0 along dim 1:
    returns (prod a_1..t, s_t) in log2(c) steps."""
    c = a.shape[1]
    step = 1
    while step < c:
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        b = torch.cat([b[:, :step], a[:, step:] * b_prev + b[:, step:]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a_prev], dim=1)
        step *= 2
    return a, b


def mamba_apply(p, x, cfg, *, rules=None, cdt=torch.bfloat16,
                state: Optional[Dict] = None):
    """x: (B, S, D). state (decode): {"conv": (B,k-1,di), "ssm": (B,di,N)}.

    Returns (out, new_state). The sequence stays whole inside (a
    sequence-split DTensor is joined first): the scan runs along it."""
    x = SH.join_tokens(x)
    if rules is not None:
        # every param but the two projections whole on each rank, as
        # GSPMD gathers them for the activations' split: DTensor would
        # instead split the scan's (B, c, di, N) tensors on di to meet
        # the params' split, gathering their batch whole in the backward
        p = {k: v if k in ("in_proj", "out_proj") else
             rules.constrain(v, *(None,) * v.ndim) for k, v in p.items()}
    xc = x.to(cdt)
    xz = xc @ p["in_proj"].to(cdt)
    xin, z = torch.chunk(xz, 2, dim=-1)
    if rules is not None:
        xin = rules.constrain(xin, "batch", None, "ffn")
        z = rules.constrain(z, "batch", None, "ffn")

    if state is not None:
        xin, conv_state = _causal_conv(xin, p["conv_w"].to(cdt),
                                       p["conv_b"].to(cdt), state["conv"])
        xin = F.silu(xin)
        dt, Bm, Cm, A = _ssm_params(p, xin, cfg, cdt)
        # recurrent update: s' = exp(dt*A)*s + dt*B*x
        dA = torch.exp(dt[:, 0, :, None] * A[None])            # B,di,N
        dBx = dt[:, 0, :, None] * Bm[:, 0, None, :] * \
            xin[:, 0, :, None].float()
        s = state["ssm"] * dA + dBx
        y = (s * Cm[:, 0, None, :]).sum(-1)                    # B,di
        y = y + p["D"] * xin[:, 0].float()
        y = (y.to(cdt) * F.silu(z[:, 0]))[:, None]             # B,1,di
        out = y @ p["out_proj"].to(cdt)
        return out, {"conv": conv_state, "ssm": s}

    # train/prefill: chunked scan
    xin, _ = _causal_conv(xin, p["conv_w"].to(cdt), p["conv_b"].to(cdt))
    xin = F.silu(xin)
    dt, Bm, Cm, A = _ssm_params(p, xin, cfg, cdt)
    y = selective_scan(xin.float(), dt, A, Bm, Cm, p["D"])
    y = y.to(cdt) * F.silu(z)
    if rules is not None:
        y = rules.constrain(y, "batch", None, "ffn")
    out = y @ p["out_proj"].to(cdt)
    return out, None


def selective_scan(x, dt, A, Bm, Cm, D):
    """``chunked_scan(...) + D * x``, float32: on plain CUDA tensors as
    the hand-written kernel, else (the CPU, DTensors) as the chunked
    scan."""
    if _kernel_scan(x, dt, A, Bm, Cm, D):
        return SS.selective_scan(x, dt, A, Bm, Cm, D)
    return chunked_scan(x, dt, A, Bm, Cm) + D * x


def chunked_scan(x, dt, A, Bm, Cm, chunk: int = MAMBA_CHUNK):
    """y_t = sum_n C_tn s_tn for s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t
    from s = 0, all float32: x, dt (B, S, di), A (di, N), Bm, Cm (B, S,
    N) -> (B, S, di). A loop over sequence chunks with a log-depth scan
    inside each, so no (B, S, di, N) tensor is built."""
    S = x.shape[1]
    chunk = min(chunk, S)
    s0 = None           # the state before the first chunk is zero
    ys = []
    for start in range(0, S, chunk):
        sl = slice(start, start + chunk)
        xc_, dt_, B_, C_ = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = torch.exp(dt_[..., None] * A)                     # B,c,di,N
        dBx = dt_[..., None] * B_[:, :, None, :] * xc_[..., None]
        aA, aB = _scan(dA, dBx)
        s = aB if s0 is None else aA * s0[:, None] + aB        # B,c,di,N
        ys.append((s * C_[:, :, None, :]).sum(-1))             # B,c,di
        s0 = s[:, -1]
    return torch.cat(ys, dim=1)


def mamba_init_state(cfg, batch, dtype=torch.float32):
    h = cfg.hybrid
    di = h.expand * cfg.d_model
    return {"conv": torch.zeros((batch, h.d_conv - 1, di), dtype=dtype),
            "ssm": torch.zeros((batch, di, h.d_state))}
