"""Core transformer layers in PyTorch, with the reference's logical
sharding axes.

Conventions
-----------
* Params are nested dicts of tensors; every init function has a matching
  ``*_axes`` function returning the same tree of logical-axis tuples
  (read by :mod:`repro_torch.runtime.sharding`). With ``rules``, the
  params and inputs are DTensors placed by those axes, and every apply
  redistributes its activations where the reference constrains them
  (``rules.constrain``); ops with no usable DTensor sharding strategy
  run on each rank's local tensors (``sharding.replicated``,
  ``sharding.rowwise``).
* Params are stored fp32 (master weights); forward casts to ``cdt``
  (compute dtype, bf16 by default) — mixed-precision training.
* Inits draw from an explicit ``torch.Generator`` and create tensors on
  the default device: ``with torch.device("cuda"):`` and a generator on
  the card init there, ``with torch.device("meta"):`` and
  ``generator=None`` give shapes without allocating. The shapes and
  scales are the reference's; its random bits cannot be reproduced, so
  parity goes through numpy params (``params.lm_from_numpy``).
* Attention is flash-style (a loop over key blocks, online softmax), so
  no (Sq, Sk) buffer larger than (Sq, kblk) is built. Its two products
  take ``cdt`` operands and accumulate and return float32 (the
  reference asks for a float32 result of its bf16 products): the
  operands are widened to float32 first, whose products of bf16 values
  are exact.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.runtime import sharding as SH

Params = Dict[str, Any]

DEFAULT_KBLK = 1024   # flash-attention key-block size


# ----------------------------------------------------------------- utilities
def _init(generator, shape, scale=None):
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=generator) * scale


def rms_norm(x, gamma, eps):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


def rope(x, positions, theta):
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., :, None] * freqs
    # angles: (..., S, half) -> broadcast over heads
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def attention_init(generator, cfg) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _init(generator, (d, nq, hd)),
        "wk": _init(generator, (d, nkv, hd)),
        "wv": _init(generator, (d, nkv, hd)),
        "wo": _init(generator, (nq, hd, d), scale=1.0 / math.sqrt(nq * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nq, hd))
        p["bk"] = torch.zeros((nkv, hd))
        p["bv"] = torch.zeros((nkv, hd))
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,))
        p["k_norm"] = torch.ones((hd,))
    return p


def attention_axes(cfg):
    a = {
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv_heads", None),
        "wv": ("embed", "kv_heads", None),
        "wo": ("heads", None, "embed"),
    }
    if cfg.qkv_bias:
        a.update(bq=("heads", None), bk=("kv_heads", None),
                 bv=("kv_heads", None))
    if cfg.qk_norm:
        a.update(q_norm=(None,), k_norm=(None,))
    return a


def flash_attention(q, k, v, *, causal: bool, q_offset=0,
                    kblk: int = DEFAULT_KBLK, rules=None):
    """Online-softmax attention, looping over key blocks.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D) (kv already repeated to H heads).
    q_offset: global position of q[0] (for causal masking of prefill chunks).
    Never builds an (Sq, Sk) buffer larger than (Sq, kblk). The last block
    holds the Sk % kblk keys left over (the reference pads it with keys
    that its mask then drops: the same sums).

    With DTensors, each rank attends with its own part of q (its batch,
    heads and query positions; ``sharding.local_attention``): that is
    the split the reference's logits constraint asks for, and the
    per-block products then run on local tensors.
    """
    if isinstance(q, SH.DTensor):
        return SH.local_attention(functools.partial(
            flash_attention, causal=causal, kblk=kblk), q, k, v, q_offset)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kblk = min(kblk, Sk)
    scale = 1.0 / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    q32 = q.float()
    m = torch.full((B, H, Sq), -math.inf, device=q.device)
    lse = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, Sq, H, D), device=q.device)
    for start in range(0, Sk, kblk):
        kc, vc = k[:, start:start + kblk], v[:, start:start + kblk]
        # (the reference's logits constraint: local_attention gives q's
        # split, above)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, kc.float()) * scale
        if causal:
            k_pos = start + torch.arange(kc.shape[1], device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            logits = torch.where(mask[None, None], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        lse = lse * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vc.dtype).float(),
                          vc.float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(lse, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _pad_heads(t, n):
    """(B, S, H, D) -> (B, S, H + n, D), the new heads zero."""
    if n == 0:
        return t
    return torch.cat([t, torch.zeros_like(t[:, :, :1]).expand(
        *t.shape[:2], n, t.shape[3])], dim=2)


def _proj(x, w):
    """(B, S, d) x (d, H, K) -> (B, S, H, K)."""
    return SH.by_token(_bsd_dhk, x, w)


def _bsd_dhk(x, w):
    return torch.einsum("bsd,dhk->bshk", x, w)


def out_proj(o, w):
    """(B, S, H, K) x (H, K, d) -> (B, S, d)."""
    return SH.by_token(_bshk_hkd, o, w)


def _bshk_hkd(o, w):
    return torch.einsum("bshk,hkd->bsd", o, w)


def attention_apply(p, x, cfg, *, positions, rules=None,
                    cdt=torch.bfloat16, cache: Optional[Dict] = None,
                    cache_index=None):
    """GQA attention. If cache is given, single-token decode; else full seq.

    cache: {"k": (B, n_kv, S_cache, D), "v": same}, sharded on
    cache_seq. Decode writes this step's k and v into the cache in place
    at ``cache_index`` (an int) and returns the same tensors. Returns
    (out, new_cache).
    """
    B, S, d = x.shape
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = nq // nkv
    xc = x.to(cdt)
    q = _proj(xc, p["wq"].to(cdt))
    k = _proj(xc, p["wk"].to(cdt))
    v = _proj(xc, p["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        # train/prefill: repeat kv to full q heads, flash attention.
        # Head (tensor) parallelism when n_heads divides the model axis;
        # with rules.pad_attention_heads, odd head counts are zero-padded
        # up to the next multiple of the model axis (padded heads are
        # sliced away before the output projection: the same sums);
        # otherwise query-sequence context parallelism picks up that axis.
        kf = torch.repeat_interleave(k, G, dim=2)
        vf = torch.repeat_interleave(v, G, dim=2)
        n_eff = nq
        if rules is not None:
            heads_tp = rules.divisible(nq, "model")
            if not heads_tp and rules.pad_attention_heads:
                m_sz = rules.axis_sizes.get("model", 1)
                n_eff = -(-nq // m_sz) * m_sz
                q, kf, vf = (_pad_heads(t, n_eff - nq) for t in (q, kf, vf))
                heads_tp = True
            qs = None if heads_tp else "qseq"
            q = rules.constrain(q, "batch", qs, "heads", None)
            kf = rules.constrain(kf, "batch", None, "heads", None)
            vf = rules.constrain(vf, "batch", None, "heads", None)
        out = flash_attention(q, kf, vf, causal=True, rules=rules)
        if n_eff != nq:
            out = out[:, :, :nq]
        new_cache = None
    else:
        # decode: write this step into the cache, grouped attention
        kc, vc = cache["k"], cache["v"]  # (B, nkv, Sc, D)
        SH.write_slice(kc, k.transpose(1, 2).to(kc.dtype), 2, cache_index)
        SH.write_slice(vc, v.transpose(1, 2).to(vc.dtype), 2, cache_index)
        if rules is not None:
            kc = rules.constrain(kc, "batch", "kv_heads", "cache_seq", None)
            vc = rules.constrain(vc, "batch", "kv_heads", "cache_seq", None)
        Sc = kc.shape[2]
        if rules is not None:
            # q's heads split as the kv heads do, so the (nkv, G) view
            # below splits evenly (DTensor reshards no view implicitly)
            kvs = "kv_heads" if rules.spec(("kv_heads",), (nkv,))[0] \
                else None
            q = rules.constrain(q, "batch", None, kvs, None)
        # -> B,nkv,G,S,D
        qg = q.reshape(B, S, nkv, G, hd).permute(0, 2, 3, 1, 4)
        qg = qg.reshape(B, nkv, G * S, hd)
        logits = torch.einsum("bhgk,bhsk->bhgs", qg.float(),
                              kc.to(cdt).float())
        logits = logits / math.sqrt(hd)
        valid = torch.arange(Sc, device=x.device) <= cache_index
        logits = torch.where(valid[None, None, None], logits, -1e30)
        if rules is not None:
            logits = rules.constrain(logits, "batch", "kv_heads", None,
                                     "cache_seq")
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgs,bhsk->bhgk", w.to(cdt), vc.to(cdt))
        out = out.reshape(B, nkv, G, S, hd).permute(0, 3, 1, 2, 4)
        out = out.reshape(B, S, nq, hd)
        new_cache = {"k": kc, "v": vc}

    y = out_proj(out.to(cdt), p["wo"].to(cdt))
    return y, new_cache


# ----------------------------------------------------------------- FFN
def ffn_init(generator, d_model, d_ff, gated=True) -> Params:
    p = {"w_up": _init(generator, (d_model, d_ff)),
         "w_down": _init(generator, (d_ff, d_model))}
    if gated:
        p["w_gate"] = _init(generator, (d_model, d_ff))
    return p


def ffn_axes(gated=True):
    a = {"w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}
    if gated:
        a["w_gate"] = ("embed", "ffn")
    return a


def ffn_apply(p, x, *, rules=None, cdt=torch.bfloat16, gated=True):
    xc = x.to(cdt)
    up = SH.by_token(torch.matmul, xc, p["w_up"].to(cdt))
    if gated:
        gate = F.silu(SH.by_token(torch.matmul, xc, p["w_gate"].to(cdt)))
        h = gate * up
    else:
        h = F.gelu(up, approximate="tanh")
    if rules is not None:
        # ffn (tensor) parallelism owns the model axis here; the sequence
        # dim stays unsharded inside the FFN even under context parallelism
        h = rules.constrain(h, "batch", None, "ffn")
    return h @ p["w_down"].to(cdt)


# ----------------------------------------------------------------- embedding
def embedding_init(generator, vocab, d_model, pad_to=1) -> Params:
    vpad = ((vocab + pad_to - 1) // pad_to) * pad_to
    return {"table": _init(generator, (vpad, d_model), scale=0.02)}


def embedding_axes():
    return {"table": ("vocab", "embed")}


def embed_apply(p, ids, cdt=torch.bfloat16):
    # gather, then cast: the rows the reference's cast table gives,
    # without casting the whole table
    return SH.gather_rows(p["table"], ids).to(cdt)


def unembed_apply(p, x, cdt=torch.bfloat16):
    return torch.einsum("bsd,vd->bsv", x.to(cdt), p["table"].to(cdt))
