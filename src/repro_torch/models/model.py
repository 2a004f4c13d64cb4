"""Full-model assembly for every registered architecture family.

``init_params`` / ``param_axes`` / ``forward`` / ``init_cache`` /
``decode_forward`` dispatch on ``cfg.family``:

* dense | moe | vlm : token-embedding decoder LM, uniform stacked layers.
* hybrid (jamba)    : stacked periods of 1 attention + (period-1) mamba
                      layers, MoE on every ``moe_every``-th layer (every
                      FFN dense without ``cfg.moe``).
* ssm (xlstm)       : stacked (mLSTM, sLSTM) block pairs.
* audio (whisper)   : enc-dec; encoder over stubbed frame embeddings.

Layer stacks keep the reference's leading "stack" axis, one tensor a
leaf, so a param tree carries across the two packages key for key. A
forward loops over the stack's index (each leaf unbound once, so the
backward stacks the layers' gradients in one copy), and with ``remat``
recomputes each layer (a hybrid period's each slot) in the backward
(``torch.utils.checkpoint.checkpoint``, non-reentrant). Decoding runs
without autograd and updates the cache it is given in place.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as M
from repro_torch.models import xlstm as X
from repro_torch.params import tree_flatten, tree_map
from repro_torch.runtime import sharding as SH

VOCAB_PAD = 128


def padded_vocab(cfg) -> int:
    return ((cfg.vocab + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def _stack(trees):
    """Stack a list of same-structure trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unstack(tree):
    """The per-index subtrees of a stacked tree (views)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return tree.unbind(0)


def _reducing_grads(layer):
    """A layer's params as views made here, each DTensor's gradient
    reduced to its own placements when the layer's backward gives it: a
    pending sum is whole on every rank, and held to the step's end it
    would cost a whole gradient a layer (GSPMD reduce-scatters each
    layer's gradient as it goes). Made just before the layer runs:
    autograd runs a node only after every node made later."""
    return tree_map(_reducing_grad, layer)


def _reducing_grad(t):
    if not (isinstance(t, SH.DTensor) and t.requires_grad):
        return t
    v = t.view_as(t)
    v.register_hook(functools.partial(SH.reduce_to, t.device_mesh,
                                      t.placements))
    return v


def _stack_init(n, fn):
    return _stack([fn() for _ in range(n)])


def _stack_axes(axes):
    if isinstance(axes, dict):
        return {k: _stack_axes(v) for k, v in axes.items()}
    return ("stack",) + axes


def _store(views, new) -> None:
    """Write a layer's new decode state into its views of the cache."""
    for v, n in zip(tree_flatten(views), tree_flatten(new), strict=True):
        if n is not v:
            v.copy_(n)


def _run_stack(body, h, stack, remat):
    """h through ``body(h, layer) -> (h, aux)`` for every layer of the
    stack; returns (h, sum of aux)."""
    auxs = []
    for lp in _unstack(stack):
        lp = _reducing_grads(lp)
        if remat:
            h, aux = checkpoint(body, h, lp, use_reentrant=False)
        else:
            h, aux = body(h, lp)
        auxs.append(aux)
    return h, torch.stack(auxs).sum()


# =========================================================== uniform decoder
def _layer_init(generator, cfg, gated=True):
    p = {"attn": L.attention_init(generator, cfg),
         "ln1": torch.ones((cfg.d_model,)), "ln2": torch.ones((cfg.d_model,))}
    if cfg.moe is not None and cfg.moe.moe_every == 1:
        p["moe"] = M.moe_init(generator, cfg)
    else:
        p["ffn"] = L.ffn_init(generator, cfg.d_model, cfg.d_ff, gated=gated)
    return p


def _layer_axes(cfg, gated=True):
    a = {"attn": L.attention_axes(cfg), "ln1": (None,), "ln2": (None,)}
    if cfg.moe is not None and cfg.moe.moe_every == 1:
        a["moe"] = M.moe_axes(cfg)
    else:
        a["ffn"] = L.ffn_axes(gated=gated)
    return a


def _layer_apply(p, h, cfg, *, positions, rules, cdt, cache=None,
                 cache_index=None):
    attn_in = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    a, new_cache = L.attention_apply(p["attn"], attn_in, cfg,
                                     positions=positions, rules=rules,
                                     cdt=cdt, cache=cache,
                                     cache_index=cache_index)
    h = h + a.to(h.dtype)
    ffn_in = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, aux = M.moe_apply(p["moe"], ffn_in, cfg, rules=rules, cdt=cdt)
    else:
        f = L.ffn_apply(p["ffn"], ffn_in, rules=rules, cdt=cdt)
        aux = torch.zeros((), device=h.device)
    return h + f.to(h.dtype), new_cache, aux


# =========================================================== hybrid (jamba)
def _moe_slot(cfg, slot: int) -> bool:
    """Whether a period's FFN slot is an MoE (every FFN is dense where
    ``cfg.moe`` is None)."""
    return cfg.moe is not None and slot % cfg.moe.moe_every == 0


def _period_init(generator, cfg):
    hb = cfg.hybrid
    n_mamba = hb.period - 1
    n_moe = sum(_moe_slot(cfg, s) for s in range(hb.period))
    n_dense = hb.period - n_moe
    p = {"attn": L.attention_init(generator, cfg),
         "mamba": _stack_init(n_mamba, lambda: MB.mamba_init(generator, cfg))}
    if n_moe:
        p["moe"] = _stack_init(n_moe, lambda: M.moe_init(generator, cfg))
    p["ffn"] = _stack_init(n_dense, lambda: L.ffn_init(
        generator, cfg.d_model, cfg.d_ff))
    p["ln1"] = torch.ones((hb.period, cfg.d_model))
    p["ln2"] = torch.ones((hb.period, cfg.d_model))
    return p


def _period_axes(cfg):
    a = {"attn": L.attention_axes(cfg),
         "mamba": _stack_axes(MB.mamba_axes(cfg)),
         "ffn": _stack_axes(L.ffn_axes()),
         "ln1": (None, None), "ln2": (None, None)}
    if cfg.moe is not None:
        a["moe"] = _stack_axes(M.moe_axes(cfg))
    return a


def _slot_apply(h, sp, cfg, *, attn, moe, positions, rules, cdt,
                cache=None, cache_index=None):
    """One slot of a period: its mixer (attention or mamba) and its FFN
    (MoE or dense), each behind its RMSNorm. ``sp`` holds the slot's
    ``ln1``, ``ln2``, ``mix`` and ``ffn`` params. With ``cache`` (decode)
    the mixer's KV cache or mamba state is updated in place. Returns (h,
    aux)."""
    mix_in = L.rms_norm(h, sp["ln1"], cfg.norm_eps)
    if attn:
        a, _ = L.attention_apply(sp["mix"], mix_in, cfg, positions=positions,
                                 rules=rules, cdt=cdt, cache=cache,
                                 cache_index=cache_index)
    else:
        a, new_st = MB.mamba_apply(sp["mix"], mix_in, cfg, rules=rules,
                                   cdt=cdt, state=cache)
        if cache is not None:
            _store(cache, new_st)
    h = h + a.to(h.dtype)
    ffn_in = L.rms_norm(h, sp["ln2"], cfg.norm_eps)
    if moe:
        f, aux = M.moe_apply(sp["ffn"], ffn_in, cfg, rules=rules, cdt=cdt)
    else:
        f = L.ffn_apply(sp["ffn"], ffn_in, rules=rules, cdt=cdt)
        aux = torch.zeros((), device=h.device)
    return h + f.to(h.dtype), aux


def _period_apply(p, h, cfg, *, positions, rules, cdt, caches=None,
                  cache_index=None, remat=False):
    """One period: slots 0..period-1; attention at hb.attn_index. With
    ``caches`` (decode), the attention's KV cache and each mamba layer's
    state are updated in place. With ``remat`` each slot is recomputed
    on its own in the backward, so one slot's activations are held at a
    time."""
    hb = cfg.hybrid
    mamba_p, ffn_p = _unstack(p["mamba"]), _unstack(p["ffn"])
    moe_p = _unstack(p["moe"]) if "moe" in p else []
    mamba_st = _unstack(caches["mamba"]) if caches is not None else None
    mamba_i = moe_i = ffn_i = 0
    aux_total = torch.zeros((), device=h.device)
    for slot in range(hb.period):
        attn, moe = slot == hb.attn_index, _moe_slot(cfg, slot)
        sp = {"ln1": p["ln1"][slot], "ln2": p["ln2"][slot],
              "mix": p["attn"] if attn else mamba_p[mamba_i],
              "ffn": moe_p[moe_i] if moe else ffn_p[ffn_i]}
        cache = None
        if caches is not None:
            cache = caches["attn"] if attn else mamba_st[mamba_i]
        body = functools.partial(_slot_apply, cfg=cfg, attn=attn, moe=moe,
                                 positions=positions, rules=rules, cdt=cdt,
                                 cache=cache, cache_index=cache_index)
        if remat:
            h, aux = checkpoint(body, h, sp, use_reentrant=False)
        else:
            h, aux = body(h, sp)
        aux_total = aux_total + aux
        mamba_i += not attn
        moe_i += moe
        ffn_i += not moe
    return h, caches, aux_total


# =========================================================== whisper enc-dec
def _enc_layer_init(generator, cfg):
    return {"attn": L.attention_init(generator, cfg),
            "ffn": L.ffn_init(generator, cfg.d_model, cfg.d_ff, gated=False),
            "ln1": torch.ones((cfg.d_model,)),
            "ln2": torch.ones((cfg.d_model,))}


def _enc_layer_apply(p, h, cfg, *, rules, cdt):
    """Bidirectional attention (no causal mask, no rope — learned pos)."""
    x = L.rms_norm(h, p["ln1"], cfg.norm_eps).to(cdt)
    q = L._proj(x, p["attn"]["wq"].to(cdt))
    k = L._proj(x, p["attn"]["wk"].to(cdt))
    v = L._proj(x, p["attn"]["wv"].to(cdt))
    o = L.flash_attention(q, k, v, causal=False, rules=rules)
    a = L.out_proj(o, p["attn"]["wo"].to(cdt))
    h = h + a.to(h.dtype)
    f = L.ffn_apply(p["ffn"], L.rms_norm(h, p["ln2"], cfg.norm_eps),
                    rules=rules, cdt=cdt, gated=False)
    return h + f.to(h.dtype)


def _dec_layer_init(generator, cfg):
    return {"attn": L.attention_init(generator, cfg),
            "xattn": L.attention_init(generator, cfg),
            "ffn": L.ffn_init(generator, cfg.d_model, cfg.d_ff, gated=False),
            "ln1": torch.ones((cfg.d_model,)),
            "lnx": torch.ones((cfg.d_model,)),
            "ln2": torch.ones((cfg.d_model,))}


def _cross_attend(p, x, enc_kv, cfg, rules, cdt):
    q = L._proj(x.to(cdt), p["wq"].to(cdt))
    o = L.flash_attention(q, enc_kv["k"].to(cdt), enc_kv["v"].to(cdt),
                          causal=False, rules=rules)
    return L.out_proj(o, p["wo"].to(cdt))


def _dec_layer_apply(p, h, cfg, *, positions, enc_kv, rules, cdt,
                     cache=None, cache_index=None):
    a_in = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    a, new_cache = L.attention_apply(p["attn"], a_in, cfg,
                                     positions=positions, rules=rules,
                                     cdt=cdt, cache=cache,
                                     cache_index=cache_index)
    h = h + a.to(h.dtype)
    x_in = L.rms_norm(h, p["lnx"], cfg.norm_eps)
    xa = _cross_attend(p["xattn"], x_in, enc_kv, cfg, rules, cdt)
    h = h + xa.to(h.dtype)
    f = L.ffn_apply(p["ffn"], L.rms_norm(h, p["ln2"], cfg.norm_eps),
                    rules=rules, cdt=cdt, gated=False)
    return h + f.to(h.dtype), new_cache


# ================================================================= top level
def init_params(generator, cfg) -> Dict[str, Any]:
    """float32 params with the reference's tree, shapes and scales,
    drawn from ``generator`` on the default device (see
    :mod:`repro_torch.models.layers`)."""
    g = generator
    vp = padded_vocab(cfg)
    p: Dict[str, Any] = {
        "embed": L.embedding_init(g, cfg.vocab, cfg.d_model,
                                  pad_to=VOCAB_PAD),
        "final_norm": torch.ones((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"table": L._init(g, (vp, cfg.d_model), scale=0.02)}
    fam = cfg.family
    if fam == "ssm":
        n_pairs = max(cfg.n_layers // 2, 1)
        p["pairs"] = _stack_init(n_pairs, lambda: {
            "mlstm": X.mlstm_init(g, cfg), "slstm": X.slstm_init(g, cfg)})
    elif fam == "hybrid":
        n_periods = cfg.n_layers // cfg.hybrid.period
        p["periods"] = _stack_init(n_periods, lambda: _period_init(g, cfg))
    elif fam == "audio":
        p["enc_pos"] = L._init(g, (cfg.encoder_seq, cfg.d_model), scale=0.02)
        p["dec_pos"] = L._init(g, (32768, cfg.d_model), scale=0.02)
        p["enc_layers"] = _stack_init(cfg.n_encoder_layers,
                                      lambda: _enc_layer_init(g, cfg))
        p["dec_layers"] = _stack_init(cfg.n_layers,
                                      lambda: _dec_layer_init(g, cfg))
        p["enc_norm"] = torch.ones((cfg.d_model,))
    else:  # dense | moe | vlm
        p["layers"] = _stack_init(cfg.n_layers,
                                  lambda: _layer_init(g, cfg, True))
    return p


def param_axes(cfg) -> Dict[str, Any]:
    a: Dict[str, Any] = {
        "embed": L.embedding_axes(),
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        a["unembed"] = {"table": ("vocab", "embed")}
    fam = cfg.family
    if fam == "ssm":
        a["pairs"] = _stack_axes({"mlstm": X.mlstm_axes(cfg),
                                  "slstm": X.slstm_axes(cfg)})
    elif fam == "hybrid":
        a["periods"] = _stack_axes(_period_axes(cfg))
    elif fam == "audio":
        a["enc_pos"] = (None, "embed")
        a["dec_pos"] = (None, "embed")
        a["enc_layers"] = _stack_axes({
            "attn": L.attention_axes(cfg), "ffn": L.ffn_axes(gated=False),
            "ln1": (None,), "ln2": (None,)})
        a["dec_layers"] = _stack_axes({
            "attn": L.attention_axes(cfg), "xattn": L.attention_axes(cfg),
            "ffn": L.ffn_axes(gated=False),
            "ln1": (None,), "lnx": (None,), "ln2": (None,)})
        a["enc_norm"] = (None,)
    else:
        a["layers"] = _stack_axes(_layer_axes(cfg))
    return a


def _embed_tokens(p, cfg, batch, cdt, rules):
    h = L.embed_apply(p["embed"], batch["tokens"], cdt=cdt)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(cdt)
        P = pe.shape[1]
        h = torch.cat([pe, h[:, P:]], dim=1)
    if rules is not None:
        h = rules.constrain(h, "batch", "qseq", "embed")
    return h


def _run_encoder(p, cfg, frame_embeds, rules, cdt):
    h = frame_embeds.to(cdt) + p["enc_pos"].to(cdt)

    def body(hh, lp):
        return _enc_layer_apply(lp, hh, cfg, rules=rules, cdt=cdt), \
            torch.zeros((), device=hh.device)

    h, _ = _run_stack(body, h, p["enc_layers"], remat=True)
    return L.rms_norm(h, p["enc_norm"], cfg.norm_eps)


def _enc_kv(p_layer, enc_out, cfg, cdt):
    G = cfg.n_heads // cfg.n_kv_heads
    k = L._proj(enc_out.to(cdt), p_layer["xattn"]["wk"].to(cdt))
    v = L._proj(enc_out.to(cdt), p_layer["xattn"]["wv"].to(cdt))
    return {"k": torch.repeat_interleave(k, G, dim=2),
            "v": torch.repeat_interleave(v, G, dim=2)}


def forward(params, cfg, batch, *, rules=None, cdt=torch.bfloat16,
            remat=True, unembed=True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward. Returns (logits, aux_loss) — or, with
    unembed=False, (final hidden states, aux_loss) so the caller can fuse
    the unembedding into a chunked loss (never building full logits).
    With ``rules``, params and batch are DTensors, and the caller runs
    this inside ``sharding.step_scope(rules)`` (the steps do)."""
    S = batch["tokens"].shape[1]
    dev = batch["tokens"].device
    # (1, S): the rotary tables broadcast over the batch (a (B, S) table
    # would be built whole on every rank of a mesh)
    positions = torch.arange(S, device=dev)[None]
    fam = cfg.family

    if fam == "audio":
        enc_out = _run_encoder(params, cfg, batch["frame_embeds"], rules,
                               cdt)
        h = L.embed_apply(params["embed"], batch["tokens"], cdt=cdt)
        h = h + params["dec_pos"][:S].to(cdt)

        def body(hh, lp):
            ekv = _enc_kv(lp, enc_out, cfg, cdt)
            out, _ = _dec_layer_apply(lp, hh, cfg, positions=positions,
                                      enc_kv=ekv, rules=rules, cdt=cdt)
            return out, torch.zeros((), device=dev)

        h, _ = _run_stack(body, h, params["dec_layers"], remat)
        aux = torch.zeros((), device=dev)
    elif fam == "ssm":
        h = _embed_tokens(params, cfg, batch, cdt, rules)

        def body(hh, pp):
            hh, _ = X.mlstm_block_apply(pp["mlstm"], hh, cfg, rules=rules,
                                        cdt=cdt)
            hh, _ = X.slstm_block_apply(pp["slstm"], hh, cfg, rules=rules,
                                        cdt=cdt)
            return hh, torch.zeros((), device=dev)

        h, _ = _run_stack(body, h, params["pairs"], remat)
        aux = torch.zeros((), device=dev)
    elif fam == "hybrid":
        h = _embed_tokens(params, cfg, batch, cdt, rules)

        def body(hh, pp):
            out, _, aux_p = _period_apply(pp, hh, cfg, positions=positions,
                                          rules=rules, cdt=cdt, remat=remat)
            return out, aux_p

        # each slot of a period is recomputed on its own (in the body)
        h, aux = _run_stack(body, h, params["periods"], remat=False)
    else:
        h = _embed_tokens(params, cfg, batch, cdt, rules)

        def body(hh, lp):
            out, _, aux_l = _layer_apply(lp, hh, cfg, positions=positions,
                                         rules=rules, cdt=cdt)
            return out, aux_l

        h, aux = _run_stack(body, h, params["layers"], remat)

    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if not unembed:
        return h, aux
    logits = unembed_logits(h.to(cdt), unembed_table(params, cfg).to(cdt),
                            rules, ("batch", "qseq", "vocab"))
    return logits, aux


def unembed_logits(h, table, rules, axes):
    """(B, S, d) x (V, d) -> logits (B, S, V), constrained to ``axes``.

    With rules, the table is first placed as the constrained logits need
    it (its vocab dim split as theirs, its d_model dim whole), so the
    product gives those placements directly. GSPMD moves the table there
    on its own; DTensor propagates no constraint backwards and would
    otherwise reshard the (much larger) logits."""
    if rules is not None:
        spec = rules.spec(axes, (h.shape[0], h.shape[1], table.shape[0]))
        table = rules.constrain(table, axes[2] if spec[2] else None, None)
    logits = SH.by_token(_bsd_vd, h, table)
    if rules is not None:
        logits = rules.constrain(logits, *axes)
    return logits


def _bsd_vd(h, table):
    return torch.einsum("bsd,vd->bsv", h, table)


def unembed_table(params, cfg):
    return params["embed"]["table"] if cfg.tie_embeddings else \
        params["unembed"]["table"]


# ------------------------------------------------------------------- decode
def init_cache(cfg, batch: int, max_seq: int, *, kv_dtype=torch.bfloat16,
               device=None):
    """Decode-state tree (KV caches / recurrent states), zeros on
    ``device`` (the default device when None)."""
    nkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def kvc():
        z = torch.zeros((batch, nkv, max_seq, hd), dtype=kv_dtype)
        return {"k": z, "v": z.clone()}

    def stack(n, tree):
        return tree_map(lambda x: x.expand((n,) + x.shape).clone(), tree)

    with (torch.device(device) if device is not None
          else contextlib.nullcontext()):
        fam = cfg.family
        if fam == "ssm":
            n_pairs = max(cfg.n_layers // 2, 1)
            return stack(n_pairs, {"mlstm": X.mlstm_init_state(cfg, batch),
                                   "slstm": X.slstm_init_state(cfg, batch)})
        if fam == "hybrid":
            n_periods = cfg.n_layers // cfg.hybrid.period
            one = {"attn": kvc(),
                   "mamba": stack(cfg.hybrid.period - 1,
                                  MB.mamba_init_state(cfg, batch))}
            return stack(n_periods, one)
        if fam == "audio":
            return {"self": stack(cfg.n_layers, kvc()),
                    "enc_out": torch.zeros(
                        (batch, cfg.encoder_seq, cfg.d_model),
                        dtype=torch.bfloat16)}
        return stack(cfg.n_layers, kvc())


def cache_axes(cfg):
    """Logical sharding axes matching init_cache's tree."""
    kv_axes = {"k": ("stack", "batch", "kv_heads", "cache_seq", None),
               "v": ("stack", "batch", "kv_heads", "cache_seq", None)}
    fam = cfg.family
    if fam == "ssm":
        return {
            "mlstm": {
                "conv": ("stack", "batch", None, "ffn"),
                "cell": {"C": ("stack", "batch", "heads", None, None),
                         "n": ("stack", "batch", "heads", None),
                         "m": ("stack", "batch", "heads")}},
            "slstm": {k: ("stack", "batch", None)
                      for k in ("c", "n", "h", "m")},
        }
    if fam == "hybrid":
        return {
            "attn": kv_axes,
            "mamba": {"conv": ("stack", "stack2", "batch", None, "ffn"),
                      "ssm": ("stack", "stack2", "batch", "ffn", None)},
        }
    if fam == "audio":
        return {"self": kv_axes, "enc_out": ("batch", None, "embed")}
    return kv_axes


@torch.no_grad()
def decode_forward(params, cfg, tokens, cache, index, *, rules=None,
                   cdt=torch.bfloat16):
    """One decode step. tokens: (B, 1) int; index: the position (an int,
    or a 0-d tensor, read on the host). Updates ``cache`` in place and
    returns (logits (B, vocab_padded), cache). With ``rules``, params
    and cache are DTensors; each rank writes its own shard of the cache,
    inside ``sharding.step_scope(rules)`` as :func:`forward`."""
    index = int(index)
    B = tokens.shape[0]
    positions = torch.full((B, 1), index, device=tokens.device)
    fam = cfg.family
    h = L.embed_apply(params["embed"], tokens, cdt=cdt)

    if fam == "audio":
        h = h + params["dec_pos"][index:index + 1].to(cdt)
        enc_out = cache["enc_out"]
        for lp, c in zip(_unstack(params["dec_layers"]),
                         _unstack(cache["self"])):
            ekv = _enc_kv(lp, enc_out, cfg, cdt)
            h, _ = _dec_layer_apply(lp, h, cfg, positions=positions,
                                    enc_kv=ekv, rules=rules, cdt=cdt,
                                    cache=c, cache_index=index)
    elif fam == "ssm":
        for pp, st in zip(_unstack(params["pairs"]), _unstack(cache)):
            h, s1 = X.mlstm_block_apply(pp["mlstm"], h, cfg, rules=rules,
                                        cdt=cdt, state=st["mlstm"])
            h, s2 = X.slstm_block_apply(pp["slstm"], h, cfg, rules=rules,
                                        cdt=cdt, state=st["slstm"])
            _store(st, {"mlstm": s1, "slstm": s2})
    elif fam == "hybrid":
        for pp, c in zip(_unstack(params["periods"]), _unstack(cache)):
            h, _, _ = _period_apply(pp, h, cfg, positions=positions,
                                    rules=rules, cdt=cdt, caches=c,
                                    cache_index=index)
    else:
        for lp, c in zip(_unstack(params["layers"]), _unstack(cache)):
            h, _, _ = _layer_apply(lp, h, cfg, positions=positions,
                                   rules=rules, cdt=cdt, cache=c,
                                   cache_index=index)

    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed_logits(h.to(cdt), unembed_table(params, cfg).to(cdt),
                            rules, ("batch", None, "vocab"))
    return logits[:, 0], cache
