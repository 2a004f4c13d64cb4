"""train_step / prefill_step / decode_step builders + input_specs.

``input_specs(arch, shape)`` returns ``meta``-device stand-ins for every
model input (nothing allocated), as do ``abstract_params``,
``abstract_opt_state`` and ``abstract_cache``.

A train step takes its gradients with ``torch.autograd`` and updates
with the port's AdamW (:mod:`repro_torch.optim.adamw`), so its metrics
carry the reference's names.

With ``rules`` (:class:`repro_torch.runtime.sharding.ShardingRules`) the
params, optimizer state and cache are DTensors the caller placed
(``tree_shardings`` + ``place_tree``); a batch given as plain tensors,
which every rank holds in full, is placed ``("batch", None, ...)`` as the
reference's dry run places it. Gradients are redistributed to their
params' placements before ``grad_transform`` and the optimizer, and the
metrics come back as plain (replicated) tensors.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import model as MODEL
from repro_torch.obs import trace as OBS
from repro_torch.optim import adamw
from repro_torch.params import tree_flatten, tree_unflatten
from repro_torch.runtime import sharding as SH


def _nll(logits, labels, vocab: int):
    """(sum of the unmasked tokens' negative log-likelihood, their
    count) of float32 logits (B, S, Vpad); labels -1 are masked, padded
    vocab columns leave the softmax."""
    vpad = logits.shape[-1]
    if vpad > vocab:
        col = torch.arange(vpad, device=logits.device)
        logits = torch.where(col[None, None, :] < vocab, logits, -1e30)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, SH.DTensor):
        # the gold logit as a masked sum (the same value): DTensor runs
        # gather's backward as zeros of the global shape on every rank
        col = torch.arange(vpad, device=logits.device)
        gold = torch.where(col == safe[..., None], logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum().float()


def cross_entropy_loss(logits, labels, vocab: int):
    """logits: (B, S, Vpad) (any float dtype); labels int with -1 = masked.
    Padded-vocab columns are masked out of the softmax."""
    nll, cnt = _nll(logits.float(), labels, vocab)
    return nll / torch.clamp(cnt, min=1)


def _chunk_nll(hx, lx, table, vocab: int, rules):
    logits = MODEL.unembed_logits(hx, table.to(hx.dtype), rules,
                                  ("batch", None, "vocab"))
    return _nll(logits.float(), lx, vocab)


def fused_unembed_loss(h, table, labels, vocab: int, *, chunk: int = 512,
                       rules=None):
    """Sequence-chunked unembed+cross-entropy: full (B, S, V) logits are
    never built. Each chunk's loss is checkpointed, so its logits are
    freed after the forward and recomputed, one chunk at a time, in the
    backward (a large activation-memory win at 32k seq / 150k vocab)."""
    S = h.shape[1]
    chunk = min(chunk, S)
    nll = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for start in range(0, S, chunk):
        sl = slice(start, start + chunk)
        s, c = checkpoint(_chunk_nll, h[:, sl], labels[:, sl], table,
                          vocab, rules, use_reentrant=False)
        nll, cnt = nll + s, cnt + c
    return nll / torch.clamp(cnt, min=1)


def make_loss_fn(cfg: ArchConfig, rules=None, remat=True):
    def loss_fn(params, batch):
        h, aux = MODEL.forward(params, cfg, batch, rules=rules,
                               remat=remat, unembed=False)
        loss = fused_unembed_loss(h, MODEL.unembed_table(params, cfg),
                                  batch["labels"], cfg.vocab, rules=rules)
        return loss + aux, {"loss": loss, "aux": aux}
    return loss_fn


def _plain(x):
    return x.full_tensor() if isinstance(x, SH.DTensor) else x


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    rules=None, remat=True, grad_transform=None):
    """Returns train_step(params, opt_state, batch)
    -> (params', state', metrics); the inputs are not modified.

    grad_transform: optional fn(grads) -> grads (e.g. compression hook)
    applied before the optimizer. A param the loss does not reach gets a
    zero gradient.

    Each step records spans into :func:`repro_torch.obs.trace.
    default_tracer` (1 in ``TRAIN_SAMPLE_EVERY`` steps, and every step
    while a torch profiler records, tagged ``profiled``): a root
    ``lm.step`` over ``lm.loss_grad`` (the loss and ``autograd.grad``)
    and ``lm.optimizer`` (``grad_transform`` and AdamW). They are host
    times, never profiler ranges.
    """
    loss_fn = make_loss_fn(cfg, rules=rules, remat=remat)
    tr = OBS.default_tracer()

    def train_step(params, opt_state, batch):
        profiled = OBS.profiling()
        with tr.span("lm.step", tr.sample(force=profiled),
                     {"profiled": profiled}) as sp:
            # the backward, which recomputes remat'd layers, runs inside
            with SH.step_scope(rules):
                return _train_step(params, opt_state, batch,
                                   sp.ctx if sp is not None else None)

    def _train_step(params, opt_state, batch, ctx):
        with tr.span("lm.loss_grad", ctx):
            batch = SH.place_batch(rules, batch)
            flat = tree_flatten(params)
            live = [p.detach().requires_grad_() for p in flat]
            total, inner = loss_fn(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(total, live, materialize_grads=True)
        with tr.span("lm.optimizer", ctx):
            grads = tree_unflatten(params, SH.like(grads, flat))
            if grad_transform is not None:
                grads = grad_transform(grads)
            params, opt_state, opt_metrics = adamw.apply_updates(
                params, grads, opt_state, opt_cfg)
        metrics = {"total_loss": total.detach(),
                   **{k: v.detach() for k, v in inner.items()},
                   **opt_metrics}
        return params, opt_state, {k: _plain(v) for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ArchConfig, rules=None):
    """prefill_step(params, batch) -> last-token logits (B, Vpad)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        with SH.step_scope(rules):
            logits, _ = MODEL.forward(params, cfg,
                                      SH.place_batch(rules, batch),
                                      rules=rules, remat=False)
            return logits[:, -1]
    return prefill_step


def next_token(logits, vocab: int):
    """Greedy token (B, 1) int32 of (B, Vpad) logits; padded vocab
    columns never win. A DTensor's argmax runs on replicated logits
    (DTensor's own fails at batch 1 in torch 2.11)."""
    return SH.replicated(functools.partial(_greedy, vocab=vocab), logits)


def _greedy(logits, vocab: int):
    vpad = logits.shape[-1]
    if vpad > vocab:
        col = torch.arange(vpad, device=logits.device)
        logits = torch.where(col[None, :] < vocab, logits.float(), -1e30)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def make_decode_step(cfg: ArchConfig, rules=None):
    """decode_step(params, cache, tokens, index) -> (next_token, cache);
    the cache is updated in place."""
    def decode_step(params, cache, tokens, index):
        with SH.step_scope(rules):
            tokens = SH.place_batch(rules, {"tokens": tokens})["tokens"]
            logits, new_cache = MODEL.decode_forward(params, cfg, tokens,
                                                     cache, index,
                                                     rules=rules)
            return next_token(logits, cfg.vocab), new_cache
    return decode_step


# ------------------------------------------------------------- input specs
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for the step inputs of this (arch, shape)."""
    B = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    S = shape.seq_len
    specs: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = _meta((B, S), torch.int32)
    if cfg.frontend == "vision":
        specs["patch_embeds"] = _meta((B, cfg.vision_patches, cfg.d_model),
                                      torch.bfloat16)
    if cfg.frontend == "audio":
        specs["frame_embeds"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                      torch.bfloat16)
    return specs


def abstract_params(cfg: ArchConfig):
    """The param tree on the ``meta`` device (nothing allocated)."""
    with torch.device("meta"):
        return MODEL.init_params(None, cfg)


def abstract_opt_state(abs_params):
    return adamw.init_state(abs_params)


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   kv_dtype=torch.bfloat16):
    return MODEL.init_cache(cfg, batch, max_seq, kv_dtype=kv_dtype,
                            device="meta")


def opt_state_axes(param_axes_tree):
    """Optimizer-state logical axes mirror the param axes."""
    return {"m": param_axes_tree, "v": param_axes_tree, "count": ()}
