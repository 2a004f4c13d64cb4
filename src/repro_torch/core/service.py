"""CostModelService — the deployed model, as the DL-compiler sees it.

The paper's end state: "Deploy the model which the DL-compiler can invoke
while compiling in order to make the best decisions." This module provides:

* batched, cached inference over MLIR graphs/text. One service predicts
  **all** trained targets (register pressure, vALU utilization, latency)
  from a single encoder forward pass when built from a multi-head model;
  single-head models keep working through the same API.
* sequence-length bucketing: each graph is padded to the smallest
  power-of-two bucket that fits it (not the global ``max_seq``), so short
  graphs stop paying full-length encoder cost. Every model family masks
  padding, so bucketed predictions equal unbucketed ones.
* a bounded LRU prediction cache (per-target vectors keyed by content
  hash) so a long-running compiler session can't grow memory without
  limit.
* an incremental featurization hot path (``fast_encode``, default): the
  LRU is probed by struct key BEFORE any tokenization, token-id arrays
  are cached by struct key, rewrite-derived graphs splice their ids
  from the parent's cached array (only the rewrite's dirty ops are
  re-lexed), and fresh batches encode through the vectorized
  ``Vocab.encode_many``. Phase timers (``phase_stats()``) attribute
  wall time to hash/encode/forward, and a ``truncations`` counter makes
  silent past-bucket drops observable.
* optional bf16 quantized serving (``dtype="bf16"``): params are cast
  once at construction, forward passes run with bf16 params over the
  same (bucket x ladder) shape set (so ``warmup()`` covers them), and
  rows widen to float32 before the LRU so denormalization stays
  float32-exact. Drift vs f32 is gated in tests (Spearman >= 0.99 per
  target).
* device placement: params move to ``device`` once at construction
  (``None`` means ``"cuda"``, and a missing card raises; nothing falls
  back to the CPU). A forward pass copies its ids from pinned host memory
  without blocking, launches on the current stream and returns a handle
  with a CUDA event; collecting waits on that event.

* the MLIR-text front door: ``ingest_text`` featurizes lowered MLIR
  text through :mod:`repro_torch.ir.frontdoor` and ``predict_text``
  serves it through the same LRU, buckets and batch ladder as a Graph
  query, answering a structured ``IngestError`` instead of raising.
* three compiler advisors, each a thin wrapper over a single-rule
  :mod:`repro_torch.opt` search (the full multi-rule beam search lives
  in :mod:`repro_torch.opt.search`):
  - FusionAdvisor:    greedy search over the elementwise-fusion rule
  - UnrollAdvisor:    one Unroll-rule expansion; pick the factor with the
                      best per-iteration predicted latency while register
                      pressure stays under budget (both targets from ONE
                      batched forward pass)
  - RecompileAdvisor: given new tensor shapes, reuse compiled code if the
                      predicted characteristic shift is below a threshold
                      (the paper's dynamic-runtime recompile decision).

The LRU is keyed by ``Graph.struct_key()`` — the same canonical
structural hash the opt search dedups its frontier with — so two
SSA-renumbered or re-scheduled spellings of one program share a cache
entry (and coalesce in flight at the server).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import params as P
from repro_torch.core import models as CM
from repro_torch.core import tokenizer as TOK
from repro_torch.ir.graph import Graph


# Canonical bucket ladder lives in the dataset layer (training and serving
# share it); re-exported here for existing callers.
from repro_torch.ir.dataset import default_buckets  # noqa: F401  (re-export)


def pad_slack(kind: str, cfg) -> int:
    """Extra pad positions a bucketed sequence needs so bucket-padded
    predictions exactly match max_seq-padded ones.

    Conv towers propagate boundary conditions inward by sum(fs//2)
    positions per side (the tower's right-edge "cone"). Keeping 2x that
    as pad slack leaves an interior run of constant pad activations
    between the last real token's cone and the bucket edge's cone, which
    makes bucketed outputs exactly match full-length padding. The other
    families mask padding position-wise, so 0 slack is enough."""
    if kind == "conv1d":
        return 2 * sum(fs // 2 for fs in cfg.conv_filters)
    return 0


@dataclass
class CostModelService:
    kind: str
    cfg: object
    params: object
    vocab: TOK.Vocab
    # single-head: {"mu", "sigma"}; multi-head: {target: {"mu", "sigma"}}
    norm_stats: Dict[str, Any]
    mode: str = "ops"
    max_seq: int = 256
    max_batch: int = 256
    # name of the single-head model's target (cosmetic for predict_all keys)
    target: Optional[str] = None
    cache_size: int = 4096
    # Serving precision: "f32" (exact) or "bf16" (params cast once at
    # construction; forward passes run bf16, rows are widened to float32
    # before the LRU and denormalize, so the denormalize path stays
    # float32-exact). Prediction drift vs f32 is gated in tests.
    dtype: str = "f32"
    # Hot-path featurization: token-id arrays cached by struct_key,
    # parent-delta tokenization for rewrite-derived graphs, vectorized
    # Vocab.encode_many for fresh batches, and LRU probes by key BEFORE
    # any tokenization. False restores the legacy always-re-lex path —
    # the flag-switchable baseline the search_fleet benchmark measures.
    fast_encode: bool = True
    ids_cache_size: int = 8192
    # Serve through the fused forward (kernels/ops.forward_apply; the
    # kernels' plain versions on the CPU) instead of the plain PyTorch
    # apply. conv1d runs the full ids-in/predictions-out CUDA kernel
    # (gather + tower + FC + heads in one launch); lstm runs the LSTM
    # CUDA kernel's ids entry (gather from a projection table computed
    # once here, recurrence and heads in one launch). Composes with
    # dtype="bf16": the kernels read bf16 params but accumulate f32
    # (drift vs f32 is Spearman-gated in tests). The kernels'
    # accumulation order differs from cuDNN's and cuBLAS's, so f32 parity
    # is "allclose", not bit-identical.
    use_kernel: bool = False
    buckets: Optional[Tuple[int, ...]] = None   # None -> power-of-two ladder
    # batch sizes forward passes are padded up to (None -> power-of-two
    # ladder capped at max_batch). Fixing the set of executed (B, S)
    # shapes keeps the shape set finite — warmup() runs all of them — and
    # each kernel computes each row in its own thread block, so per-row
    # results do not depend on how requests were packed into batches and
    # coalesced server batches reproduce direct per-request predictions
    # bit-for-bit on the card. The plain path (use_kernel=False) does
    # not: cuDNN and cuBLAS pick their algorithms by shape, so on the
    # card a row's last bits depend on the batch it was forwarded in
    # (within the 2e-4 parity limit). Its float32 convolutions run in
    # IEEE float32 whatever torch's TF32 switches say (models.conv1d).
    batch_ladder: Optional[Tuple[int, ...]] = None
    # torch device for params and forward passes; None means "cuda"
    device: Optional[str] = None
    # content-hash -> (n_heads,) normalized prediction vector, LRU-ordered
    _cache: "OrderedDict[str, np.ndarray]" = field(
        default_factory=OrderedDict)
    _apply = None

    def __post_init__(self):
        # optional repro_torch.obs.drift.DriftMonitor bound via drift.attach();
        # plain attribute so repro_torch.core never imports the obs package
        self.drift = None
        if self.dtype not in ("f32", "bf16"):
            raise ValueError(f"dtype must be f32 or bf16, got "
                             f"{self.dtype!r}")
        if self.use_kernel:
            from repro_torch.kernels import ops as KOPS
            if self.kind not in KOPS.KERNEL_KINDS:
                raise ValueError(
                    f"use_kernel serves the fused forward for "
                    f"kinds {KOPS.KERNEL_KINDS}; kind={self.kind!r} has "
                    f"no kernel")
            kernel_kind = self.kind

            def apply_fn(params, ids):
                # forward_dispatch checks the id range on the host, so
                # the launch never waits for the card to check it
                return KOPS.forward_apply(kernel_kind, params, ids,
                                          check_ids=False)
        else:
            _, apply_fn = CM.get_model(self.kind)
        if self.device is None:
            self.device = "cuda"
        self._device = torch.device(self.device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"CostModelService(device={self.device!r}) needs a CUDA "
                f"card and torch.cuda.is_available() is False; pass "
                f"device='cpu' to run on the CPU")
        # Move the params to the device ONCE at construction, casting
        # the floating leaves to bf16 there for dtype="bf16"; dict keys
        # (head names) survive, and dispatch stacks columns by name.
        params = P.from_numpy(
            self.params, self._device,
            torch.bfloat16 if self.dtype == "bf16" else None)
        if self.use_kernel:
            # the stacked heads (and the LSTM's input projection of every
            # id) once: the LSTM kernel reads the table by id
            # (batch-invariant rows), and a served batch is one launch
            params = KOPS.serving_params(self.kind, params)
        self._apply = lambda ids: apply_fn(params, ids)
        self._vocab_rows = int(params["emb"].shape[0])
        self.heads = CM.model_heads(self.params) or (
            self.target or "prediction",)
        self._multi = CM.model_heads(self.params) is not None
        if self.buckets is None:
            self.buckets = default_buckets(self.max_seq)
        self.buckets = tuple(sorted(b for b in self.buckets
                                    if b <= self.max_seq)) or (self.max_seq,)
        self._pad_slack = pad_slack(self.kind, self.cfg)
        if self.batch_ladder is None:
            # powers of two plus midpoints (1,2,3,4,6,8,12,...): padding
            # waste stays under 33% at any coalesced-batch occupancy
            ladder = set()
            b = 1
            while b < self.max_batch:
                ladder.add(b)
                if b * 3 // 2 < self.max_batch:
                    ladder.add(b * 3 // 2)
                b *= 2
            ladder.add(self.max_batch)
            self.batch_ladder = tuple(sorted(ladder))
        self.batch_ladder = tuple(sorted(
            b for b in self.batch_ladder if b <= self.max_batch)) or (
            self.max_batch,)
        if self.batch_ladder[-1] < self.max_batch:
            # the ladder must cover max_batch: _forward pads UP to a
            # ladder entry, and chunks can be as large as max_batch
            self.batch_ladder += (self.max_batch,)
        # One lock guards the LRU dict and its hit/miss counters: the
        # CostModelServer worker and direct callers share this service
        # from multiple threads.
        self._cache_lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0
        # token-id arrays keyed by struct_key: (bucket-padded ids, true
        # token count) — the featurization cache the parent-delta
        # tokenizer splices from. Guarded by _cache_lock.
        self._ids_cache: "OrderedDict[str, Tuple[np.ndarray, int]]" = \
            OrderedDict()
        self.ids_cache_hits = 0
        self.ids_cache_misses = 0
        self.delta_encodes = 0       # spliced from a parent's cached ids
        self.full_encodes = 0        # tokenized + encoded from scratch
        # sequences dropped past their bucket by Vocab.encode's silent
        # truncation — surfaced so bucketed-serving drops are observable
        self.truncations = 0
        # real-MLIR front door counters (text count, structured
        # failures, the running OOV tally phase_stats() exposes as
        # ``oov_rate``)
        self.ingested_texts = 0
        self.ingest_errors = 0
        self.ingest_tokens = 0
        self.ingest_oov_tokens = 0
        # predictions served from the analyzer-oracle availability floor
        # instead of the model (the replicated tier's degradation, ported
        # with serving/) — flagged so "the fleet was down and the static
        # cost model answered" is a counted, observable event
        self.degraded_preds = 0
        # batched forward passes dispatched (warm-up's shapes excluded):
        # on the card with use_kernel, one kernel launch each, which the
        # replicated tier's stats hold against the kernels' counters
        self.forward_batches = 0
        # wall-clock split of the serving hot path, for benchmark
        # attribution (tokenize/encode/hash vs forward)
        self._phase_s = {"hash_s": 0.0, "encode_s": 0.0, "forward_s": 0.0}
        # per-head (mu, sigma) as vectors: denormalizing all heads of a
        # row block is one vectorized expm1, not one call per target
        # float32 so block denorm rounds exactly like the per-target
        # scalar path (float32 rows * python-float stats -> float32)
        self._mu_vec = np.asarray(
            [self._stats_for(t)["mu"] for t in self.heads], np.float32)
        self._sigma_vec = np.asarray(
            [self._stats_for(t)["sigma"] for t in self.heads], np.float32)

    # ------------------------------------------------------------- encoding
    def _bucket_len(self, n_tokens: int) -> int:
        for b in self.buckets:
            if n_tokens + self._pad_slack <= b:
                return b
        return self.buckets[-1]

    def _phase_add(self, name: str, dt: float) -> None:
        with self._cache_lock:
            self._phase_s[name] += dt

    def phase_stats(self) -> Dict[str, float]:
        """Cumulative wall-clock split of the serving hot path: struct
        hashing vs tokenize/encode vs forward passes. Benchmarks emit
        this so perf PRs can attribute wins per phase. Also carries the
        front-door ingest counters — ``oov_rate`` is the running
        fraction of ingested-text tokens outside the vocabulary, the
        vocabulary-drift signal the server re-exports as
        ``phase_oov_rate`` in every metrics snapshot."""
        with self._cache_lock:
            out = dict(self._phase_s)
            out["truncations"] = self.truncations
            out["delta_encodes"] = self.delta_encodes
            out["full_encodes"] = self.full_encodes
            out["ingested_texts"] = self.ingested_texts
            out["ingest_errors"] = self.ingest_errors
            out["degraded_preds"] = self.degraded_preds
            out["oov_rate"] = (
                self.ingest_oov_tokens / self.ingest_tokens
                if self.ingest_tokens else 0.0)
        return out

    def key_of(self, g: Graph) -> str:
        """Canonical LRU/dedup key (Graph.struct_key, timed)."""
        t0 = time.perf_counter()
        key = g.struct_key()
        self._phase_add("hash_s", time.perf_counter() - t0)
        return key

    def _fresh_ids(self, g: Graph) -> Tuple[np.ndarray, int]:
        """Tokenize + encode from scratch -> (bucket-padded ids, n_tok)."""
        toks = TOK.graph_tokens(g, self.mode)
        bucket = self._bucket_len(len(toks))
        with self._cache_lock:
            self.full_encodes += 1
            if len(toks) > bucket:
                self.truncations += 1
        return self.vocab.encode(toks, bucket), len(toks)

    def _encode(self, g: Graph) -> np.ndarray:
        """Token ids padded to the graph's bucket, not the global max_seq."""
        t0 = time.perf_counter()
        ids, _ = self._fresh_ids(g)
        self._phase_add("encode_s", time.perf_counter() - t0)
        return ids

    def _delta_ids(self, g: Graph) -> Optional[Tuple[np.ndarray, int]]:
        """Splice a rewrite-derived graph's token ids from its parent's
        cached ids: copied op spans are gathered with one vectorized
        index, only the rewrite's dirty ops (plus the small output tail)
        are re-lexed. Returns None when no parent ids are cached, the
        mode is not "ops", or either side truncates (fresh encode then
        handles — and counts — the truncation)."""
        delta = g._tok_delta
        if delta is None or self.mode != "ops":
            return None
        parent_key, op_map = delta
        with self._cache_lock:
            ent = self._ids_cache.get(parent_key)
        if ent is None:
            return None
        p_ids, p_ntok = ent
        if p_ntok > len(p_ids):       # parent itself was truncated
            return None
        n_args, n_ops = g.n_args, len(g.ops)
        n_tok = 1 + n_args + 1 + 2 * n_ops + 1 + len(g.outputs) + 1
        bucket = self._bucket_len(n_tok)
        if n_tok > bucket:
            return None
        out = np.zeros((bucket,), np.int32)          # PAD id is 0
        base = n_args + 2                            # BOS + args + SEP
        out[:base] = p_ids[:base]
        if op_map:
            ci = np.fromiter(op_map.keys(), np.int64, len(op_map))
            pi = np.fromiter(op_map.values(), np.int64, len(op_map))
            dst, src = base + 2 * ci, base + 2 * pi
            out[dst] = p_ids[src]
            out[dst + 1] = p_ids[src + 1]
        t2i = self.vocab.token_to_id
        unk = t2i[TOK.UNK]
        for j, op in enumerate(g.ops):               # dirty ops only
            if j in op_map:
                continue
            out[base + 2 * j] = t2i.get(f"xpu.{op.opcode}", unk)
            out[base + 2 * j + 1] = t2i.get(
                g.values[op.result].shape_token(), unk)
        pos = base + 2 * n_ops
        out[pos] = t2i[TOK.SEP]
        for k, o in enumerate(g.outputs):
            out[pos + 1 + k] = t2i.get(g.values[o].shape_token(), unk)
        out[pos + 1 + len(g.outputs)] = t2i[TOK.EOS]
        with self._cache_lock:
            self.delta_encodes += 1
        return out, n_tok

    def _ids_cache_get(self, key: str) -> Optional[np.ndarray]:
        with self._cache_lock:
            ent = self._ids_cache.get(key)
            if ent is not None:
                self._ids_cache.move_to_end(key)
                self.ids_cache_hits += 1
                return ent[0]
            self.ids_cache_misses += 1
        return None

    def _ids_cache_put(self, key: str, ids: np.ndarray,
                       n_tok: int) -> None:
        with self._cache_lock:
            self._ids_cache[key] = (ids, n_tok)
            self._ids_cache.move_to_end(key)
            while len(self._ids_cache) > self.ids_cache_size:
                self._ids_cache.popitem(last=False)

    def ids_for(self, g: Graph, key: str) -> np.ndarray:
        """Bucket-padded token ids for one graph: ids-cache probe, then
        the parent-delta splice, then a from-scratch encode (legacy
        behavior — and the whole path when ``fast_encode=False``)."""
        if not self.fast_encode:
            return self._encode(g)
        ids = self._ids_cache_get(key)
        if ids is not None:
            return ids
        t0 = time.perf_counter()
        got = self._delta_ids(g)
        if got is None:
            got = self._fresh_ids(g)
        self._phase_add("encode_s", time.perf_counter() - t0)
        self._ids_cache_put(key, *got)
        return got[0]

    def entries_for(self, graphs: Sequence[Graph],
                    keys: Sequence[str]) -> List[Tuple[str, np.ndarray]]:
        """Batch ``(key, ids)`` entries: cached/delta graphs resolve
        individually; the remaining fresh ones are tokenized and pushed
        through ONE vectorized ``Vocab.encode_many`` per bucket."""
        t0 = time.perf_counter()
        out: List[Optional[np.ndarray]] = [None] * len(graphs)
        fresh: List[Tuple[int, str, List[str], int]] = []
        for i, (g, key) in enumerate(zip(graphs, keys)):
            ids = self._ids_cache_get(key)
            if ids is not None:
                out[i] = ids
                continue
            got = self._delta_ids(g)
            if got is not None:
                self._ids_cache_put(key, *got)
                out[i] = got[0]
                continue
            toks = TOK.graph_tokens(g, self.mode)
            bucket = self._bucket_len(len(toks))
            with self._cache_lock:
                self.full_encodes += 1
                if len(toks) > bucket:
                    self.truncations += 1
            fresh.append((i, key, toks, bucket))
        by_bucket: Dict[int, List[Tuple[int, str, List[str]]]] = {}
        for i, key, toks, bucket in fresh:
            by_bucket.setdefault(bucket, []).append((i, key, toks))
        for bucket, group in by_bucket.items():
            block = self.vocab.encode_many([t for _, _, t in group], bucket)
            for (i, key, toks), ids in zip(group, block):
                self._ids_cache_put(key, ids, len(toks))
                out[i] = ids
        self._phase_add("encode_s", time.perf_counter() - t0)
        return list(zip(keys, out))

    def entry(self, g: Graph) -> Tuple[str, np.ndarray]:
        """Batch entry for one graph: (struct key, bucket-padded ids).

        The canonical structural hash keys the LRU cache (invariant
        under SSA renumbering and re-scheduling, so a compiler re-query
        of a re-spelled program is a hit); ``len(ids)`` is the bucket,
        which a coalescing server uses to route the entry onto a queue
        of same-shape requests.

        Deliberate canonicalization trade: schedule-dependent targets
        (register pressure legitimately varies across topological
        re-schedules — see core/augment.py) are served at whichever
        spelling was costed first; the cache answers per dataflow
        graph, not per schedule. Callers that must distinguish
        schedules should query an empty-cache service or embed the
        schedule in the graph structure."""
        key = self.key_of(g)
        return key, self.ids_for(g, key)

    def _stats_for(self, t: str) -> Dict[str, float]:
        return self.norm_stats[t] if self._multi else self.norm_stats

    def denormalize_rows(self, raw: np.ndarray) -> Dict[str, np.ndarray]:
        """(N, n_heads) normalized rows -> {target: (N,) denormalized}.

        One vectorized expm1 over the whole block; numerically identical
        to per-target ``DS.denormalize`` (same ops, same dtype path)."""
        den = np.expm1(raw * self._sigma_vec + self._mu_vec)
        return {t: den[:, i] for i, t in enumerate(self.heads)}

    def normalize_rows(self, den: np.ndarray) -> np.ndarray:
        """(N, n_heads) denormalized values -> normalized rows; exact
        inverse of :meth:`denormalize_rows` (log1p z-score). Lets
        out-of-band predictions (the router's analyzer-oracle fallback)
        ride the same denormalize path as model rows."""
        den = np.asarray(den, np.float32)
        sigma = np.where(self._sigma_vec == 0.0, 1.0, self._sigma_vec)
        return ((np.log1p(den) - self._mu_vec) / sigma).astype(
            np.float32)

    def note_degraded(self, n: int) -> None:
        """Count ``n`` analyzer-fallback (degraded) predictions."""
        with self._cache_lock:
            self.degraded_preds += int(n)

    # ------------------------------------------------------------ inference
    def cache_lookup(self, h: str) -> Optional[np.ndarray]:
        """Thread-safe LRU probe; counts a hit or a miss."""
        with self._cache_lock:
            v = self._cache.get(h)
            if v is not None:
                self._cache.move_to_end(h)
                self.cache_hits += 1
            else:
                self.cache_misses += 1
        return v

    def _cache_put_many(
            self, items: Sequence[Tuple[str, np.ndarray]]) -> None:
        """Insert a whole flushed batch under one lock acquisition."""
        with self._cache_lock:
            for h, v in items:
                self._cache[h] = v
                self._cache.move_to_end(h)
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)

    def export_cache(self) -> List[Tuple[str, np.ndarray]]:
        """Snapshot the prediction LRU as ``(struct key, normalized
        (n_heads,) row)`` pairs in LRU order (oldest first, so importing
        into an empty service reproduces the eviction order). This is
        the replicated tier's cache handoff: a router pre-warms a fresh
        replica (or its own client cache) from any peer's export."""
        with self._cache_lock:
            return [(k, v.copy()) for k, v in self._cache.items()]

    def import_cache(self, items: Sequence[Tuple[str, np.ndarray]]) -> int:
        """Bulk-insert exported cache rows (newest-at-end, LRU bound
        enforced). Returns the number of entries inserted. Rows must be
        normalized (n_heads,) float32 vectors as produced by
        :meth:`export_cache` / the shared cross-replica tier."""
        items = [(k, np.asarray(v, np.float32)) for k, v in items]
        self._cache_put_many(items)
        return len(items)

    def cache_stats(self) -> Dict[str, float]:
        with self._cache_lock:
            hits, misses = self.cache_hits, self.cache_misses
            size = len(self._cache)
            ids_hits, ids_misses = self.ids_cache_hits, \
                self.ids_cache_misses
            ids_size = len(self._ids_cache)
            truncations = self.truncations
        total = hits + misses
        ids_total = ids_hits + ids_misses
        return {"hits": hits, "misses": misses, "size": size,
                "hit_rate": hits / total if total else 0.0,
                "ids_hits": ids_hits, "ids_misses": ids_misses,
                "ids_size": ids_size,
                "ids_hit_rate": ids_hits / ids_total if ids_total else 0.0,
                "truncations": truncations}

    def _ladder_batch(self, n: int) -> int:
        for b in self.batch_ladder:
            if n <= b:
                return b
        return self.batch_ladder[-1]

    def forward_dispatch(self, ids: np.ndarray) -> Tuple[Any, Any, int]:
        """Enqueue one batched forward pass on the device WITHOUT waiting
        and return an opaque ``(out, event, n)`` handle for
        :meth:`forward_collect`. The ids are copied from pinned host
        memory without blocking (their range is checked on the host
        first) and the forward launches on the current stream; ``out``
        holds (B, n_heads) float32 rows whose columns are stacked by
        head name, in ``self.heads`` order. Pads the batch dim
        up to the ladder with all-PAD rows (sliced off at collect), so
        only |batch_ladder| x |buckets| shapes ever run."""
        t0 = time.perf_counter()
        if ids.size and (ids.min() < 0 or ids.max() >= self._vocab_rows):
            raise ValueError(
                f"token ids must lie in [0, {self._vocab_rows}), got "
                f"[{ids.min()}, {ids.max()}]")
        n = ids.shape[0]
        nb = self._ladder_batch(n)
        if nb != n:
            ids = np.concatenate(
                [ids, np.zeros((nb - n, ids.shape[1]), ids.dtype)])
        host = torch.from_numpy(np.ascontiguousarray(ids, np.int32))
        on_card = self._device.type == "cuda"
        event = None
        with torch.inference_mode():
            dev_ids = host.pin_memory().to(self._device, non_blocking=True) \
                if on_card else host
            out = self._apply(dev_ids)
            # columns by head NAME: a param tree whose dict keys were
            # reordered (sorted by a tree transform) must not swap targets
            out = torch.stack([out[t] for t in self.heads], dim=1) \
                if self._multi else out[:, None]
            out = out.float()
            if on_card:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self._device))
        with self._cache_lock:
            self.forward_batches += 1
            self._phase_s["forward_s"] += time.perf_counter() - t0
        return out, event, n

    def forward_collect(self, handle: Tuple[Any, Any, int]) -> np.ndarray:
        """Wait for a dispatched forward pass -> (B, n_heads) normalized
        predictions (padding rows removed). Rows are float32 (the kernel
        computes in f32; a bf16 plain forward is widened at dispatch) so
        a bf16 service's LRU entries and denormalize path stay
        float32-exact."""
        t0 = time.perf_counter()
        out, event, n = handle
        if event is not None:
            event.synchronize()
        rows = out.cpu().numpy()
        self._phase_add("forward_s", time.perf_counter() - t0)
        return rows[:n]

    def _forward(self, ids: np.ndarray) -> np.ndarray:
        """One synchronous batched forward -> (B, n_heads) rows."""
        return self.forward_collect(self.forward_dispatch(ids))

    def forward_entries(
            self, entries: Sequence[Tuple[str, np.ndarray]]) -> np.ndarray:
        """Forward a coalesced batch of same-bucket entries -> (N, n_heads)
        normalized rows, inserted into the LRU under each entry's hash.

        This is predict_all's compute kernel, split out so an async server
        can drive it with batches merged from many concurrent clients.
        Entries must share one ids length (one bucket); batches larger
        than max_batch are chunked."""
        hs = [h for h, _ in entries]
        ids = np.stack([i for _, i in entries])
        rows = []
        for i in range(0, len(ids), self.max_batch):
            preds = self._forward(ids[i:i + self.max_batch])
            self._cache_put_many(
                list(zip(hs[i:i + self.max_batch], preds)))
            rows.append(preds)
        return np.concatenate(rows)

    def forward_entries_dispatch(
            self, entries: Sequence[Tuple[str, np.ndarray]]):
        """Async variant of :meth:`forward_entries`: enqueue the forward
        pass and return a handle for :meth:`forward_entries_collect`.
        The batch must fit one forward pass (len(entries) <= max_batch);
        the cache is populated at collect time."""
        if len(entries) > self.max_batch:
            raise ValueError(
                f"async batch of {len(entries)} exceeds "
                f"max_batch={self.max_batch}")
        ids = np.stack([i for _, i in entries])
        return self.forward_dispatch(ids), [h for h, _ in entries]

    def forward_entries_collect(self, handle) -> np.ndarray:
        fwd, hs = handle
        preds = self.forward_collect(fwd)
        self._cache_put_many(list(zip(hs, preds)))
        return preds

    def predict_entries(
            self, entries: Sequence[Tuple[str, np.ndarray]]) -> np.ndarray:
        """Ids-first prediction: ``(struct key, bucket-padded ids)``
        entries -> (N, n_heads) normalized rows, LRU-probed by key first
        (hits skip the forward entirely), misses grouped per bucket and
        forwarded. The synchronous twin of the server's
        :meth:`~repro_torch.core.server.CostModelServer.submit_entry` — the
        entry point a replica drives when the transport already carries
        token ids, so nothing is ever re-tokenized server-side."""
        rows: List[Optional[np.ndarray]] = [None] * len(entries)
        by_len: Dict[int, List[Tuple[int, str, np.ndarray]]] = {}
        pending: Dict[str, List[int]] = {}
        for i, (key, ids) in enumerate(entries):
            if key in pending:             # in-call duplicate
                pending[key].append(i)
                continue
            hit = self.cache_lookup(key)
            if hit is not None:
                rows[i] = hit
                continue
            pending[key] = [i]
            by_len.setdefault(len(ids), []).append((i, key, ids))
        for _, group in sorted(by_len.items()):
            preds = self.forward_entries([(k, ids) for _, k, ids in group])
            for (i, key, _), p in zip(group, preds):
                for j in pending[key]:
                    rows[j] = p
        return np.stack(rows)

    # ------------------------------------------------- real-MLIR front door
    def ingest_text(self, text):
        """Featurize raw MLIR text -> :class:`~repro_torch.ir.frontdoor.
        TextEntry` or a structured :class:`~repro_torch.ir.frontdoor.
        IngestError`; never raises on input.

        Structurally-parsed texts tokenize through the same
        ``graph_tokens`` path as Graph submits and are keyed by
        ``struct_key`` — an ingested program shares LRU entries with
        the identical program built through the Graph API. Unparsable
        (but lexable) texts degrade to the raw token stream under a
        content-hash key. Either way the ids are bucket-padded, so the
        entry drops straight into ``predict_entries`` /
        ``submit_entry``."""
        from repro_torch.ir import frontdoor as FD
        res = FD.ingest(text)
        if isinstance(res, FD.IngestError):
            with self._cache_lock:
                self.ingest_errors += 1
            return res
        t0 = time.perf_counter()
        toks, key = res.tokens, res.key
        if res.graph is not None:
            try:
                toks = TOK.graph_tokens(res.graph, self.mode)
            except Exception:            # tolerate parser edge cases
                toks, key = res.tokens, FD.text_key(res.tokens)
        bucket = self._bucket_len(len(toks))
        ids = self.vocab.encode(toks, bucket)
        oov = self.vocab.oov_rate(toks)
        unk = self.vocab.unk_fraction(ids)
        with self._cache_lock:
            self.full_encodes += 1
            if len(toks) > bucket:
                self.truncations += 1
            self.ingested_texts += 1
            self.ingest_tokens += len(toks)
            self.ingest_oov_tokens += int(round(oov * len(toks)))
        self._phase_add("encode_s", time.perf_counter() - t0)
        if self.drift is not None:     # vocab-drift EWMAs + alarms
            self.drift.note_text(oov, unk)
        return FD.TextEntry(key=key, ids=ids, n_tokens=len(toks),
                            oov_rate=oov, unk_rate=unk,
                            dialects=res.dialects, n_ops=res.n_ops)

    def predict_text(self, text):
        """End-to-end text prediction: lowered MLIR in, denormalized
        predictions for every head out — or a structured IngestError
        (never an exception) when the input defeats ingestion.

        Runs the ids-first ``predict_entries`` path, so the prediction
        LRU, bucketing, and batch ladder behave exactly as for Graph
        queries. A failure of the forward pass itself (a kernel that
        does not build or launch included) comes back as an
        ``IngestError`` at stage ``predict``."""
        from repro_torch.ir import frontdoor as FD
        ent = self.ingest_text(text)
        if isinstance(ent, FD.IngestError):
            return ent
        try:
            raw = self.predict_entries([(ent.key, ent.ids)])
            preds = self.denormalize_rows(raw)
        except Exception as e:
            with self._cache_lock:
                self.ingest_errors += 1
            return FD.IngestError("predict", type(e).__name__,
                                  str(e)[:200])
        return FD.prediction_from(
            ent, {t: float(preds[t][0]) for t in self.heads})

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None,
               buckets: Optional[Sequence[int]] = None) -> int:
        """Build the library of this kind's fused forward (on the card),
        then run every (bucket x ladder-batch) shape once, so no caller
        pays first-request set-up (the build, library load, cuDNN and
        cuBLAS plans, allocator growth). Returns the number of shapes
        run."""
        if self.use_kernel and self._device.type == "cuda":
            from repro_torch.kernels import ops as KOPS
            KOPS.build(self.kind)
        n = 0
        for s in (buckets if buckets is not None else self.buckets):
            for b in (batch_sizes if batch_sizes is not None
                      else self.batch_ladder):
                with torch.inference_mode():
                    self._apply(torch.zeros((b, s), dtype=torch.int32,
                                            device=self._device))
                n += 1
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return n

    def predict_all(self, graphs: Sequence[Graph]) -> Dict[str, np.ndarray]:
        """All targets for every graph from one cached, batched, bucketed
        forward pass. Returns {target: (len(graphs),) denormalized array}.

        Fast path (``fast_encode``, default): the prediction LRU is
        probed by struct key FIRST — cache hits and in-call duplicates
        never tokenize at all — and the remaining misses featurize
        through the ids cache / parent-delta splice / batched
        ``encode_many``. The legacy path (``fast_encode=False``)
        tokenizes and encodes every graph before probing, exactly the
        pre-incremental behavior (the search_fleet baseline)."""
        if not graphs:
            return {t: np.zeros((0,), np.float32) for t in self.heads}
        keys: List[str] = []
        vals: Dict[str, np.ndarray] = {}   # this call's working set: the
        missing: Dict[str, np.ndarray] = {}  # LRU may evict entries mid-call
        if self.fast_encode:
            miss_graphs: Dict[str, Graph] = {}
            for g in graphs:
                h = self.key_of(g)
                keys.append(h)
                if h in vals or h in miss_graphs:
                    continue
                hit = self.cache_lookup(h)
                if hit is not None:
                    vals[h] = hit
                else:
                    miss_graphs[h] = g
            if miss_graphs:
                missing = dict(self.entries_for(
                    list(miss_graphs.values()), list(miss_graphs)))
        else:
            for g in graphs:
                h, ids = self.entry(g)
                keys.append(h)
                if h in vals or h in missing:
                    continue
                hit = self.cache_lookup(h)
                if hit is not None:
                    vals[h] = hit
                else:
                    missing[h] = ids
        if missing:
            # group by bucket length: one forward shape per bucket
            by_len: Dict[int, List[Tuple[str, np.ndarray]]] = {}
            for h, ids in missing.items():
                by_len.setdefault(len(ids), []).append((h, ids))
            for _, group in sorted(by_len.items()):
                preds = self.forward_entries(group)
                for (hh, _), p in zip(group, preds):
                    vals[hh] = p
        raw = np.stack([vals[k] for k in keys])  # (N, n_heads)
        out = self.denormalize_rows(raw)
        if self.drift is not None:     # accuracy sentinel (O(1) sampling)
            self.drift.observe_batch(graphs, out)
        return out

    def resolve_target(self, target: Optional[str]) -> str:
        """Map a requested target onto this service's heads.

        A single-head service answers ``target=None`` with its only head;
        it also answers a *mismatched* name only when its own target name
        is unknown (legacy unnamed construction) — a service that knows
        it predicts latency must not pass its output off as register
        pressure."""
        if target in self.heads:
            return target
        if len(self.heads) == 1 and (
                target is None
                or self._multi is False and self.target is None):
            return self.heads[0]
        if target is None:
            raise ValueError(
                f"multi-target service needs an explicit target; "
                f"one of {list(self.heads)}")
        raise KeyError(
            f"target {target!r} not served; heads={list(self.heads)}")

    def predict_graphs(self, graphs: Sequence[Graph],
                       target: Optional[str] = None) -> np.ndarray:
        """Batched prediction of one target (all targets are computed and
        cached regardless — asking for the others later is free)."""
        return self.predict_all(graphs)[self.resolve_target(target)]

    def predict(self, g: Graph, target: Optional[str] = None) -> float:
        return float(self.predict_graphs([g], target)[0])


# --------------------------------------------------------------- advisors
# The transforms themselves live in the repro_torch.opt rewrite registry;
# re-exported here for existing callers.
from repro_torch.opt.rewrites import (  # noqa: E402  (re-export)
    FuseElementwise, Unroll, fuse_elementwise, unroll_graph)
from repro_torch.opt import search as OPT  # noqa: E402


@dataclass
class FusionAdvisor:
    """One-rule wrapper over the opt search: greedily fuse elementwise
    chains while the model predicts an improvement."""
    service: CostModelService
    target: str = "latency_us"

    def advise(self, g: Graph) -> Tuple[bool, float, float]:
        obj = OPT.Objective(latency_target=self.target,
                            pressure_target=None)
        res = OPT.greedy_search(self.service, g,
                                rules=[FuseElementwise()], objective=obj)
        lat_t = self.service.resolve_target(self.target)
        return (res.improved, float(res.root_preds[lat_t]),
                float(res.best_preds[lat_t]))


@dataclass
class UnrollAdvisor:
    """Single-rule (Unroll) one-expansion search over ONE multi-target
    service: latency and register pressure for every factor come out of
    the same batched forward pass."""
    service: CostModelService
    register_budget: float = 64.0
    latency_target: str = "latency_us"
    pressure_target: str = "register_pressure"

    def advise(self, g: Graph, factors=(1, 2, 4, 8)) -> Dict:
        lat_t = self.service.resolve_target(self.latency_target)
        reg_t = self.service.resolve_target(self.pressure_target)
        if lat_t == reg_t:
            # a single-head service would silently judge register-budget
            # feasibility on latency numbers — refuse instead
            raise ValueError(
                f"UnrollAdvisor needs a service with distinct "
                f"{self.latency_target!r} and {self.pressure_target!r} "
                f"heads; got heads={list(self.service.heads)}")
        rule = Unroll(factors=tuple(factors), max_ops=None)
        obj = OPT.Objective(
            latency_target=self.latency_target,
            pressure_target=self.pressure_target,
            register_budget=self.register_budget).bind(self.service)
        sites = rule.applicable(g)
        cands = [rule.apply(g, s) for s in sites]
        # ONE batched predict_all for the whole factor sweep; scores are
        # per-iteration latency with the budget as a hard constraint
        scores, preds = OPT.cost_graphs(
            self.service, cands, obj, weights=[s.weight for s in sites])
        lat, reg = preds[lat_t], preds[reg_t]
        fs = [int(s.weight) for s in sites]
        best = fs[int(np.argmin(scores))] if np.isfinite(scores).any() \
            else 1
        return {"best_factor": int(best),
                "per_iter_latency": {f: float(lat[i] / f)
                                     for i, f in enumerate(fs)},
                "register_pressure": {f: float(reg[i])
                                      for i, f in enumerate(fs)}}


@dataclass
class RecompileAdvisor:
    """Dynamic-runtime decision: with operator shapes changed at runtime,
    is the already-compiled code still good enough, or is recompilation
    (expensive) worth it? Costing rides the search's batched path."""
    service: CostModelService
    threshold: float = 0.15   # recompile if predicted cost shifts > 15%
    target: str = "latency_us"

    def advise(self, compiled_graph: Graph, new_graph: Graph) -> Dict:
        obj = OPT.Objective(latency_target=self.target,
                            pressure_target=None).bind(self.service)
        _, preds = OPT.cost_graphs(
            self.service, [compiled_graph, new_graph], obj)
        c_old, c_new = preds[obj.lat_t]
        shift = abs(c_new - c_old) / max(abs(c_old), 1e-9)
        return {"recompile": bool(shift > self.threshold),
                "predicted_old": float(c_old),
                "predicted_new": float(c_new),
                "shift": float(shift)}
