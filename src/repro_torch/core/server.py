"""CostModelServer — async micro-batching gateway over CostModelService.

A DL-compiler doing fusion/unroll/recompile search issues thousands of
concurrent cost queries. The synchronous service answers one caller at a
time: concurrent clients serialize on whole forward passes. This server
turns that into a coalescing pipeline:

* **per-bucket queues** — every request is encoded in the caller's
  thread into a (content-hash, bucket-padded ids) batch entry and routed
  onto the queue for its sequence bucket, so one flush always yields a
  shape-homogeneous batch (one forward shape per bucket).
* **micro-batch flush policy** — a bucket flushes when it holds
  ``max_batch`` entries (full-batch path) or when its oldest entry has
  waited ``flush_us`` microseconds (deadline path, default 2 ms). Both
  paths run the same ``service.forward_entries`` kernel, and the
  service pads batches up to a fixed power-of-two ladder, so results are
  bit-identical to direct per-request ``predict_all`` calls no matter
  how requests were packed.
* **in-flight dedup** — concurrent requests for the same canonical
  ``Graph.struct_key()`` (so also SSA-renumbered / re-scheduled
  spellings of one program, e.g. the same candidate derived through two
  rewrite orders by concurrent ``repro_torch.opt`` searches) coalesce onto one
  compute; the LRU answers repeats for free and cache hits resolve at
  submit time without touching a queue.
* **backpressure** — the total number of outstanding requests (queued
  entries plus waiters coalesced onto in-flight keys) is bounded by
  ``max_queue``; beyond it ``submit`` sheds load by raising
  :class:`ServerOverloadedError` instead of growing memory without
  limit under a compile-search storm.
* **warm-up** — ``start(warmup=True)`` builds the kernel library and
  runs every (bucket x ladder-batch) shape once, so no client ever pays
  first-call set-up latency.
* **streaming metrics** — queue depth, batch occupancy, request
  latency percentiles (p50/p95/p99), cache hit rate, shed count.

The server duck-types the service's prediction API (``predict_all``,
``predict_graphs``, ``predict``, ``resolve_target``, ``heads``), so any
caller of the service drives it unchanged.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.service import CostModelService
from repro_torch.ir.graph import Graph


class ServerOverloadedError(RuntimeError):
    """Load shed: the bounded request queue is full. Back off and retry.

    ``retry_after_s`` is the server's backoff hint: roughly the time it
    expects to need to drain the current backlog. Clients (the
    replicated serving tier's router) should sleep at least this long
    before retrying, and shed the request themselves after a bounded
    number of attempts."""

    def __init__(self, msg: str, retry_after_s: float = 0.01):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


@dataclass
class _Request:
    key: str
    ids: np.ndarray
    t_submit: float
    future: "Future[np.ndarray]"
    # optional TraceContext (duck-typed: .trace_id/.span_id) — carried so
    # the worker can emit queue-wait/forward spans retroactively for
    # sampled requests; None for the untraced 1-1/sample_every majority
    trace: Any = None


class ServerMetrics:
    """Streaming counters + a bounded latency reservoir.

    One lock (shared with the server's queue — the server builds its
    queue Condition on ``self._lock``) guards every field, but the
    submit hot path never takes it twice: ``note_request`` is called by
    submit while it already holds the queue lock, while the worker-side
    methods (count, observe_latencies) and snapshot() acquire it
    themselves."""

    def __init__(self, reservoir: int = 8192):
        self._lock = threading.Lock()
        # optional callable returning the wrapped service's phase_stats()
        # dict; snapshot() merges it under ``phase_*`` keys so the
        # hash/encode/forward wall-clock split (and the truncation
        # counter) travels with every metrics payload the benches emit
        self.phase_source = None
        # gauges the server updates out-of-band (adaptive flush deadline)
        self.gauges: Dict[str, float] = {}
        # submit-side (bumped via note_request under the shared lock)
        self.requests = 0
        self.cache_hits = 0       # resolved at submit, no queue/forward
        self.coalesced = 0        # merged onto an identical in-flight key
        self.shed = 0             # rejected by backpressure
        self.max_queue_depth = 0
        # worker-side (guarded by self._lock)
        self.batches = 0          # forward passes flushed
        self.batched_entries = 0  # unique entries across those batches
        self.deadline_flushes = 0
        self.full_flushes = 0
        self.stagnant_flushes = 0  # arrivals stalled; flushed early
        self.pipeline_flushes = 0  # dispatched behind an in-flight batch
        self._lat_us = deque(maxlen=reservoir)

    def observe_latencies(self, us: Sequence[float]) -> None:
        with self._lock:
            self._lat_us.extend(us)

    def count(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def note_request(self, cache_hit: bool = False, shed: bool = False,
                     coalesced: bool = False, queue_depth: int = 0) -> None:
        """Submit-side bumps; caller holds the server queue lock."""
        self.requests += 1
        if cache_hit:
            self.cache_hits += 1
        if shed:
            self.shed += 1
        if coalesced:
            self.coalesced += 1
        if queue_depth > self.max_queue_depth:
            self.max_queue_depth = queue_depth

    def snapshot(self, queue_depth: int = 0) -> Dict[str, float]:
        phase = self.phase_source() if self.phase_source else None
        with self._lock:
            hits, total = self.cache_hits, self.requests
            lat = np.asarray(self._lat_us, np.float64)
            occ = (self.batched_entries / self.batches
                   if self.batches else 0.0)
            gauges = dict(self.gauges)
            out = {
                "requests": total,
                "cache_hits": hits,
                "cache_hit_rate": hits / total if total else 0.0,
                "coalesced": self.coalesced,
                "shed": self.shed,
                "batches": self.batches,
                "batch_occupancy": occ,
                "deadline_flushes": self.deadline_flushes,
                "full_flushes": self.full_flushes,
                "stagnant_flushes": self.stagnant_flushes,
                "pipeline_flushes": self.pipeline_flushes,
                "queue_depth": queue_depth,
                "max_queue_depth": self.max_queue_depth,
            }
        for name, q in [("p50", 50), ("p95", 95), ("p99", 99)]:
            out[f"latency_{name}_us"] = (
                float(np.percentile(lat, q)) if lat.size else 0.0)
        out.update(gauges)
        if phase is not None:
            for k, v in phase.items():
                out[f"phase_{k}"] = v
        return out


class CostModelServer:
    """Async gateway: many clients submit, one worker flushes coalesced
    per-bucket batches through the wrapped service.

    ``submit`` returns a Future resolving to the raw (n_heads,)
    normalized row; the blocking facade (``predict_all`` etc.)
    denormalizes through the service, exactly like direct calls.
    """

    def __init__(self, service: CostModelService, *,
                 max_batch: Optional[int] = None,
                 flush_us: float = 2000.0,
                 min_batch: Optional[int] = None,
                 max_queue: int = 4096,
                 metrics_reservoir: int = 8192,
                 adaptive_flush: bool = False,
                 flush_us_min: Optional[float] = None,
                 adaptive_k: float = 8.0,
                 tracer=None):
        self.service = service
        # optional repro_torch.obs.trace.Tracer; every hook is None-guarded so
        # the untraced server keeps zero obs imports and zero overhead
        self.tracer = tracer
        self.max_batch = min(max_batch or service.max_batch,
                             service.max_batch)
        self.flush_us = float(flush_us)
        # Adaptive flush deadline: scale the linger with the observed
        # arrival rate. Lingering only pays while more requests are
        # actually arriving — a fixed deadline makes slow-arrival (cold)
        # traffic wait the full budget for batches that never fill. With
        # adaptive_flush on, the effective deadline is
        #   clamp(adaptive_k * EWMA(inter-arrival), flush_us_min, flush_us)
        # and collapses straight to flush_us_min once arrivals are slower
        # than the budget itself (waiting cannot fill a batch, so flush
        # now). flush_us stays the upper bound / latency budget.
        self.adaptive_flush = bool(adaptive_flush)
        self.flush_us_min = (max(self.flush_us / 16.0, 25.0)
                             if flush_us_min is None else float(flush_us_min))
        self.adaptive_k = float(adaptive_k)
        self._arrival_ewma_us: Optional[float] = None
        self._last_arrival: Optional[float] = None
        # Below min_batch the worker prefers letting a queue build while
        # another batch computes (throughput knob); the flush deadline
        # and the stall detector still bound how long entries can wait,
        # so low-concurrency traffic never stalls on an unfillable gate.
        self.min_batch = (max(1, self.max_batch // 4)
                          if min_batch is None else max(1, min_batch))
        self.max_queue = int(max_queue)
        self.metrics = ServerMetrics(metrics_reservoir)
        self.metrics.phase_source = getattr(service, "phase_stats", None)
        self._queues: Dict[int, deque] = {
            b: deque() for b in service.buckets}
        self._n_queued = 0                      # entries across all queues
        self._n_pending = 0                     # + coalesced dup waiters
        self._inflight: Dict[str, List[_Request]] = {}  # key -> dup waiters
        # one lock for queues AND metrics: note_request piggybacks on the
        # submit path's queue lock, and snapshot() sees consistent counts
        self._lock = self.metrics._lock
        self._work = threading.Condition(self._lock)
        self._running = False
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self, warmup: bool = True) -> "CostModelServer":
        """Start the flush worker; optionally warm every (bucket x
        ladder-batch) shape first so no request ever blocks on set-up."""
        if self._running:
            return self
        if warmup:
            # a full flush of max_batch entries pads UP to the next
            # ladder entry, so warm through that size, not just max_batch
            cap = self.service._ladder_batch(self.max_batch)
            self.service.warmup(
                batch_sizes=[b for b in self.service.batch_ladder
                             if b <= cap])
        self._running = True
        self._worker = threading.Thread(
            target=self._run, name="costmodel-server", daemon=True)
        self._worker.start()
        return self

    def stop(self) -> None:
        with self._work:
            self._running = False
            self._work.notify_all()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        with self._work:
            for reqs in self._inflight.values():
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(
                            RuntimeError("server stopped"))
            self._inflight.clear()
            for q in self._queues.values():
                q.clear()
            self._n_queued = 0
            self._n_pending = 0

    def __enter__(self) -> "CostModelServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- submit
    def submit(self, g: Graph, trace=None) -> "Future[np.ndarray]":
        """Enqueue one graph; resolves to its (n_heads,) normalized row.

        Fast paths: an LRU hit resolves immediately without queueing —
        probed by struct key BEFORE any tokenization, so a hit never
        lexes the graph at all (``fast_encode`` services; the legacy
        path encodes first, as before); a request whose content hash is
        already in flight coalesces onto the pending compute. A full
        queue sheds the request instead."""
        if not self._running:
            raise RuntimeError("server not started (call start())")
        if self.service.fast_encode:
            key = self.service.key_of(g)
            hit = self.service.cache_lookup(key)
            ids = None if hit is not None else self.service.ids_for(g, key)
        else:
            key, ids = self.service.entry(g)
            hit = self.service.cache_lookup(key)
            if hit is not None:
                ids = None
        return self._submit_resolved(key, ids, hit, trace=trace)

    def submit_entry(self, key: str, ids: np.ndarray, *,
                     probe: bool = True, trace=None
                     ) -> "Future[np.ndarray]":
        """Ids-first submit: enqueue an already-featurized ``(struct
        key, bucket-padded ids)`` entry, skipping tokenization entirely.

        This is the replicated serving tier's transport seam: a remote
        router featurizes once client-side and ships (token ids +
        struct key); the replica's key-first LRU probe, in-flight
        dedup, micro-batching and backpressure all behave exactly as
        for graph submits. ``len(ids)`` must be one of the service's
        buckets (routers reuse the service's own featurizer, so it
        always is). ``probe=False`` skips the LRU probe — for callers
        (the replica loop) that already probed this key themselves, so
        the miss isn't double-counted or double-looked-up."""
        if not self._running:
            raise RuntimeError("server not started (call start())")
        hit = self.service.cache_lookup(key) if probe else None
        return self._submit_resolved(key, None if hit is not None else ids,
                                     hit, trace=trace)

    def _submit_resolved(self, key: str, ids: Optional[np.ndarray],
                         hit: Optional[np.ndarray], trace=None
                         ) -> "Future[np.ndarray]":
        now = time.monotonic()
        tr = self.tracer
        if hit is not None:
            with self._work:
                self._note_arrival_locked(now)
                self.metrics.note_request(cache_hit=True)
            if tr is not None and trace is not None:
                tr.emit("server.cache_hit", trace, 0.0)
            fut: "Future[np.ndarray]" = Future()
            fut.set_result(hit)
            return fut
        req = _Request(key, ids, now, Future(), trace)
        with self._work:
            if not self._running:      # lost a race with stop()
                raise RuntimeError("server not started (call start())")
            self._note_arrival_locked(now)
            if self._n_pending >= self.max_queue:
                # bound covers coalesced waiters too: a storm on one hot
                # in-flight key must not grow memory without limit
                self.metrics.note_request(shed=True)
                retry_s = self._overload_retry_s_locked()
                if tr is not None:     # sheds are always-on telemetry
                    tr.error_span("server.shed", trace,
                                  retry_after_s=retry_s,
                                  pending=self._n_pending)
                raise ServerOverloadedError(
                    f"queue full ({self._n_pending}/{self.max_queue} "
                    f"outstanding requests); shedding load",
                    retry_after_s=retry_s)
            self._n_pending += 1
            waiters = self._inflight.get(key)
            if waiters is not None:
                waiters.append(req)
                self.metrics.note_request(coalesced=True,
                                          queue_depth=self._n_queued)
            else:
                self._inflight[key] = [req]
                self._queues[len(ids)].append(req)
                self._n_queued += 1
                self.metrics.note_request(queue_depth=self._n_queued)
                self._work.notify()
        return req.future

    def queue_depth(self) -> int:
        with self._lock:
            return self._n_queued

    def metrics_snapshot(self) -> Dict[str, float]:
        """snapshot() with the live queue depth — the one-call metrics
        payload the benches and the replicated tier's stats RPC emit
        (includes the service's ``phase_*`` split and, when adaptive
        flush is on, the current effective deadline gauge)."""
        return self.metrics.snapshot(self.queue_depth())

    # ------------------------------------------------------ adaptive flush
    def _note_arrival_locked(self, now: float) -> None:
        """EWMA of request inter-arrival time; drives the adaptive
        flush deadline. Caller holds the queue lock."""
        last = self._last_arrival
        self._last_arrival = now
        if last is None:
            return
        gap_us = (now - last) * 1e6
        # clamp single gaps at 8 budgets: one long idle pause must not
        # poison the estimate for minutes of subsequent traffic
        gap_us = min(gap_us, 8 * self.flush_us)
        ewma = self._arrival_ewma_us
        self._arrival_ewma_us = gap_us if ewma is None \
            else 0.8 * ewma + 0.2 * gap_us

    def _effective_flush_us_locked(self) -> float:
        """Deadline actually applied by the flush policy this moment."""
        if not self.adaptive_flush:
            return self.flush_us
        ewma = self._arrival_ewma_us
        if ewma is None:
            eff = self.flush_us
        elif ewma >= self.flush_us:
            # arrivals slower than the whole budget: lingering cannot
            # fill a batch, so flush (nearly) immediately — this is the
            # cold-pass fix: a lone search thread's next candidate burst
            # is milliseconds away, not within the deadline
            eff = self.flush_us_min
        else:
            eff = min(max(self.adaptive_k * ewma, self.flush_us_min),
                      self.flush_us)
        self.metrics.gauges["flush_us_effective"] = eff
        return eff

    def _overload_retry_s_locked(self) -> float:
        """Backoff hint for shed requests: about the time to drain the
        backlog at one max_batch per deadline."""
        batches = max(1.0, self._n_pending / max(1, self.max_batch))
        eff_s = max(self._effective_flush_us_locked(), 100.0) / 1e6
        return min(max(batches * eff_s, 1e-3), 0.25)

    # -------------------------------------------------------------- worker
    def _pick_batch_locked(self) -> Tuple[Optional[List[_Request]],
                                          Optional[float], Optional[str]]:
        """Choose a bucket to flush. Returns (batch, wait_s, path).

        Full path: any single bucket holding max_batch entries flushes
        now; so does the largest bucket whenever the TOTAL backlog
        reaches max_batch — with the worker saturated there is nothing
        to gain by lingering, and draining the deepest queue maximizes
        batch occupancy. Deadline path: once any entry has waited
        flush_us, the deepest *expired* bucket flushes (deepest for
        occupancy; expiry-gated so light-traffic buckets still drain
        within a bounded number of cycles). Otherwise the worker sleeps
        until the nearest deadline."""
        now = time.monotonic()
        deadline_s = self._effective_flush_us_locked() / 1e6
        oldest: Optional[float] = None
        largest: Optional[int] = None
        expired: Optional[int] = None
        for b, q in self._queues.items():
            if len(q) >= self.max_batch:
                return self._drain_locked(b), None, "full"
            if q:
                if largest is None or len(q) > len(self._queues[largest]):
                    largest = b
                if oldest is None or q[0].t_submit < oldest:
                    oldest = q[0].t_submit
                if now >= q[0].t_submit + deadline_s and (
                        expired is None
                        or len(q) > len(self._queues[expired])):
                    expired = b
        if oldest is None:
            return None, None, None          # idle: wait for a submit
        if self._n_queued >= self.max_batch:
            return self._drain_locked(largest), None, "full"
        if expired is not None:
            return self._drain_locked(expired), None, "deadline"
        return None, oldest + deadline_s - now, None

    def _drain_locked(self, bucket: int) -> List[_Request]:
        q = self._queues[bucket]
        batch = [q.popleft() for _ in range(min(len(q), self.max_batch))]
        self._n_queued -= len(batch)
        return batch

    def _largest_locked(self) -> int:
        return max((b for b, q in self._queues.items() if q),
                   key=lambda b: len(self._queues[b]))

    def _pipeline_batch_locked(self) -> Tuple[Optional[List[_Request]],
                                              Optional[str]]:
        """Next batch while another is already computing. Only a queue
        that reached min_batch is worth dispatching early (it rides
        behind the in-flight pass either way; smaller ones keep building
        until the pipeline drains and the deadline logic takes over).
        Any head older than 4x the flush deadline preempts regardless
        (no bucket starves behind a busy one)."""
        stale = time.monotonic() - \
            4 * self._effective_flush_us_locked() / 1e6
        for b, q in self._queues.items():
            if q and q[0].t_submit <= stale:
                return self._drain_locked(b), "deadline"
        if self._n_queued == 0:
            return None, None
        largest = self._largest_locked()
        if len(self._queues[largest]) < self.min_batch:
            return None, None
        return self._drain_locked(largest), "pipeline"

    def _run(self) -> None:
        # Two overlapping phases: dispatch batch k+1 (CUDA launches are
        # async), then block collecting batch k's results, then resolve
        # k's futures while k+1 computes. The wait for the device and
        # the GIL-bound resolution/submission python run concurrently,
        # and the next batch accumulates for a full compute period —
        # occupancy grows with load, with no tuned linger in the loop.
        #
        # Lingering (only when nothing is in flight): the full deadline
        # only pays off while new requests keep arriving. For a tiny
        # backlog, waiting in sub-deadline quanta lets the worker notice
        # a stalled arrival stream (a lone client, or the tail of a
        # burst) and flush early. Deeper backlogs keep the full linger:
        # under load a short no-arrival window is just GIL scheduling
        # noise, and flushing on it collapses batch occupancy.
        quantum = max(self.flush_us / 8e6, 50e-6)
        stagnant_max = max(1, self.max_batch // 4)
        inflight: Optional[Tuple[List[_Request], Any]] = None
        while True:
            with self._work:
                if not self._running:
                    return               # stop() fails leftover futures
                if inflight is not None:
                    batch, path = self._pipeline_batch_locked()
                else:
                    batch, wait_s, path = self._pick_batch_locked()
                    if batch is None and wait_s is None:
                        self._work.wait()        # idle: no queued work
                        continue
                    if batch is None:
                        depth0 = self._n_queued
                        if depth0 > stagnant_max:
                            self._work.wait(timeout=wait_s)
                            continue
                        self._work.wait(timeout=min(wait_s, quantum))
                        if not self._running:
                            return
                        if self._n_queued == depth0:
                            batch, path = (
                                self._drain_locked(self._largest_locked()),
                                "stagnant")
                        else:
                            continue
            if batch is not None:
                handle = self._dispatch(batch, path)
                prev, inflight = inflight, (batch, handle)
                if prev is not None:
                    self._collect_resolve(prev)
            elif inflight is not None:   # queue empty: drain the pipeline
                self._collect_resolve(inflight)
                inflight = None

    def _dispatch(self, batch: List[_Request], path: str):
        t_disp = time.monotonic()
        entries = [(r.key, r.ids) for r in batch]
        try:
            handle = self.service.forward_entries_dispatch(entries)
        except Exception as e:          # resolve waiters, don't kill worker
            return ("err", e, t_disp, path)
        self.metrics.count(f"{path}_flushes")
        self.metrics.count("batches")
        self.metrics.count("batched_entries", len(batch))
        return ("ok", handle, t_disp, path)

    def _collect_resolve(self, item: Tuple[List[_Request], Any]) -> None:
        batch, (status, payload, t_disp, path) = item
        if status == "ok":
            try:
                rows = self.service.forward_entries_collect(payload)
                err = None
            except Exception as e:
                rows, err = None, e
        else:
            rows, err = None, payload
        with self._work:                # one lock round for the whole batch
            waiters = [self._inflight.pop(r.key, [r]) for r in batch]
            self._n_pending -= sum(len(ws) for ws in waiters)
        now = time.monotonic()
        tr = self.tracer
        lats = []
        for i, ws in enumerate(waiters):
            for j, w in enumerate(ws):
                if tr is not None and w.trace is not None:
                    # retroactive spans: the request's queue wait and the
                    # batch it rode are only known here. Emitted BEFORE
                    # set_result so a callback on the future (the replica
                    # loop shipping spans back) already sees them.
                    tr.emit("server.queue", w.trace,
                            max(t_disp - w.t_submit, 0.0),
                            tags={"coalesced": int(j > 0)})
                    tr.emit("server.forward", w.trace,
                            max(now - t_disp, 0.0),
                            status="ok" if err is None else "err",
                            tags={"batch_size": len(batch), "path": path})
                if err is not None:
                    w.future.set_exception(err)
                else:
                    lats.append((now - w.t_submit) * 1e6)
                    w.future.set_result(rows[i])
        if lats:
            self.metrics.observe_latencies(lats)

    # ----------------------------------------- service-compatible facade
    @property
    def heads(self) -> Tuple[str, ...]:
        return self.service.heads

    def resolve_target(self, target: Optional[str]) -> str:
        return self.service.resolve_target(target)

    def predict_all(self, graphs: Sequence[Graph],
                    timeout: Optional[float] = 60.0
                    ) -> Dict[str, np.ndarray]:
        """Blocking facade over submit(): same contract (and bit-identical
        results) as ``service.predict_all``, but concurrent callers'
        graphs coalesce into shared forward passes."""
        if not graphs:
            return {t: np.zeros((0,), np.float32) for t in self.heads}
        tr = self.tracer
        root = None
        if tr is not None:
            ctx = tr.sample()          # head decision: 1 in sample_every
            root = tr.start("client.predict_all", ctx,
                            tags={"n_graphs": len(graphs)})
        sub = root.ctx if root is not None else None
        try:
            if len(graphs) == 1:       # compiler hot path: one candidate
                raw = self.submit(graphs[0], trace=sub).result(
                    timeout=timeout)[None]
            else:
                futs = [self.submit(g, trace=sub) for g in graphs]
                raw = np.stack([f.result(timeout=timeout) for f in futs])
        except BaseException:
            if tr is not None:
                tr.end(root, status="err")
            raise
        if tr is not None:
            tr.end(root)
        out = self.service.denormalize_rows(raw)
        drift = getattr(self.service, "drift", None)
        if drift is not None:
            drift.observe_batch(graphs, out)
        return out

    def predict_graphs(self, graphs: Sequence[Graph],
                       target: Optional[str] = None) -> np.ndarray:
        return self.predict_all(graphs)[self.resolve_target(target)]

    def predict(self, g: Graph, target: Optional[str] = None) -> float:
        return float(self.predict_graphs([g], target)[0])

    def predict_text(self, text, timeout: Optional[float] = 60.0):
        """Async-gateway twin of ``service.predict_text``: the text is
        featurized in the caller's thread (ingest + encode + OOV
        accounting on the wrapped service), then rides ``submit_entry``
        — key-first LRU probe, in-flight dedup, micro-batching, and
        backpressure all apply. Returns a TextPrediction or a
        structured IngestError; ingestion never raises (server-side
        failures like overload/timeout surface as ``predict``-stage
        errors)."""
        from repro_torch.ir import frontdoor as FD
        ent = self.service.ingest_text(text)
        if isinstance(ent, FD.IngestError):
            return ent
        try:
            row = self.submit_entry(ent.key, ent.ids).result(
                timeout=timeout)
        except Exception as e:
            return FD.IngestError("predict", type(e).__name__,
                                  str(e)[:200])
        preds = self.service.denormalize_rows(row[None])
        return FD.prediction_from(
            ent, {t: float(preds[t][0]) for t in self.heads})
