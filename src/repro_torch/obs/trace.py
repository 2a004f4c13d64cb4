"""Dependency-free tracing for the serving stack and the trainer.

One sampled request produces a *span tree* that crosses process
boundaries: the client's featurize/fetch spans, the router's per-replica
RPC spans, and the replica's queue-wait/forward spans all share one
``trace_id`` and parent onto each other by ``span_id`` — the ids (not
clocks) stitch the tree together, because ``time.perf_counter`` has a
different origin in every process. Each span therefore carries

* ``t_wall`` — a ``time.time()`` stamp taken once at start, comparable
  across processes on one host, and
* ``dur_s``  — a ``perf_counter`` delta (monotonic, NTP-safe), the
  number every latency aggregate is computed from.

``t_wall`` is also on a torch profiler's timeline: Kineto stamps host
and device events as ``trace_start_ns()`` (wall-clock nanoseconds) plus
an offset, so ``[t_wall, t_wall + dur_s]`` places a span among the
kernels of a trace taken in the same process.

Sampling is *head-based*: the decision is made once per request at the
client (default 1 in ``sample_every``, counter-driven so overhead is a
predictable modulo, not an RNG call) and the resulting
:class:`TraceContext` is what propagates — unsampled requests carry
``None`` everywhere and cost one ``is None`` check per hook. Errors and
sheds are always recorded: :meth:`Tracer.error_span` emits a span even
for unsampled requests, so failure telemetry never depends on the
sampling dice.

The API is deliberately tiny (the serving hot path is the caller):
``Tracer.span`` is a context manager for straight-line code;
``start``/``end`` are the explicit pair for async code (the server's
futures resolve in another thread); ``emit`` records an
already-measured span retroactively (the server worker learns a
request's queue wait only at dispatch time). Finished spans land in a
bounded ring-buffer :class:`TraceRecorder`; exporters drain it, the
replica wire path ``take``s spans per trace id to ship them back to
the client with the response.

The trainer (:class:`repro_torch.core.trainer.TrainEngine`) records
into :func:`default_tracer`, one per process, which samples 1 step in
``TRAIN_SAMPLE_EVERY``. Its spans are never ``record_function`` ranges:
under a CUDA trace Kineto turns such a range into a device-side
annotation that a reader of the trace would count as work on the card.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Ids are a random per-process prefix plus an atomic counter — globally
# unique across the tier's processes without paying an os.urandom
# syscall per span (a traced 16-entry wire batch emits ~35 spans).
_ID_PREFIX = os.urandom(5).hex()
_ID_COUNTER = itertools.count(1)


def _new_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_COUNTER):06x}"


class TraceContext:
    """What propagates: a trace id plus the current parent span id.

    Serializes to a plain ``(trace_id, span_id)`` tuple for the wire
    (picklable, no class dependency on the receiving side)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_wire(self) -> Tuple[str, str]:
        return (self.trace_id, self.span_id)

    @classmethod
    def from_wire(cls, wire) -> Optional["TraceContext"]:
        if not wire:
            return None
        return cls(str(wire[0]), str(wire[1]))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id}, parent={self.span_id!r})"


class Span:
    """One timed operation. ``end()`` is idempotent; tags are free-form
    (numbers/strings) and travel into the JSONL record."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "proc",
                 "t_wall", "dur_s", "status", "tags", "_t0")

    def __init__(self, trace_id: str, name: str, *, proc: str = "main",
                 parent_id: str = "", tags: Optional[Dict] = None):
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.name = name
        self.proc = proc
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        self.dur_s: float = 0.0
        self.status = "ok"
        self.tags: Dict[str, Any] = dict(tags) if tags else {}

    @property
    def ctx(self) -> TraceContext:
        """Context for children of this span (in-process or wire)."""
        return TraceContext(self.trace_id, self.span_id)

    def close(self, status: Optional[str] = None) -> "Span":
        if self._t0 is not None:
            self.dur_s = time.perf_counter() - self._t0
            self._t0 = None
        if status is not None:
            self.status = status
        return self

    def to_record(self) -> Dict[str, Any]:
        return {"trace": self.trace_id, "span": self.span_id,
                "parent": self.parent_id, "name": self.name,
                "proc": self.proc, "t_wall": self.t_wall,
                "dur_s": self.dur_s, "status": self.status,
                "tags": self.tags}


class TraceRecorder:
    """Bounded ring buffer of finished span *records* (plain dicts —
    picklable, JSONL-ready). Thread-safe; oldest spans fall off when
    ``capacity`` is exceeded, so a long-running server cannot grow
    memory on unread telemetry."""

    def __init__(self, capacity: int = 8192):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=int(capacity))
        self.dropped = 0

    def record(self, span: Span) -> None:
        self.record_raw(span.to_record())

    def record_raw(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(rec)

    def extend(self, recs: Iterable[Dict[str, Any]]) -> None:
        """Import span records produced in another process (the replica
        ships its spans back inside the response message)."""
        for rec in recs:
            self.record_raw(rec)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def drain(self) -> List[Dict[str, Any]]:
        """Remove and return everything (the exporter's per-tick pull)."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def take(self, trace_ids) -> List[Dict[str, Any]]:
        """Remove and return the spans of the given traces only — the
        replica-side handoff: spans for a finished wire batch ride the
        response, everything else stays buffered."""
        want = set(trace_ids)
        if not want:
            return []
        keep: List[Dict[str, Any]] = []
        out: List[Dict[str, Any]] = []
        with self._lock:
            for rec in self._spans:
                (out if rec["trace"] in want else keep).append(rec)
            self._spans.clear()
            self._spans.extend(keep)
        return out


class Tracer:
    """Sampling front door + span factory for one process.

    ``sample()`` makes the head-based decision (1 in ``sample_every``
    requests, counter-driven); every other method takes the resulting
    context and is a no-op when it is ``None`` — except
    :meth:`error_span`, which records unconditionally (errors/sheds are
    always-on telemetry)."""

    def __init__(self, *, sample_every: int = 64, proc: str = "main",
                 recorder: Optional[TraceRecorder] = None,
                 capacity: int = 8192):
        self.sample_every = max(1, int(sample_every))
        self.proc = proc
        self.recorder = recorder or TraceRecorder(capacity)
        self._n = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------ sampling
    def sample(self, force: bool = False) -> Optional[TraceContext]:
        """Head decision for a new request: a fresh root context, or
        ``None`` (the request goes untraced)."""
        with self._lock:
            self._n += 1
            hit = force or (self._n % self.sample_every == 0)
        return TraceContext(_new_id()) if hit else None

    # ----------------------------------------------------------- span API
    def start(self, name: str, ctx: Optional[TraceContext],
              tags: Optional[Dict] = None) -> Optional[Span]:
        """Explicit-start span (async code ends it itself via ``end``)."""
        if ctx is None:
            return None
        return Span(ctx.trace_id, name, proc=self.proc,
                    parent_id=ctx.span_id, tags=tags)

    def end(self, span: Optional[Span], status: Optional[str] = None,
            **tags) -> None:
        if span is None:
            return
        if tags:
            span.tags.update(tags)
        self.recorder.record(span.close(status))

    @contextmanager
    def span(self, name: str, ctx: Optional[TraceContext],
             tags: Optional[Dict] = None):
        """Context manager for straight-line code; yields the Span (or
        None when untraced) so callers can add tags / derive child
        contexts. Exceptions mark the span ``err`` and re-raise."""
        sp = self.start(name, ctx, tags)
        try:
            yield sp
        except BaseException:
            self.end(sp, status="err")
            raise
        self.end(sp)

    def emit(self, name: str, ctx: Optional[TraceContext], dur_s: float,
             *, t_wall: Optional[float] = None, status: str = "ok",
             tags: Optional[Dict] = None) -> None:
        """Record a span whose duration was measured elsewhere (the
        server worker learns queue wait / forward wall retroactively)."""
        if ctx is None:
            return
        sp = Span(ctx.trace_id, name, proc=self.proc,
                  parent_id=ctx.span_id, tags=tags)
        sp._t0 = None
        sp.dur_s = float(dur_s)
        if t_wall is not None:
            sp.t_wall = float(t_wall)
        sp.status = status
        self.recorder.record(sp)

    def error_span(self, name: str, ctx: Optional[TraceContext] = None,
                   **tags) -> TraceContext:
        """Always-on failure telemetry: records even when the request
        was not head-sampled (a forced one-span trace is synthesized,
        tagged ``forced``). Returns the context it recorded under."""
        if ctx is None:
            ctx = TraceContext(_new_id())
            tags["forced"] = 1
        self.emit(name, ctx, 0.0, status="err", tags=tags)
        return ctx


TRAIN_SAMPLE_EVERY = 32
_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def default_tracer() -> Tracer:
    """The process's trainer tracer, made on first use: it samples 1 in
    ``TRAIN_SAMPLE_EVERY`` steps, so that a profiled run also times
    steps the profiler does not slow."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Tracer(sample_every=TRAIN_SAMPLE_EVERY,
                              proc="trainer")
        return _DEFAULT


def profiling() -> bool:
    """True while a torch profiler records in this process. Reads torch
    only if something else imported it, so this module imports nothing
    outside the standard library."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


# --------------------------------------------------------- tree assembly
class TraceTree:
    """One trace's spans, indexed for tree walks."""

    def __init__(self, trace_id: str, spans: List[Dict[str, Any]]):
        self.trace_id = trace_id
        self.spans = spans
        by_id = {s["span"]: s for s in spans}
        self.roots = [s for s in spans if not s["parent"]]
        self.orphans = [s for s in spans
                        if s["parent"] and s["parent"] not in by_id]
        self.children: Dict[str, List[Dict[str, Any]]] = {}
        for s in spans:
            if s["parent"] in by_id:
                self.children.setdefault(s["parent"], []).append(s)
        for kids in self.children.values():
            kids.sort(key=lambda s: s["t_wall"])

    @property
    def complete(self) -> bool:
        """Exactly one root and every parent id resolves — the span
        tree reconstructed end to end with no orphan spans."""
        return len(self.roots) == 1 and not self.orphans

    @property
    def procs(self) -> List[str]:
        return sorted({s["proc"] for s in self.spans})

    @property
    def dur_s(self) -> float:
        return self.roots[0]["dur_s"] if self.roots else \
            max((s["dur_s"] for s in self.spans), default=0.0)

    def walk(self):
        """Yield ``(depth, span)`` in tree order from each root."""
        def rec(span, depth):
            yield depth, span
            for kid in self.children.get(span["span"], []):
                yield from rec(kid, depth + 1)
        for root in sorted(self.roots, key=lambda s: s["t_wall"]):
            yield from rec(root, 0)


def assemble(records: Sequence[Dict[str, Any]]) -> Dict[str, TraceTree]:
    """Group span records into per-trace trees (input order preserved
    within a trace; metrics records and junk without a trace id are
    ignored)."""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        tid = rec.get("trace")
        if tid and "span" in rec:
            by_trace.setdefault(tid, []).append(rec)
    return {tid: TraceTree(tid, spans)
            for tid, spans in by_trace.items()}


def completeness(trees: Dict[str, TraceTree]) -> float:
    """Fraction of traces whose span tree reconstructs completely."""
    if not trees:
        return 0.0
    return sum(t.complete for t in trees.values()) / len(trees)


def dump_jsonl(records: Sequence[Dict[str, Any]], path: str) -> int:
    """Append span records to a JSONL file (one ``kind: span`` line
    each) — the offline sibling of the live JsonlExporter."""
    with open(path, "a", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps({"kind": "span", **rec}) + "\n")
    return len(records)
