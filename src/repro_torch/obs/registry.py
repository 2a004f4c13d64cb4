"""One typed metrics registry over the stack's fragmented telemetry.

Before this module, every tier spoke its own schema:
``ServerMetrics.snapshot()`` (gateway counters + latency percentiles),
``CostModelService.phase_stats()`` / ``cache_stats()`` (hot-path wall
split, ingest/OOV tallies, LRU rates), ``ReplicaClient.stats()``
(router health + shed counters), ``SharedRowCache.fill()`` (shared-tier
occupancy), and the drift monitor's gauges. The registry adapts them
all into one versioned snapshot::

    {"schema": "repro.obs/v1", "seq": N, "ts": ..., "metrics": {flat}}

where ``metrics`` is a flat ``component.metric`` -> number mapping —
the shape both the JSONL exporter and the Prometheus exposition
consume. Typed instruments (:class:`Counter`/:class:`Gauge`/
:class:`Histogram`) cover metrics that have no existing source;
*sources* (``add_source``) pull the existing snapshot dicts at
``snapshot()`` time, so adapting a tier costs one closure, not a
parallel set of counters to keep in sync. A failing source increments
``obs.source_errors`` instead of breaking the snapshot — telemetry
must never take the serving path down.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

# the stream format's name, the reference package's too, so one reader
# takes the JSONL of either
SCHEMA = "repro.obs/v1"


class Counter:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Bounded reservoir; snapshots as count/mean/p50/p95/p99."""

    __slots__ = ("_lock", "_vals", "count", "total")

    def __init__(self, reservoir: int = 2048):
        self._lock = threading.Lock()
        self._vals: deque = deque(maxlen=int(reservoir))
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self._vals.append(float(v))
            self.count += 1
            self.total += float(v)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._vals)
            count, total = self.count, self.total
        out = {"count": float(count),
               "mean": total / count if count else 0.0}
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            out[name] = vals[min(int(q * len(vals)), len(vals) - 1)] \
                if vals else 0.0
        return out


def _flatten(prefix: str, obj: Any, out: Dict[str, Any]) -> None:
    """Nested snapshot dicts -> flat dotted keys; numbers and bools
    only (strings and arbitrary objects are dropped — the snapshot is
    a metrics payload, not a log line)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}.{i}", v, out)
    elif isinstance(obj, bool):
        out[prefix] = int(obj)
    elif isinstance(obj, (int, float)):
        out[prefix] = obj


class MetricsRegistry:
    """Get-or-create typed instruments + pull-through sources."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._sources: List[tuple] = []          # (prefix, fn)
        self._seq = 0
        self.source_errors = 0

    # ------------------------------------------------------- instruments
    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, reservoir: int = 2048) -> Histogram:
        with self._lock:
            return self._hists.setdefault(name, Histogram(reservoir))

    def add_source(self, prefix: str,
                   fn: Callable[[], Dict[str, Any]]) -> None:
        """Register a snapshot-source callable; its dict is flattened
        under ``prefix.`` at every :meth:`snapshot`."""
        with self._lock:
            self._sources = [(p, f) for p, f in self._sources
                             if p != prefix] + [(prefix, fn)]

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            self._seq += 1
            seq = self._seq
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())
            sources = list(self._sources)
        metrics: Dict[str, Any] = {}
        for name, c in counters:
            metrics[name] = c.value
        for name, g in gauges:
            metrics[name] = g.value
        for name, h in hists:
            for k, v in h.summary().items():
                metrics[f"{name}.{k}"] = v
        for prefix, fn in sources:
            try:
                _flatten(prefix, fn(), metrics)
            except Exception:
                self.source_errors += 1
        metrics["obs.source_errors"] = self.source_errors
        return {"schema": SCHEMA, "seq": seq, "ts": time.time(),
                "metrics": metrics}


# ------------------------------------------------------------- adapters
def register_server(reg: MetricsRegistry, server,
                    prefix: str = "server") -> None:
    """Adapt a CostModelServer: its ``metrics_snapshot()`` already
    merges the wrapped service's ``phase_*`` split and gauges."""
    reg.add_source(prefix, server.metrics_snapshot)


def register_service(reg: MetricsRegistry, svc,
                     prefix: str = "service") -> None:
    """Adapt a CostModelService (or a ReplicaClient's featurizer):
    phase split + ingest/OOV tallies + both LRU caches."""
    reg.add_source(
        prefix, lambda: {**svc.phase_stats(), "cache": svc.cache_stats()})


def register_router(reg: MetricsRegistry, client,
                    prefix: str = "router") -> None:
    """Adapt a ReplicaClient: shed count, local-cache rates, and the
    full per-replica health detail (consecutive_failures, remaining
    cooldown, per-kind failure counts)."""
    reg.add_source(prefix, client.stats)


def register_shared_cache(reg: MetricsRegistry, cache,
                          prefix: str = "shared_cache") -> None:
    reg.add_source(prefix, lambda: {"fill": cache.fill(),
                                    "n_slots": cache.n_slots,
                                    "lock_timeouts": cache.lock_timeouts,
                                    "torn_drops": cache.torn_drops})


def register_supervisor(reg: MetricsRegistry, sup,
                        prefix: str = "supervisor") -> None:
    """Adapt a ReplicaSupervisor: restart/recovery counters, crash-loop
    slots, scale events, heartbeat ages. The restart log itself is
    narrative (strings), so only its numeric fields survive flattening
    — the counters are the gated surface."""
    def _stats():
        s = sup.stats()
        s.pop("restart_log", None)     # per-event detail stays in-proc
        return s
    reg.add_source(prefix, _stats)


def register_drift(reg: MetricsRegistry, monitor,
                   prefix: str = "drift") -> None:
    reg.add_source(prefix, monitor.gauges)


def register_tracer(reg: MetricsRegistry, tracer,
                    prefix: str = "trace") -> None:
    """Tracing's own health: buffered/dropped span counts and the
    sampling rate actually in force."""
    reg.add_source(prefix, lambda: {
        "buffered_spans": len(tracer.recorder),
        "dropped_spans": tracer.recorder.dropped,
        "sample_every": tracer.sample_every})
