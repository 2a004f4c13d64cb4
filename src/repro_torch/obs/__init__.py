"""Unified observability for the serving stack.

Three parts, all dependency-free (stdlib + the repo itself):

* :mod:`repro_torch.obs.trace` — head-sampled cross-process request tracing:
  :class:`Tracer` / :class:`TraceRecorder` / :func:`assemble`. Trace
  contexts ride the replicated tier's wire format, so one sampled
  request reconstructs a single client -> router -> replica -> forward
  span tree.
* :mod:`repro_torch.obs.registry` — one typed metrics registry
  (:class:`MetricsRegistry`) with adapters over every existing
  telemetry source (server metrics, service phase/cache stats, router
  health, shared-cache occupancy, drift gauges), snapshotting to one
  versioned schema.
* :mod:`repro_torch.obs.drift` — :class:`DriftMonitor`, the online accuracy
  sentinel: sampled served predictions scored against the analyzer
  oracle in the background, rolling per-target Spearman/MAE plus
  OOV/unk hysteresis alarms.

Egress lives in :mod:`repro_torch.obs.export` (periodic JSONL stream +
opt-in Prometheus text endpoint). The stream has the reference
package's format (``docs/observability.md``); this package has no CLI
over it yet.
"""
from repro_torch.obs.drift import Alarm, DriftMonitor
from repro_torch.obs.export import (JsonlExporter, PromExporter,
                                    to_prometheus)
from repro_torch.obs.registry import (MetricsRegistry, register_drift,
                                      register_router, register_server,
                                      register_service,
                                      register_shared_cache,
                                      register_supervisor, register_tracer)
from repro_torch.obs.trace import (Span, TraceContext, TraceRecorder,
                                   Tracer, TraceTree, assemble,
                                   completeness)

__all__ = [
    "Alarm", "DriftMonitor", "JsonlExporter", "MetricsRegistry",
    "PromExporter", "Span", "TraceContext", "TraceRecorder", "Tracer",
    "TraceTree", "assemble", "completeness", "register_drift",
    "register_router", "register_server", "register_service",
    "register_shared_cache", "register_supervisor", "register_tracer",
    "to_prometheus",
]
