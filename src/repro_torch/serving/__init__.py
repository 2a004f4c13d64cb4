"""Replicated serving tier: struct-key-routed multi-process replicas.

Layers (bottom up):

* :mod:`repro_torch.serving.transport` — picklable :class:`ServiceSpec`
  recipe + the ids-first wire format (featurize once client-side).
* :mod:`repro_torch.serving.shared_cache` — :class:`SharedRowCache`, the
  cross-replica second-chance prediction cache in shared memory
  (bounded lock acquire + crc-validated slots, so a dying holder
  degrades to misses instead of wedging or corrupting the fleet).
* :mod:`repro_torch.serving.replica` — :func:`start_replicas` /
  :class:`ReplicaTier`: N spawned processes, each a full
  service+server stack with adaptive flush deadlines; slots are
  respawnable in place.
* :mod:`repro_torch.serving.router` — :class:`ReplicaClient`, the
  service-shaped client: consistent-hash routing on struct keys,
  retry with decorrelated-jitter backoff honoring replica
  ``retry_after_s`` hints, reroute on failure, per-request deadline
  budgets, and an optional analyzer-oracle fallback floor.
* :mod:`repro_torch.serving.supervisor` — :class:`ReplicaSupervisor`:
  heartbeat liveness, in-slot respawn with crash-loop budgets, and
  signal-driven scale up/down.
* :mod:`repro_torch.serving.faults` — seeded :class:`FaultPlan` /
  :class:`FaultyTransport`, the deterministic chaos harness behind
  the ``chaos_serve`` gate.
* :mod:`repro_torch.serving.fleet` — :class:`FleetDriver`, the multi-process
  fleet-client harness the replicated search bench drives.
"""
from repro_torch.serving.faults import FaultEvent, FaultPlan, FaultyTransport
from repro_torch.serving.replica import ReplicaTier, TierHandle, start_replicas
from repro_torch.serving.router import HashRing, QueueTransport, ReplicaClient
from repro_torch.serving.shared_cache import SharedRowCache
from repro_torch.serving.supervisor import (ReplicaSupervisor, RestartBudget,
                                            ScalePolicy)
from repro_torch.serving.transport import ServiceSpec
from repro_torch.serving.fleet import FleetDriver, fleet_worker_main

__all__ = [
    "FaultEvent", "FaultPlan", "FaultyTransport", "FleetDriver",
    "HashRing", "QueueTransport", "ReplicaClient", "ReplicaSupervisor",
    "ReplicaTier", "RestartBudget", "ScalePolicy", "ServiceSpec",
    "SharedRowCache", "TierHandle", "fleet_worker_main",
    "start_replicas",
]
