"""Deterministic fault injection for the replicated serving tier.

Chaos testing only earns trust when a failing run can be replayed, so
every fault here is *scripted*, not sampled: a :class:`FaultPlan` is an
ordered schedule of :class:`FaultEvent`\\ s that fire when the
transport's send-op counter reaches each event's ``at`` — the clock is
the workload itself, which makes a single-driver schedule reproducible
across runs and machines. The only randomness (corruption bytes) comes
from the plan's seeded RNG.

Faults land at the three seams a real fleet fails at:

* **process** — ``kill`` (SIGKILL, a crashed replica) and ``wedge``
  (SIGSTOP: the process stays ``is_alive()`` but stops serving — the
  exact failure the supervisor's heartbeat exists to catch). A replica
  on the card holds a CUDA context: the CUDA driver frees a killed
  process's context, and the supervisor SIGKILLs a stopped one before
  it respawns the slot.
* **message** — ``drop`` / ``delay`` / ``dup`` applied to the next
  request(s) bound for a replica, via :class:`FaultyTransport`, a
  drop-in wrapper over any router transport.
* **shared state** — ``corrupt`` scribbles seeded garbage over a
  occupied :class:`~repro_torch.serving.shared_cache.SharedRowCache` slot's
  row bytes while leaving it marked valid; the cache's crc check must
  turn that into a miss, never a wrong prediction.

``FaultyTransport`` records every applied event in ``log`` so the
chaos bench can assert the schedule actually ran.
"""
from __future__ import annotations

import os
import random
import signal
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serving import transport as T
from repro_torch.serving.shared_cache import _CRC, _DIGEST, SharedRowCache


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.

    ``at``      send-op count that triggers it (0-based: fires before
                the ``at``-th send is delivered)
    ``kind``    kill | wedge | unwedge | drop | delay | dup | corrupt
    ``replica`` target replica slot (process + message kinds)
    ``count``   how many subsequent sends the fault covers (drop/delay)
    ``delay_s`` added latency for ``delay``
    ``key``     struct key whose slot to corrupt (``corrupt``)
    """

    at: int
    kind: str
    replica: int = 0
    count: int = 1
    delay_s: float = 0.0
    key: str = ""


@dataclass
class FaultPlan:
    """Seeded, ordered fault schedule (sorted by ``at``)."""

    events: List[FaultEvent] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: e.at)
        self.rng = random.Random(self.seed)
        self._next = 0

    def due(self, op: int) -> List[FaultEvent]:
        """Events whose trigger point has been reached (each returned
        exactly once)."""
        out = []
        while self._next < len(self.events) and \
                self.events[self._next].at <= op:
            out.append(self.events[self._next])
            self._next += 1
        return out

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self.events)


def corrupt_slot(cache: SharedRowCache, key: str,
                 rng: Optional[random.Random] = None) -> bool:
    """Overwrite ``key``'s row bytes with garbage while keeping the slot
    valid (a torn write frozen mid-flight). Returns False when the key
    isn't resident. The crc trailer is deliberately left stale — a
    subsequent probe must detect the tear and miss."""
    from repro_torch.serving import shared_cache as SC
    rng = rng or random.Random(0)
    dig = SC._digest(key)
    junk = bytes(rng.randrange(256) for _ in range(cache.row_bytes))
    if not cache._acquire():
        return False
    try:
        view = cache._view()
        dig8 = np.frombuffer(dig, np.uint8)
        for s in cache._slots_for(dig):
            slot = view[s]
            if slot[0] and np.array_equal(slot[1:1 + _DIGEST], dig8):
                slot[1 + _DIGEST:cache.slot_bytes - _CRC] = \
                    np.frombuffer(junk, np.uint8)
                return True
    finally:
        cache._lock.release()
    return False


class FaultyTransport:
    """Transport wrapper that applies a :class:`FaultPlan`.

    Duck-types the router transport (``n_replicas`` / ``send`` /
    ``recv`` / ``client_id``); process faults need ``tier`` and slot
    corruption needs ``shared_cache`` (both optional — message faults
    work against any inner transport, including test fakes)."""

    def __init__(self, inner, plan: FaultPlan, *, tier=None,
                 shared_cache: Optional[SharedRowCache] = None):
        self.inner = inner
        self.plan = plan
        self.tier = tier
        self.shared_cache = shared_cache \
            if shared_cache is not None \
            else getattr(tier, "shared_cache", None)
        self.client_id = getattr(inner, "client_id", 0)
        self.ops = 0
        self.log: List[Dict[str, Any]] = []
        self._drop: Dict[int, int] = {}       # replica -> sends to drop
        self._delay: Dict[int, List] = {}     # replica -> [count, s]
        self._dup: Dict[int, int] = {}
        self._lock = threading.Lock()

    @property
    def n_replicas(self) -> int:
        return self.inner.n_replicas

    @property
    def active(self):
        return getattr(self.inner, "active", None)

    # ----------------------------------------------------------- fire side
    def _signal(self, replica: int, sig) -> bool:
        procs = getattr(self.tier, "procs", None)
        if not procs or replica >= len(procs) or procs[replica] is None:
            return False
        pid = procs[replica].pid
        try:
            os.kill(pid, sig)
            return True
        except (ProcessLookupError, OSError):
            return False

    def _apply(self, ev: FaultEvent) -> None:
        ok = True
        if ev.kind == "kill":
            ok = self._signal(ev.replica, signal.SIGKILL)
        elif ev.kind == "wedge":
            ok = self._signal(ev.replica, signal.SIGSTOP)
        elif ev.kind == "unwedge":
            ok = self._signal(ev.replica, signal.SIGCONT)
        elif ev.kind == "drop":
            self._drop[ev.replica] = \
                self._drop.get(ev.replica, 0) + ev.count
        elif ev.kind == "delay":
            self._delay.setdefault(ev.replica, []).append(
                [ev.count, ev.delay_s])
        elif ev.kind == "dup":
            self._dup[ev.replica] = \
                self._dup.get(ev.replica, 0) + ev.count
        elif ev.kind == "corrupt":
            ok = self.shared_cache is not None and corrupt_slot(
                self.shared_cache, ev.key, self.plan.rng)
        else:
            ok = False
        self.log.append({"op": self.ops, "kind": ev.kind,
                         "replica": ev.replica, "applied": bool(ok),
                         "key": ev.key})

    # ------------------------------------------------------- transport duck
    def send(self, replica: int, msg) -> None:
        with self._lock:
            op = self.ops
            self.ops += 1
            for ev in self.plan.due(op):
                self._apply(ev)
            # message faults only touch request traffic; control RPCs
            # (stats/clear) stay reliable so supervision isn't blinded
            is_req = bool(msg) and msg[0] == T.MSG_REQ
            if is_req and self._drop.get(replica, 0) > 0:
                self._drop[replica] -= 1
                self.log.append({"op": op, "kind": "dropped",
                                 "replica": replica, "applied": True,
                                 "key": ""})
                return
            delay_s = 0.0
            dq = self._delay.get(replica)
            if is_req and dq:
                dq[0][0] -= 1
                delay_s = dq[0][1]
                if dq[0][0] <= 0:
                    dq.pop(0)
            dup = is_req and self._dup.get(replica, 0) > 0
            if dup:
                self._dup[replica] -= 1
        if delay_s > 0.0:
            t = threading.Timer(delay_s, self.inner.send,
                                args=(replica, msg))
            t.daemon = True
            t.start()
            self.log.append({"op": op, "kind": "delayed",
                             "replica": replica, "applied": True,
                             "key": ""})
            return
        self.inner.send(replica, msg)
        if dup:
            self.inner.send(replica, msg)
            self.log.append({"op": op, "kind": "duplicated",
                             "replica": replica, "applied": True,
                             "key": ""})

    def recv(self, timeout: float):
        return self.inner.recv(timeout)
