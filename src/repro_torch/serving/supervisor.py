"""Replica lifecycle supervision: respawn, crash-loop budget, scaling.

PR 6 taught the router to route *around* failure (cooldowns, ring
successors, shed); this module closes the loop so the fleet also heals.
A :class:`ReplicaSupervisor` runs a watch thread in the tier's parent
process and

* **detects death and wedge** — ``Process.is_alive()``/exitcode catches
  crashes; a periodic heartbeat RPC (the existing ``MSG_STATS``
  round-trip on a reserved control queue) catches replicas that are
  alive but no longer serving (stuck forward pass, SIGSTOP, deadlocked
  runtime). A wedged replica is SIGKILLed before respawn.
* **respawns into the same ring slot** — replicas are rebuilt from the
  picklable :class:`~repro_torch.serving.transport.ServiceSpec` via
  :meth:`ReplicaTier.spawn`, reusing slot ``i``'s inbox. On the card a
  respawn pays the torch import, CUDA initialisation, the kernel
  library's load (built by the parent before the tier started, so never
  ``nvcc``) and warm-up; ``recovery_s_max`` in :meth:`stats` says what
  that took. Consistent-hash
  ownership never churns: surviving replicas keep their keys (and their
  LRU locality), and requests queued to the dead slot are simply served
  by its successor process after re-warm.
* **meters restarts** — each respawn waits out an escalating backoff
  (``restart_backoff_s * 2^k``), and more than ``max_restarts``
  restarts inside ``restart_window_s`` marks the slot *crash-looping*:
  the supervisor stops feeding it and leaves the router's reroute /
  oracle-fallback ladder to absorb the loss.
* **scales the tier** — a :class:`ScalePolicy` turns the arrival-rate /
  queue-depth / shed signals from heartbeat payloads (plus, optionally,
  a router ``stats()`` source) into a target replica count. Scale-up
  spawns into pre-allocated inbox slots (``start_replicas(...,
  max_replicas=)``) and only publishes the new count — through the
  shared ``active`` value every :class:`ReplicaClient` watches — once
  the newcomer reports warmed, so clients never route to a cold
  replica. Scale-down retires the highest slot first.

After killing a replica the supervisor also runs
:meth:`SharedRowCache.recover` — a holder SIGKILLed mid-publish leaves
the cross-process mutex acquired forever, and every other replica would
otherwise be stuck in bounded-timeout miss mode.

Everything observable lands in :meth:`stats` (restarts, recovery
durations, crash-loops, scale events, heartbeat ages);
``repro_torch.obs.registry.register_supervisor`` snapshots it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.serving import transport as T
from repro_torch.serving.replica import ReplicaTier


@dataclass
class ScalePolicy:
    """Target-count policy over per-replica load signals.

    ``decide`` sees one dict per *responsive* active replica:
    ``arrival_per_s`` (request rate since the last heartbeat),
    ``queue_depth`` and ``shed_delta`` (server-side backpressure), plus
    an optional fleet-level ``router`` dict (a ``ReplicaClient.stats()``
    snapshot: sheds and cooldown counts seen from the client side).
    Scale-up is eager (any shed or deep queue); scale-down waits
    ``settle_ticks`` consecutive quiet evaluations so a bursty search
    loop doesn't flap the fleet."""

    min_replicas: int = 1
    max_replicas: int = 8
    high_queue_depth: float = 32.0
    low_rate_per_s: float = 0.5
    settle_ticks: int = 3
    _quiet: int = field(default=0, repr=False)

    def decide(self, active: int, signals: List[Dict[str, float]],
               router: Optional[Dict[str, Any]] = None) -> int:
        lo = max(1, self.min_replicas)
        hi = max(lo, self.max_replicas)
        if not signals:
            return min(max(active, lo), hi)
        hot = any(s.get("shed_delta", 0) > 0
                  or s.get("queue_depth", 0) > self.high_queue_depth
                  for s in signals)
        if router is not None:
            hot = hot or router.get("shed_count", 0) > 0 \
                or router.get("unhealthy_now", 0) > 0
        if hot:
            self._quiet = 0
            return min(active + 1, hi)
        if all(s.get("arrival_per_s", 0.0) < self.low_rate_per_s
               for s in signals) and active > lo:
            self._quiet += 1
            if self._quiet >= self.settle_ticks:
                self._quiet = 0
                return active - 1
        else:
            self._quiet = 0
        return max(active, lo)


class RestartBudget:
    """Escalating, windowed restart metering for one replica slot."""

    def __init__(self, backoff_s: float = 0.5, max_restarts: int = 5,
                 window_s: float = 60.0, cap_s: float = 30.0):
        self.backoff_s = float(backoff_s)
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self.cap_s = float(cap_s)
        self._stamps: deque = deque()

    def _recent(self, now: float) -> int:
        while self._stamps and now - self._stamps[0] > self.window_s:
            self._stamps.popleft()
        return len(self._stamps)

    def crash_looping(self, now: float) -> bool:
        return self._recent(now) >= self.max_restarts

    def next_delay(self, now: float) -> float:
        """Backoff before the next respawn (0 for the first failure in
        a window); call :meth:`note_restart` when the respawn happens."""
        n = self._recent(now)
        if n == 0:
            return 0.0
        return min(self.backoff_s * (2.0 ** (n - 1)), self.cap_s)

    def note_restart(self, now: float) -> None:
        self._stamps.append(now)


class ReplicaSupervisor:
    """Watches a :class:`ReplicaTier`; respawns, meters, and scales."""

    def __init__(self, tier: ReplicaTier, *,
                 heartbeat_s: float = 0.5,
                 heartbeat_timeout_s: float = 5.0,
                 restart_backoff_s: float = 0.5,
                 max_restarts: int = 5,
                 restart_window_s: float = 60.0,
                 start_timeout_s: float = 180.0,
                 scale: Optional[ScalePolicy] = None,
                 scale_interval_s: float = 2.0,
                 router_stats_fn: Optional[Callable[[], Dict]] = None,
                 recover_shared_lock: bool = True):
        self.tier = tier
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.start_timeout_s = float(start_timeout_s)
        self.scale = scale
        self.scale_interval_s = float(scale_interval_s)
        self.router_stats_fn = router_stats_fn
        self.recover_shared_lock = recover_shared_lock
        n_slots = tier.max_replicas
        self._budget = [RestartBudget(restart_backoff_s, max_restarts,
                                      restart_window_s)
                        for _ in range(n_slots)]
        now = time.monotonic()
        self._last_seen = [now] * n_slots      # heartbeat grace at start
        self._payload: List[Optional[Dict]] = [None] * n_slots
        self._prev_requests: List[Optional[float]] = [None] * n_slots
        self._prev_shed = [0.0] * n_slots
        self._rate: List[float] = [0.0] * n_slots
        self._respawn_at: Dict[int, float] = {}   # slot -> due time
        self._respawning: Dict[int, float] = {}   # slot -> spawn stamp
        self._pending_up: Dict[int, float] = {}   # scale-up warms
        self._failed: set = set()                 # crash-looping slots
        self.restart_log: List[Dict[str, Any]] = []
        self.scale_events: List[Dict[str, Any]] = []
        self.lock_recoveries = 0
        self.inbox_resets = 0
        self.tick_errors = 0
        self.last_tick_error = ""
        self._hb_seq = 0
        self._last_hb = 0.0
        self._last_scale = now
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicaSupervisor":
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._thread = threading.Thread(
            target=self._run, name="replica-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self) -> "ReplicaSupervisor":
        return self.start() if self._thread is None else self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ main loop
    @property
    def active(self) -> int:
        return int(self.tier.active.value) if self.tier.active \
            is not None else self.tier.n_replicas

    def _run(self) -> None:
        tick = max(self.heartbeat_s / 4.0, 0.02)
        while not self._stop.wait(tick):
            now = time.monotonic()
            try:
                self._drain_ready(now)
                self._drain_heartbeats(now)
                if now - self._last_hb >= self.heartbeat_s:
                    self._send_heartbeats()
                    self._last_hb = now
                self._check_replicas(now)
                self._do_due_respawns(now)
                if self.scale is not None and \
                        now - self._last_scale >= self.scale_interval_s:
                    self._evaluate_scale(now)
                    self._last_scale = now
            except Exception as e:
                # the supervisor must outlive anything the fleet throws
                # at it; one bad tick never stops the watch — but the
                # failure is recorded, not swallowed
                self.tick_errors += 1
                self.last_tick_error = repr(e)

    # ------------------------------------------------------------ heartbeat
    def _send_heartbeats(self) -> None:
        cid = self.tier.control_id
        for r in range(self.active):
            if r in self._failed or r in self._respawning:
                continue
            self._hb_seq += 1
            try:
                self.tier.inboxes[r].put((T.MSG_STATS, cid,
                                          self._hb_seq))
            except Exception:
                pass

    def _drain_heartbeats(self, now: float) -> None:
        q = self.tier.control_queue
        while True:
            try:
                msg = q.get_nowait()
            except Exception:
                return
            if not msg or msg[0] != T.MSG_STATS_RES:
                continue
            payload = msg[2]
            r = payload.get("replica_id") if isinstance(payload, dict) \
                else None
            if r is None or not 0 <= r < len(self._last_seen):
                continue
            dt = now - self._last_seen[r]
            self._last_seen[r] = now
            srv = payload.get("server", {})
            reqs = float(srv.get("requests", 0.0))
            prev = self._prev_requests[r]
            if prev is not None and dt > 0:
                self._rate[r] = max(reqs - prev, 0.0) / dt
            self._prev_requests[r] = reqs
            self._payload[r] = payload

    # ------------------------------------------------------------- respawn
    def _check_replicas(self, now: float) -> None:
        for r in range(self.active):
            if r in self._failed or r in self._respawn_at:
                continue
            if r in self._respawning:
                if now - self._respawning[r] > self.start_timeout_s:
                    self._respawning.pop(r, None)
                    self._plan_respawn(r, "start_timeout", now)
                continue
            p = self.tier.procs[r] if r < len(self.tier.procs) else None
            if p is None or not p.is_alive():
                self._plan_respawn(r, "died", now)
            elif now - self._last_seen[r] > self.heartbeat_timeout_s:
                self._plan_respawn(r, "wedged", now)

    def _plan_respawn(self, r: int, reason: str, now: float) -> None:
        budget = self._budget[r]
        if budget.crash_looping(now):
            with self._lock:
                if r not in self._failed:
                    self._failed.add(r)
                    self.restart_log.append(
                        {"replica": r, "reason": "crash_loop",
                         "detected_s": now, "gave_up": True})
            return
        # a wedged-but-alive process is killed outright: SIGTERM can sit
        # undelivered behind a stuck forward pass (or a SIGSTOP)
        p = self.tier.procs[r] if r < len(self.tier.procs) else None
        if p is not None and p.is_alive():
            try:
                p.kill()
                p.join(timeout=5.0)
            except Exception:
                pass
        if self.recover_shared_lock:
            try:
                if self.tier.shared_cache.recover():
                    self.lock_recoveries += 1
            except Exception:
                pass
        # a replica dies holding its inbox's reader lock (it waits in
        # get() with it held) and may leave a half-read frame in the
        # pipe; either would wedge the successor forever. A fresh inbox
        # per respawn generation sidesteps both (see
        # :meth:`ReplicaTier.reset_inbox`).
        try:
            self.tier.reset_inbox(r)
            self.inbox_resets += 1
        except Exception:
            pass
        with self._lock:
            self.restart_log.append({"replica": r, "reason": reason,
                                     "detected_s": now})
        self._respawn_at[r] = now + budget.next_delay(now)

    def _do_due_respawns(self, now: float) -> None:
        for r, due in list(self._respawn_at.items()):
            if now < due:
                continue
            self._respawn_at.pop(r, None)
            self._budget[r].note_restart(now)
            try:
                self.tier.spawn(r)
            except Exception:
                self._plan_respawn(r, "spawn_failed", now)
                continue
            self._respawning[r] = now

    def _drain_ready(self, now: float) -> None:
        q = self.tier.ready
        if q is None:
            return
        while True:
            try:
                msg = q.get_nowait()
            except Exception:
                return
            if not msg:
                continue
            if msg[0] == "ready":
                r = msg[1]
                started = self._respawning.pop(r, None)
                self._last_seen[r] = now
                self._prev_requests[r] = None
                publish = None
                with self._lock:
                    if started is not None:
                        for rec in reversed(self.restart_log):
                            if rec["replica"] == r and \
                                    "recovered_in_s" not in rec and \
                                    not rec.get("gave_up"):
                                rec["recovered_in_s"] = \
                                    now - rec["detected_s"]
                                break
                    if r in self._pending_up:     # scale-up warm done
                        self._pending_up.pop(r, None)
                        publish = r + 1
                if publish is not None:   # outside the lock: publishing
                    #                       re-takes it for the event log
                    self._publish_active(publish, "up")
            elif msg[0] == "error":
                # startup failures carry no replica id on the ready
                # queue; attribute to the oldest in-flight spawn (the
                # start timeout catches any mis-attribution)
                if self._respawning:
                    r = min(self._respawning,
                            key=self._respawning.__getitem__)
                    self._respawning.pop(r, None)
                    self._pending_up.pop(r, None)
                    self._plan_respawn(r, "start_error", now)

    # ------------------------------------------------------------- scaling
    def _publish_active(self, n: int, direction: str) -> None:
        if self.tier.active is None:
            return
        with self._lock:
            self.tier.active.value = n
            self.scale_events.append({"t_s": time.monotonic(),
                                      "direction": direction,
                                      "active": n})

    def _evaluate_scale(self, now: float) -> None:
        if self._pending_up or self._respawn_at or self._respawning:
            return                       # settle before re-deciding
        active = self.active
        signals = []
        for r in range(active):
            if r in self._failed:
                continue
            payload = self._payload[r]
            if payload is None:
                continue
            srv = payload.get("server", {})
            shed = float(srv.get("shed", 0.0))
            signals.append({"arrival_per_s": self._rate[r],
                            "queue_depth": float(
                                srv.get("queue_depth", 0.0)),
                            "shed_delta": shed - self._prev_shed[r]})
            self._prev_shed[r] = shed
        router = None
        if self.router_stats_fn is not None:
            try:
                router = self.router_stats_fn()
            except Exception:
                router = None
        target = self.scale.decide(active, signals, router)
        target = min(target, self.tier.max_replicas)
        if target > active:
            r = active                   # next pre-allocated slot
            if r in self._failed:
                return
            try:
                self.tier.spawn(r)
            except Exception:
                return
            self._respawning[r] = now
            self._pending_up[r] = now    # publish only once warmed
        elif target < active:
            r = active - 1
            self._publish_active(target, "down")
            try:                         # retire the vacated slot
                self.tier.inboxes[r].put((T.MSG_STOP,))
            except Exception:
                pass
            self._last_seen[r] = now

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            log = [dict(rec) for rec in self.restart_log]
            events = [dict(e) for e in self.scale_events]
            failed = sorted(self._failed)
        restarts = [r for r in log if not r.get("gave_up")]
        recovered = [r["recovered_in_s"] for r in restarts
                     if "recovered_in_s" in r]
        return {
            "active": self.active,
            "max_replicas": self.tier.max_replicas,
            "restarts_total": len(restarts),
            "restarts_recovered": len(recovered),
            "recovery_s_max": max(recovered) if recovered else 0.0,
            "crash_loops": len(failed),
            "failed_slots": failed,
            "respawning": sorted(self._respawning),
            "lock_recoveries": self.lock_recoveries,
            "inbox_resets": self.inbox_resets,
            "tick_errors": self.tick_errors,
            "scale_ups": sum(e["direction"] == "up" for e in events),
            "scale_downs": sum(e["direction"] == "down"
                               for e in events),
            "heartbeat_age_s": {
                r: now - self._last_seen[r]
                for r in range(self.active)},
            "restart_log": log,
        }
