"""Struct-key router client for the replicated serving tier.

A :class:`ReplicaClient` looks exactly like a
:class:`~repro_torch.core.service.CostModelService` to callers
(``heads`` / ``resolve_target`` / ``predict_all`` / ``predict_graphs`` /
``predict``) but fans misses out across N replica processes:

* **Featurize once, client-side.** The client owns a *featurizer*
  service built from the same
  :class:`~repro_torch.serving.transport.ServiceSpec`, on the CPU
  (struct keys, incremental token ids, and — optionally — a local
  prediction LRU). It never runs a forward pass; requests ship
  ``(struct_key, ids)`` so replicas skip re-tokenization entirely.
* **Consistent-hash routing.** ``HashRing`` maps each struct key to a
  stable replica (virtual nodes keep the split even), so repeat queries
  for a graph family land on the replica whose LRU already holds them.
  The ring's successor order doubles as the reroute fallback chain.
* **Retry / backoff / shed.** Overload replies carry the replica's own
  ``retry_after_s`` hint; the client backs off with *decorrelated
  jitter* (so N fleet workers retrying the same recovering replica
  don't thundering-herd it in lockstep), reroutes around replicas in
  cooldown or timing out, and sheds with
  :class:`~repro_torch.core.server.ServerOverloadedError` once
  ``max_retries`` rounds exhaust. Per-replica health counters
  (sent/ok/overload/err/timeout/reroutes, consecutive failures,
  cooldown window) feed both routing and ``stats()``.
* **Deadline budgets + oracle floor.** ``deadline_s`` bounds a whole
  fetch (retries included). With ``oracle_fallback=True`` a blown
  deadline or exhausted tier degrades to the analyzer oracle — the
  paper's static cost model — instead of raising, so beam search keeps
  making progress through a dying fleet. Degraded predictions are
  counted here (``degraded_count``), flagged in the featurizer's
  ``phase_stats()``, and never cached.

The transport is pluggable (anything with ``n_replicas`` / ``send`` /
``recv``), so tests can drive the full retry state machine without
spawning processes.
"""
from __future__ import annotations

import hashlib
import os
import queue
import random
import threading
import time
from bisect import bisect_right
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.server import ServerOverloadedError
from repro_torch.serving import transport as T


class HashRing:
    """Consistent-hash ring over replica ids with virtual nodes.

    ``route(key)`` returns replicas in ring-successor order (primary
    first) — the natural fallback chain when the primary is shedding or
    dead. Stable under key renaming noise because points hash the
    replica id, and balanced because each replica contributes ``vnodes``
    points."""

    def __init__(self, n_replicas: int, vnodes: int = 32):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.n_replicas = n_replicas
        pts: List[Tuple[int, int]] = []
        for r in range(n_replicas):
            for v in range(vnodes):
                h = hashlib.sha1(f"replica-{r}-vnode-{v}".encode()).digest()
                pts.append((int.from_bytes(h[:8], "big"), r))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [r for _, r in pts]

    def _key_point(self, key: str) -> int:
        if len(key) == 40:                  # struct keys are sha1 hex
            try:
                return int(key[:16], 16)
            except ValueError:
                pass
        d = hashlib.sha1(key.encode()).digest()
        return int.from_bytes(d[:8], "big")

    def route(self, key: str, n: Optional[int] = None) -> List[int]:
        """Distinct replicas in preference order for ``key``."""
        want = self.n_replicas if n is None else min(n, self.n_replicas)
        i = bisect_right(self._points, self._key_point(key))
        out: List[int] = []
        for j in range(len(self._owners)):
            r = self._owners[(i + j) % len(self._owners)]
            if r not in out:
                out.append(r)
                if len(out) == want:
                    break
        return out

    def primary(self, key: str) -> int:
        return self.route(key, 1)[0]


class QueueTransport:
    """Default transport: the mp queues carried by a
    :class:`~repro_torch.serving.replica.TierHandle`."""

    def __init__(self, handle):
        self.handle = handle
        self.client_id = handle.client_id

    @property
    def n_replicas(self) -> int:
        return self.handle.n_replicas

    def send(self, replica: int, msg) -> None:
        self.handle.inboxes[replica].put(msg)

    def recv(self, timeout: float):
        """Next message for this client; raises ``queue.Empty``."""
        return self.handle.resp_queue.get(timeout=timeout)


class _Health:
    __slots__ = ("sent", "ok", "overload", "err", "timeout", "reroutes",
                 "consecutive_failures", "unhealthy_until")

    def __init__(self):
        self.sent = 0
        self.ok = 0
        self.overload = 0
        self.err = 0
        self.timeout = 0
        self.reroutes = 0
        self.consecutive_failures = 0
        self.unhealthy_until = 0.0

    def note_ok(self):
        self.ok += 1
        self.consecutive_failures = 0
        self.unhealthy_until = 0.0

    def note_failure(self, kind: str, cooldown_s: float,
                     retry_after_s: float = 0.0):
        setattr(self, kind, getattr(self, kind) + 1)
        self.consecutive_failures += 1
        # Escalating cooldown: repeated failures push the replica out of
        # the routing preference for longer; the replica's own
        # retry_after hint floors the window.
        w = max(retry_after_s,
                cooldown_s * min(self.consecutive_failures, 8))
        self.unhealthy_until = max(self.unhealthy_until,
                                   time.monotonic() + w)

    def as_dict(self) -> Dict[str, float]:
        d = {k: getattr(self, k) for k in self.__slots__}
        # how much cooldown is actually left NOW (0 when healthy) —
        # `unhealthy_until` alone is a raw monotonic stamp, useless to
        # a dashboard on its own
        d["cooldown_remaining_s"] = max(
            0.0, self.unhealthy_until - time.monotonic())
        return d


class ReplicaClient:
    """Service-shaped client that routes predictions across replicas."""

    def __init__(self, handle=None, spec: Optional[T.ServiceSpec] = None,
                 *, transport=None, local_cache: bool = True,
                 vnodes: int = 32, max_retries: int = 4,
                 backoff_s: float = 0.005, backoff_mult: float = 2.0,
                 backoff_cap_s: Optional[float] = None,
                 timeout_s: float = 60.0, cooldown_s: float = 0.05,
                 deadline_s: Optional[float] = None,
                 oracle_fallback: bool = False,
                 jitter_seed: Optional[int] = None,
                 tracer=None):
        if transport is None:
            transport = QueueTransport(handle)
        self.transport = transport
        # optional repro_torch.obs.trace.Tracer: head-samples requests
        # here at the tier's front door and imports replica-side spans
        # shipped back on MSG_RES, so one client recorder holds complete
        # trees
        self.tracer = tracer
        self.client_id = getattr(transport, "client_id", 0)
        self.vnodes = vnodes
        # scaling: the supervisor publishes the routed replica count in
        # a shared Value; the ring tracks it lazily (see _maybe_resize)
        self._active = getattr(handle, "active", None)
        if self._active is None:
            self._active = getattr(transport, "active", None)
        n_active = self._active.value if self._active is not None \
            else transport.n_replicas
        self.ring = HashRing(n_active, vnodes=vnodes)
        self.local_cache = local_cache
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_mult = backoff_mult
        # decorrelated jitter: sleep ~ U(base, 3*prev) capped; the cap
        # defaults to where the old exponential schedule would have
        # topped out, keeping worst-case retry latency unchanged
        self.backoff_cap_s = backoff_cap_s if backoff_cap_s is not None \
            else backoff_s * (backoff_mult ** max_retries)
        seed = jitter_seed if jitter_seed is not None else (
            (os.getpid() << 20) ^ getattr(transport, "client_id", 0)
            ^ int(time.monotonic_ns() & 0xFFFFF))
        self._jitter = random.Random(seed)
        self.timeout_s = timeout_s
        self.cooldown_s = cooldown_s
        self.deadline_s = deadline_s
        self.oracle_fallback = oracle_fallback
        self.degraded_count = 0         # analyzer-fallback predictions
        self.deadline_expired = 0       # fetches cut short by the budget
        self.recv_errors = 0            # torn replies read as timeouts
        # The featurizer: same recipe as the replicas, used ONLY for
        # struct keys / token ids / (optionally) the local row LRU.
        if spec is None:
            spec = handle_spec(handle)
        self.spec = spec
        # On the CPU whatever the spec's device: this is the featurizer,
        # and no forward runs in it. Built on the card, every client
        # process and fleet worker would open a CUDA context, upload the
        # params and load the kernel library for nothing.
        self.fsvc = spec.build(device="cpu")
        self.health = [_Health() for _ in range(transport.n_replicas)]
        self.shed_count = 0
        self._batch_seq = 0
        self._lock = threading.Lock()
        self._stray: List[Any] = []     # unknown-tag msgs seen mid-wait
        # Reply demux: all of one client's replies arrive on ONE queue,
        # but predict_all may be called from many threads (e.g. the
        # closed-loop serve driver shares a client across its client
        # threads). Whichever thread is pulling the queue delivers
        # messages for OTHER live batches into their mailbox instead of
        # dropping them; waiters are woken through the condition.
        self._cond = threading.Condition()
        self._mail: Dict[int, List[Any]] = {}     # live bid -> replies
        self._live: set = set()                   # bids awaited somewhere
        self._rx_busy = False                     # a thread owns recv()

    # ------------------------------------------------------- service duck
    @property
    def heads(self):
        return self.fsvc.heads

    def resolve_target(self, target: Optional[str]) -> str:
        return self.fsvc.resolve_target(target)

    def predict_all(self, graphs) -> Dict[str, np.ndarray]:
        if not len(graphs):
            return {t: np.zeros((0,), np.float32) for t in self.heads}
        tr = self.tracer
        root = None
        if tr is not None:             # head decision for this request
            root = tr.start("client.predict_all", tr.sample(),
                            tags={"n_graphs": len(graphs)})
        sub = root.ctx if root is not None else None
        try:
            feat = tr.start("client.featurize", sub) if tr else None
            keys: List[str] = []
            vals: Dict[str, np.ndarray] = {}
            miss_graphs: Dict[str, Any] = {}
            for g in graphs:
                h = self.fsvc.key_of(g)
                keys.append(h)
                if h in vals or h in miss_graphs:
                    continue
                hit = self.fsvc.cache_lookup(h) if self.local_cache \
                    else None
                if hit is not None:
                    vals[h] = hit
                else:
                    miss_graphs[h] = g
            entries = self.fsvc.entries_for(
                list(miss_graphs.values()), list(miss_graphs)) \
                if miss_graphs else []
            if tr is not None:
                tr.end(feat, n_miss=len(miss_graphs),
                       local_hits=len(vals))
            if entries:
                if self.oracle_fallback:
                    fetched, left = self._fetch_rounds(entries, trace=sub)
                else:
                    fetched, left = self._fetch(entries, trace=sub), {}
                vals.update(fetched)
                if self.local_cache and fetched:
                    self.fsvc.import_cache(list(fetched.items()))
                if left:
                    # tier exhausted / deadline blown: the analyzer
                    # oracle is the availability floor. Degraded rows
                    # are flagged (counters here + featurizer
                    # phase_stats) and NEVER cached, so real serving
                    # takes back over the moment the tier recovers.
                    vals.update(self._oracle_rows(
                        {k: miss_graphs[k] for k in left}))
                    self.degraded_count += len(left)
                    self.fsvc.note_degraded(len(left))
                    if tr is not None:
                        tr.error_span("router.degraded", sub,
                                      n_degraded=len(left))
        except BaseException:
            if tr is not None:
                tr.end(root, status="err")
            raise
        if tr is not None:
            tr.end(root)
        raw = np.stack([vals[k] for k in keys])
        out = self.fsvc.denormalize_rows(raw)
        drift = getattr(self.fsvc, "drift", None)
        if drift is not None:          # accuracy sentinel rides the tier
            drift.observe_batch(graphs, out)
        return out

    def predict_graphs(self, graphs, target: Optional[str] = None
                       ) -> np.ndarray:
        return self.predict_all(graphs)[self.resolve_target(target)]

    def predict(self, g, target: Optional[str] = None) -> float:
        return float(self.predict_graphs([g], target)[0])

    def predict_text(self, text):
        """Replicated-tier text prediction: the client featurizer does
        ingest + encode + OOV accounting locally, the struct/text key
        routes on the ring like any graph key, and the miss ships the
        usual ``(key, ids)`` wire entry — replicas never see raw text.
        Returns a TextPrediction or a structured IngestError (tier
        overload/timeouts surface as ``predict``-stage errors)."""
        from repro_torch.ir import frontdoor as FD
        ent = self.fsvc.ingest_text(text)
        if isinstance(ent, FD.IngestError):
            return ent
        row = self.fsvc.cache_lookup(ent.key) if self.local_cache \
            else None
        if row is None:
            try:
                got = self._fetch([(ent.key, ent.ids)])
                row = got[ent.key]
            except Exception as e:
                return FD.IngestError("predict", type(e).__name__,
                                      str(e)[:200])
            if self.local_cache:
                self.fsvc.import_cache([(ent.key, row)])
        preds = self.fsvc.denormalize_rows(np.asarray(row)[None])
        return FD.prediction_from(
            ent, {t: float(preds[t][0]) for t in self.heads})

    # --------------------------------------------------------- fetch core
    def _next_batch_id(self) -> int:
        with self._lock:
            self._batch_seq += 1
            return (self.client_id << 20) | self._batch_seq

    def _pick_replica(self, key: str, now: float) -> int:
        """Primary unless it's in failure cooldown — then the first
        healthy successor on the ring (all cooling: primary anyway)."""
        order = self.ring.route(key)
        for i, r in enumerate(order):
            if self.health[r].unhealthy_until <= now:
                if i > 0:
                    self.health[order[0]].reroutes += 1
                return r
        return order[0]

    def _maybe_resize(self) -> None:
        """Track the supervisor-published routed replica count. Cheap
        (one shared-int read); the ring is rebuilt only on change, and
        slot identities are stable so surviving replicas keep their key
        ownership."""
        if self._active is None:
            return
        n = self._active.value
        if n != self.ring.n_replicas and n >= 1:
            self.ring = HashRing(n, vnodes=self.vnodes)

    def _fetch(self, entries: Sequence[Tuple[str, np.ndarray]],
               trace=None) -> Dict[str, np.ndarray]:
        """Resolve (key, ids) misses through the tier, with retry,
        reroute-on-failure, backoff, and final shed."""
        got, pending = self._fetch_rounds(entries, trace=trace)
        if pending:
            raise ServerOverloadedError(
                f"{len(pending)} request(s) shed after "
                f"{self.max_retries + 1} attempts across "
                f"{self.ring.n_replicas} replicas")
        return got

    def _fetch_rounds(self, entries: Sequence[Tuple[str, np.ndarray]],
                      trace=None) -> Tuple[Dict[str, np.ndarray],
                                           Dict[str, np.ndarray]]:
        """Retry/backoff core: returns ``(got, still_pending)``; the
        caller decides whether leftovers raise (``_fetch``) or degrade
        to the oracle (``predict_all``)."""
        tr = self.tracer
        span = tr.start("router.fetch", trace,
                        tags={"n_entries": len(entries)}) if tr else None
        sub = span.ctx if span is not None else None
        self._maybe_resize()
        pending: Dict[str, np.ndarray] = dict(entries)
        got: Dict[str, np.ndarray] = {}
        deadline = time.monotonic() + self.deadline_s \
            if self.deadline_s is not None else None
        sleep = self.backoff_s
        attempt = 0
        for attempt in range(self.max_retries + 1):
            if not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                self.deadline_expired += 1
                break
            hint = self._round(pending, got, trace=sub,
                               deadline=deadline)
            if pending and attempt < self.max_retries:
                # decorrelated jitter (not plain exponential): each
                # client walks its own randomized schedule, so a fleet
                # of workers retrying a recovering replica spreads out
                # instead of re-converging every backoff_mult^k ticks
                sleep = min(self.backoff_cap_s,
                            self._jitter.uniform(self.backoff_s,
                                                 max(sleep * 3.0,
                                                     self.backoff_s)))
                wait = max(hint, sleep)
                if deadline is not None:
                    wait = min(wait, max(deadline - time.monotonic(),
                                         0.0))
                time.sleep(wait)
        if pending:
            self.shed_count += 1
            if tr is not None:          # sheds are always-on telemetry
                tr.error_span("router.shed", sub,
                              n_pending=len(pending),
                              attempts=attempt + 1)
                tr.end(span, status="shed", attempts=attempt + 1)
        elif tr is not None:
            tr.end(span, attempts=attempt + 1)
        return got, pending

    def _oracle_rows(self, graphs_by_key: Dict[str, Any]
                     ) -> Dict[str, np.ndarray]:
        """Analyzer-oracle fallback rows (normalized space, so they ride
        the same denormalize path as model rows). Heads the static
        analyzers don't model fall back to the training mean
        (normalized 0)."""
        from repro_torch.ir.analyzers import TARGETS
        heads = list(self.heads)
        out: Dict[str, np.ndarray] = {}
        for key, g in graphs_by_key.items():
            den = np.zeros((1, len(heads)), np.float32)
            known = np.zeros(len(heads), bool)
            for i, t in enumerate(heads):
                fn = TARGETS.get(t)
                if fn is not None:
                    den[0, i] = float(fn(g))
                    known[i] = True
            raw = self.fsvc.normalize_rows(den)[0]
            out[key] = np.where(known, raw, 0.0).astype(np.float32)
        return out

    def _recv_any(self, bids, deadline: float):
        """Next reply addressed to one of ``bids`` (all registered in
        ``_live``), or ``None`` once ``deadline`` passes. Thread-safe
        over the shared per-client response queue: with one caller this
        degenerates to a plain ``transport.recv``; with several, the
        thread holding the transport forwards replies it doesn't own."""
        while True:
            with self._cond:
                for bid in bids:
                    box = self._mail.get(bid)
                    if box:
                        msg = box.pop(0)
                        if not box:
                            del self._mail[bid]
                        return msg
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                if self._rx_busy:
                    self._cond.wait(timeout=left)
                    continue
                self._rx_busy = True
            try:
                msg = self.transport.recv(
                    max(deadline - time.monotonic(), 1e-3))
            except queue.Empty:
                msg = None
            except Exception:
                # a replica dying mid-reply can tear the response
                # stream; a torn message reads as a timeout (and a
                # retry), never a crashed fetch
                self.recv_errors += 1
                msg = None
            finally:
                with self._cond:
                    self._rx_busy = False
                    self._cond.notify_all()
            if msg is None:
                return None
            bid = msg[1] if len(msg) > 1 else None
            if bid in bids:
                return msg
            with self._cond:
                if bid in self._live:             # another thread's batch
                    self._mail.setdefault(bid, []).append(msg)
                    self._cond.notify_all()
                elif msg[0] not in (T.MSG_RES, T.MSG_OVERLOAD, T.MSG_ERR,
                                    T.MSG_STATS_RES):
                    self._stray.append(msg)
                # else: stale reply for a finished round — dropped

    def _track(self, bids) -> None:
        with self._cond:
            self._live.update(bids)

    def _untrack(self, bids) -> None:
        with self._cond:
            self._live.difference_update(bids)
            for bid in bids:
                self._mail.pop(bid, None)

    def _round(self, pending: Dict[str, np.ndarray],
               got: Dict[str, np.ndarray], trace=None,
               deadline: Optional[float] = None) -> float:
        """One routed send/collect round. Resolved keys move from
        ``pending`` to ``got``; returns the max retry_after hint.

        When traced, each per-replica wire batch gets its own
        ``router.rpc`` span (retries create new ones under the same
        trace, so the tree shows every attempt); the trace context rides
        MSG_REQ as an optional 7th element — appended ONLY for traced
        sends, so untraced traffic keeps the classic 6-tuple shape."""
        tr = self.tracer
        now = time.monotonic()
        groups: Dict[int, List[Tuple[str, np.ndarray]]] = {}
        for key, ids in pending.items():
            groups.setdefault(self._pick_replica(key, now), []).append(
                (key, ids))
        outstanding: Dict[int, Tuple[int, List[str], Any]] = {}
        tracked: set = set()
        for replica, ents in groups.items():
            bid = self._next_batch_id()
            ks, lens_b, ids_b = T.pack_entries(ents)
            sp = tr.start("router.rpc", trace,
                          tags={"replica": replica, "n_keys": len(ks)}) \
                if tr is not None and trace is not None else None
            msg = (T.MSG_REQ, self.client_id, bid, ks, lens_b, ids_b)
            if sp is not None:
                msg = msg + (sp.ctx.to_wire(),)
            # register the bid BEFORE the send: with a shared client,
            # another thread can pull our reply off the queue the
            # instant the send lands, and an untracked bid reads as
            # stale and gets dropped (a spurious 1-round timeout)
            self._track({bid})
            tracked.add(bid)
            try:
                self.transport.send(replica, msg)
                self.health[replica].sent += 1
                outstanding[bid] = (replica, ks, sp)
            except Exception:
                self._untrack({bid})
                tracked.discard(bid)
                self.health[replica].note_failure(
                    "err", self.cooldown_s)
                if tr is not None:
                    tr.end(sp, status="err", stage="send")
        hint = 0.0
        round_deadline = time.monotonic() + self.timeout_s
        if deadline is not None:        # per-request budget clamps the
            round_deadline = min(round_deadline, deadline)   # wait too
        deadline = round_deadline
        try:
            while outstanding:
                msg = self._recv_any(set(outstanding), deadline)
                if msg is None:             # deadline: everything left
                    for bid, (replica, ks, sp) in outstanding.items():
                        self.health[replica].note_failure(
                            "timeout", self.cooldown_s)
                        if tr is not None:
                            tr.end(sp, status="timeout")
                    break
                tag = msg[0]
                if tag == T.MSG_RES:
                    bid, rids, rows_b, nh = msg[1], msg[2], msg[3], msg[4]
                    spans = T.res_spans(msg)
                    if spans and tr is not None:
                        tr.recorder.extend(spans)   # replica-side spans
                    replica, ks, sp = outstanding[bid]
                    rows = T.unpack_rows(rows_b, nh)
                    for rid, row in zip(rids, rows):
                        key = ks[rid]
                        got[key] = row
                        pending.pop(key, None)
                    self.health[replica].note_ok()
                    if not any(k in pending for k in ks):
                        outstanding.pop(bid, None)
                        if tr is not None:
                            tr.end(sp, n_rows=len(rids))
                elif tag == T.MSG_OVERLOAD:
                    _, bid, rids, retry_after = msg
                    replica, ks, sp = outstanding.pop(bid)
                    hint = max(hint, float(retry_after))
                    self.health[replica].note_failure(
                        "overload", self.cooldown_s,
                        retry_after_s=float(retry_after))
                    if tr is not None:
                        tr.end(sp, status="overload",
                               retry_after_s=float(retry_after))
                elif tag == T.MSG_ERR:
                    _, bid, rids, why = msg
                    replica, ks, sp = outstanding.pop(bid)
                    self.health[replica].note_failure(
                        "err", self.cooldown_s)
                    if tr is not None:
                        tr.end(sp, status="err")
        finally:
            self._untrack(tracked)
        return hint

    # ------------------------------------------------------------- control
    def _rpc(self, tag: str, timeout_s: float = 30.0
             ) -> List[Optional[Dict[str, Any]]]:
        """Broadcast a control message; collect one reply per replica."""
        rids = {}
        for r in range(self.ring.n_replicas):
            rid = self._next_batch_id()
            rids[rid] = r
            self._track({rid})          # before the send (demux race)
            try:
                self.transport.send(r, (tag, self.client_id, rid))
            except Exception:
                self._untrack({rid})
                del rids[rid]
        out: List[Optional[Dict[str, Any]]] = \
            [None] * self.ring.n_replicas
        deadline = time.monotonic() + timeout_s
        tracked = set(rids)
        try:
            want = len(rids)
            while want:
                msg = self._recv_any(tracked, deadline)
                if msg is None:
                    break
                if msg[0] == T.MSG_STATS_RES:
                    out[rids[msg[1]]] = msg[2]
                    want -= 1
        finally:
            self._untrack(tracked)
        return out

    def replica_stats(self) -> List[Optional[Dict[str, Any]]]:
        return self._rpc(T.MSG_STATS)

    def clear_caches(self, remote: bool = True) -> None:
        """Drop the client featurizer caches (rows + ids) and, when
        ``remote``, every replica's too — bench cold-pass reset."""
        with self.fsvc._cache_lock:
            self.fsvc._cache.clear()
            self.fsvc._ids_cache.clear()
        if remote:
            self._rpc(T.MSG_CLEAR)

    def stats(self) -> Dict[str, Any]:
        now = time.monotonic()
        return {
            "client_id": self.client_id,
            "n_replicas": self.ring.n_replicas,
            "shed_count": self.shed_count,
            "degraded_count": self.degraded_count,
            "deadline_expired": self.deadline_expired,
            "recv_errors": self.recv_errors,
            "local_cache": self.fsvc.cache_stats(),
            "health": {r: h.as_dict()
                       for r, h in enumerate(self.health)},
            # fleet-level rollups: per-kind failure totals and how many
            # replicas are in cooldown right now — the one-look summary
            # the registry snapshot and dashboards key on
            "failures": {k: sum(getattr(h, k) for h in self.health)
                         for k in ("overload", "err", "timeout",
                                   "reroutes")},
            "unhealthy_now": sum(h.unhealthy_until > now
                                 for h in self.health),
        }


def handle_spec(handle) -> T.ServiceSpec:
    spec = getattr(handle, "spec", None)
    if spec is None:
        raise ValueError("ReplicaClient needs a ServiceSpec: pass "
                         "spec= or a TierHandle that carries one")
    return spec
