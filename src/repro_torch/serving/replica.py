"""Replica process: one CostModelService + async server per process.

Each replica is a spawned worker (CUDA cannot be forked) that rebuilds
the model from a :class:`~repro_torch.serving.transport.ServiceSpec` and
serves ids-first request batches through its own
:class:`~repro_torch.core.server.CostModelServer` — so every replica owns
its params (on its spec's device: N replicas on one card are N CUDA
contexts, whose kernels time-slice the card), its warm-up, its LRU and
in-flight dedup, and an *adaptive* flush deadline that tracks its
observed arrival rate. On a local-LRU miss the replica consults the
shared cross-replica cache tier before computing, and publishes every
computed row back to it.

A card spec with ``use_kernel`` has its kernel library built (or
loaded) by :func:`start_replicas` in the parent before any child
starts, so N children starting together, and a child respawned later,
only load it: none runs ``nvcc``. Each child's ``MSG_STATS`` reply
carries its device, its kind's kernel launch counters and its forward
batches, so the parent can check the children's work.

Request batches resolve through the server's futures; one combined
response message per inbound batch goes back on the requesting client's
queue once the whole batch lands (split into per-outcome messages only
when some entries shed). Replies never re-serialize graphs — rows pack
as one float32 block.
"""
from __future__ import annotations

import multiprocessing as mp
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.serving import transport as T
from repro_torch.serving.shared_cache import SharedRowCache


@dataclass
class ReplicaTier:
    """Parent-side handle on the spawned replica fleet.

    ``client_handle(i)`` returns the picklable bundle a client (in this
    or any spawned process) needs to talk to the tier. The tier also
    retains everything :func:`replica_main` needs (spawn context, server
    kwargs, the readiness queue) so a dead or wedged replica can be
    respawned *into the same slot* — same inbox, same ring identity —
    by :class:`~repro_torch.serving.supervisor.ReplicaSupervisor`."""

    procs: List[Optional[mp.Process]]  # slot i <-> ring identity i
    inboxes: List[Any]                 # one request queue per replica
    client_queues: List[Any]           # one response queue per client id
    #                                    (+ one trailing control queue)
    shared_cache: SharedRowCache
    spec: T.ServiceSpec
    active: Any = None                 # ctx.Value("i"): routed count
    ctx: Any = None
    server_kw: Optional[Dict[str, Any]] = None
    warmup: bool = True
    ready: Any = None                  # replicas report ("ready", id)

    @property
    def n_replicas(self) -> int:
        return len(self.procs)

    @property
    def max_replicas(self) -> int:
        return len(self.inboxes)

    @property
    def control_queue(self) -> Any:
        """The supervisor's response queue (reserved trailing slot)."""
        return self.client_queues[-1]

    @property
    def control_id(self) -> int:
        return len(self.client_queues) - 1

    def client_handle(self, client_id: int) -> "TierHandle":
        return TierHandle(client_id=client_id, inboxes=self.inboxes,
                          resp_queue=self.client_queues[client_id],
                          n_replicas=len(self.inboxes), spec=self.spec,
                          active=self.active)

    def alive(self) -> List[bool]:
        return [p is not None and p.is_alive() for p in self.procs]

    def reset_inbox(self, i: int) -> None:
        """Give slot ``i`` a fresh inbox pipe. A SIGKILLed replica dies
        holding the queue's reader lock (it waits in ``get()`` with it
        held) and can leave a half-read frame behind — the successor
        would wedge on the orphaned semaphore or desync on the torn
        stream. Replacing the queue sidesteps both: ``inboxes`` is the
        same list object inside every in-process client handle, so
        routers pick up the new pipe on their next send, and requests
        stranded in the old one are re-sent by the client's normal
        timeout/reroute path. (Clients in *other* processes hold a
        pickled copy and keep the stale queue: their traffic for this
        slot reroutes to the survivors, which is degraded but never
        wrong.)"""
        ctx = self.ctx or mp.get_context("spawn")
        self.inboxes[i] = ctx.Queue()

    def spawn(self, i: int) -> mp.Process:
        """(Re)spawn slot ``i`` from the stored spec; non-blocking (the
        child reports on :attr:`ready` once rebuilt + warmed). The slot
        reuses inbox ``i``, so consistent-hash ownership and the other
        replicas' LRU locality are undisturbed."""
        if not 0 <= i < len(self.inboxes):
            raise IndexError(f"replica slot {i} out of range")
        p = self.ctx.Process(
            target=replica_main,
            args=(i, self.spec, self.inboxes[i], self.client_queues,
                  self.shared_cache, self.server_kw, self.warmup,
                  self.ready),
            name=f"costmodel-replica-{i}", daemon=True)
        p.start()
        while len(self.procs) <= i:
            self.procs.append(None)
        self.procs[i] = p
        return p

    def stop(self, timeout: float = 10.0) -> None:
        for q in self.inboxes:
            try:
                q.put((T.MSG_STOP,))
            except Exception:
                pass
        live = [p for p in self.procs if p is not None]
        for p in live:
            p.join(timeout=timeout)
        for p in live:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)

    def __enter__(self) -> "ReplicaTier":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


@dataclass
class TierHandle:
    """What one client needs: every replica's inbox, its own response
    queue, and the replica count (ring construction). Picklable into
    spawned fleet-client processes."""

    client_id: int
    inboxes: List[Any]
    resp_queue: Any
    n_replicas: int
    spec: Any = None
    active: Any = None          # shared routed-replica count (scaling)


def start_replicas(spec: T.ServiceSpec, n_replicas: int, *,
                   n_clients: int = 1, warmup: bool = True,
                   max_batch: Optional[int] = None,
                   flush_us: float = 500.0,
                   max_queue: int = 4096,
                   adaptive_flush: bool = True,
                   shared_slots: int = 16384,
                   start_timeout_s: float = 180.0,
                   obs_trace: bool = False,
                   max_replicas: Optional[int] = None) -> ReplicaTier:
    """Spawn ``n_replicas`` model-serving processes + the shared cache.

    Blocks until every replica reports ready (model rebuilt, programs
    warmed), so the first real request never pays child-process startup.
    ``n_clients`` response queues are created up front (plus one
    trailing control queue reserved for the supervisor's heartbeat RPC);
    client ids are assigned by the caller via
    :meth:`ReplicaTier.client_handle`. ``max_replicas`` pre-allocates
    extra inbox slots so the supervisor can scale the tier up later
    without re-plumbing existing clients. A card spec with
    ``use_kernel`` builds (or loads) its kind's kernel library here,
    before the first child starts; a replica that cannot build its
    service (no card, a failed build) fails the start, which raises."""
    if spec.use_kernel and (spec.device or "cuda").split(":")[0] == "cuda":
        from repro_torch.kernels import ops as KOPS
        KOPS.build(spec.kind)
    ctx = mp.get_context("spawn")
    max_replicas = max(n_replicas, max_replicas or n_replicas)
    n_heads = len(spec.norm_stats) if isinstance(spec.norm_stats, dict) \
        and all(isinstance(v, dict) for v in spec.norm_stats.values()) \
        else 1
    shared = SharedRowCache(n_heads, n_slots=shared_slots, ctx=ctx)
    inboxes = [ctx.Queue() for _ in range(max_replicas)]
    client_queues = [ctx.Queue() for _ in range(n_clients + 1)]
    ready = ctx.Queue()
    server_kw = dict(max_batch=max_batch, flush_us=flush_us,
                     max_queue=max_queue, adaptive_flush=adaptive_flush,
                     obs_trace=obs_trace)
    tier = ReplicaTier(procs=[], inboxes=inboxes,
                       client_queues=client_queues, shared_cache=shared,
                       spec=spec, active=ctx.Value("i", n_replicas),
                       ctx=ctx, server_kw=server_kw, warmup=warmup,
                       ready=ready)
    for i in range(n_replicas):
        tier.spawn(i)
    for _ in range(n_replicas):
        try:
            msg = ready.get(timeout=start_timeout_s)
        except Exception:
            tier.stop()
            raise RuntimeError(
                f"replica tier failed to start within "
                f"{start_timeout_s:.0f}s") from None
        if msg[0] != "ready":
            tier.stop()
            raise RuntimeError(f"replica failed to start: {msg[1]}")
    return tier


def replica_main(replica_id: int, spec: T.ServiceSpec, inbox,
                 client_queues, shared: SharedRowCache,
                 server_kw: Dict[str, Any], warmup: bool,
                 ready) -> None:
    """Child entry point (module-level so spawn can import it)."""
    try:
        import torch
        # one intra-op thread: N replicas on one host would otherwise
        # each start a pool as wide as the machine (the card's host
        # work is Python, so this costs nothing there)
        torch.set_num_threads(1)
        from repro_torch.core.server import (CostModelServer,
                                             ServerOverloadedError)
        from repro_torch.kernels import _build
        from repro_torch.kernels import ops as KOPS
        server_kw = dict(server_kw)
        tracer = None
        if server_kw.pop("obs_trace", False):
            # replica-side tracer: never head-samples on its own (the
            # client makes the head decision); it only honors contexts
            # arriving on the wire, so sample_every is effectively off
            from repro_torch.obs.trace import TraceContext, Tracer
            tracer = Tracer(sample_every=1 << 30,
                            proc=f"replica-{replica_id}")
        svc = spec.build()
        device = {"type": svc._device.type,
                  "name": torch.cuda.get_device_name(svc._device)
                  if svc._device.type == "cuda" else None}
        server = CostModelServer(
            svc, tracer=tracer,
            **{k: v for k, v in server_kw.items() if v is not None})
        server.start(warmup=warmup)
    except Exception as e:                       # startup failure: report
        ready.put(("error", f"{e!r}\n{traceback.format_exc()}"))
        return
    ready.put(("ready", replica_id))

    shared_hits = 0
    shared_misses = 0
    send_lock = threading.Lock()                 # callbacks run in the
    #                                              server worker thread

    def _send(client: int, msg) -> None:
        with send_lock:
            client_queues[client].put(msg)

    def _handle_batch(client: int, batch_id: int, keys, lens_b, ids_b,
                      trace=None):
        nonlocal shared_hits, shared_misses
        entries = T.unpack_entries(keys, lens_b, ids_b)
        rids = list(range(len(entries)))
        rows: List[Optional[Any]] = [None] * len(entries)
        shed: List[int] = []
        retry_after = 0.0
        # n starts at 1: the submission loop itself holds a ref so a
        # fast callback can't finalize the batch mid-loop.
        pend = {"n": 1, "done": False}
        pend_lock = threading.Lock()
        computed: List = []                      # -> shared tier
        batch_span = None
        if tracer is not None and trace is not None:
            batch_span = tracer.start(
                "replica.batch", TraceContext.from_wire(trace),
                tags={"replica": replica_id, "n_entries": len(entries)})
        sub_ctx = batch_span.ctx if batch_span is not None else None

        def _finish_if_complete():
            with pend_lock:
                if pend["n"] != 0 or pend["done"]:
                    return
                pend["done"] = True
            if computed:
                shared.put_many(computed)
            ok = [i for i in rids if rows[i] is not None]
            spans = None
            if batch_span is not None:
                # the batch span + every child this trace produced in
                # this process ship back with the response; by the time
                # a future callback lands here the server worker has
                # already emitted its queue/forward spans (it resolves
                # futures only after recording them)
                tracer.end(batch_span,
                           status="overload" if shed else "ok",
                           n_ok=len(ok), n_shed=len(shed))
                if ok:
                    spans = tracer.recorder.take([batch_span.trace_id])
            if ok:
                res = (T.MSG_RES, batch_id, ok,
                       *T.pack_rows([rows[i] for i in ok]))
                if spans:
                    res = res + (spans,)
                _send(client, res)
            if shed:
                _send(client, (T.MSG_OVERLOAD, batch_id, shed,
                               retry_after))

        for i, (key, ids) in enumerate(entries):
            hit = svc.cache_lookup(key)
            if hit is not None:
                if sub_ctx is not None:
                    tracer.emit("replica.cache_hit", sub_ctx, 0.0,
                                tags={"tier": "local"})
                rows[i] = hit
                continue
            srow = shared.get(key)               # cross-replica tier
            if srow is not None:
                shared_hits += 1
                if sub_ctx is not None:
                    tracer.emit("replica.cache_hit", sub_ctx, 0.0,
                                tags={"tier": "shared"})
                svc.import_cache([(key, srow)])
                rows[i] = srow
                continue
            shared_misses += 1
            try:
                fut = server.submit_entry(key, ids, probe=False,
                                          trace=sub_ctx)
            except ServerOverloadedError as e:
                shed.append(i)
                retry_after = max(retry_after, e.retry_after_s)
                continue
            with pend_lock:
                pend["n"] += 1

            def _on_done(f, i=i, key=key):
                try:
                    row = f.result()
                    rows[i] = row
                    computed.append((key, row))
                except Exception:
                    pass                         # row stays None -> err
                with pend_lock:
                    pend["n"] -= 1
                _finish_if_complete()

            fut.add_done_callback(_on_done)
        with pend_lock:
            pend["n"] -= 1                       # release the loop's ref
        _finish_if_complete()

    while True:
        msg = inbox.get()
        tag = msg[0]
        if tag == T.MSG_STOP:
            break
        if tag == T.MSG_REQ:
            # length-tolerant: traced requests carry an optional 7th
            # element (see transport docstring); classic 6-tuples are
            # untraced
            _, client, batch_id, keys, lens_b, ids_b = msg[:6]
            try:
                _handle_batch(client, batch_id, keys, lens_b, ids_b,
                              trace=T.req_trace(msg))
            except Exception as e:               # never kill the replica
                _send(client, (T.MSG_ERR, batch_id,
                               list(range(len(keys))), repr(e)))
        elif tag == T.MSG_STATS:
            _, client, rid = msg
            m = server.metrics_snapshot()
            payload = {"replica_id": replica_id,
                       "server": m,
                       "cache": svc.cache_stats(),
                       "shared_hits": shared_hits,
                       "shared_misses": shared_misses,
                       "shared_lock_timeouts": shared.lock_timeouts,
                       "shared_torn_drops": shared.torn_drops,
                       "device": device,
                       "kernel_launches": KOPS.launch_counts(spec.kind),
                       "nvcc_runs": len(_build.compiled),
                       "forward_batches": svc.forward_batches}
            if tracer is not None:
                payload["obs"] = {
                    "spans_buffered": len(tracer.recorder),
                    "spans_dropped": tracer.recorder.dropped}
            _send(client, (T.MSG_STATS_RES, rid, payload))
        elif tag == T.MSG_CLEAR:
            _, client, rid = msg
            with svc._cache_lock:
                svc._cache.clear()
                svc._ids_cache.clear()
            _send(client, (T.MSG_STATS_RES, rid, {"cleared": True}))
    server.stop()
