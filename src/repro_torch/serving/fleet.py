"""Multi-process fleet-client harness for the replicated tier.

The search_fleet bench's thread workers convoy on the GIL: every
worker's python search loop (expand -> hash -> featurize) serializes
through one interpreter, so adding workers adds context-switch churn,
not throughput. This harness runs each fleet worker as its OWN spawned
process holding a persistent :class:`~repro_torch.serving.router.ReplicaClient`
— the client-side featurizer, local LRU, and search loop all execute
GIL-free, and only cache *misses* cross a process boundary.

Workers are long-lived and command-driven (pass / clear / stats /
stop), so a bench can run warm, cold, and steady passes against the
same fleet without re-paying process spawn or the torch import,
mirroring a long-running compiler fleet. A worker's featurizer is on
the CPU (see :mod:`repro_torch.serving.router`), so a worker never
initialises CUDA, whatever device the replicas serve on.
"""
from __future__ import annotations

import multiprocessing as mp
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def fleet_worker_main(worker_id: int, handle, pool, client_kw,
                      search_kw, cmd_q, res_q) -> None:
    """Child entry point: one persistent client, command loop."""
    try:
        from repro_torch.opt import search as OS
        from repro_torch.serving.router import ReplicaClient
        client_kw = dict(client_kw or {})
        # obs passthrough: `obs_sample=N` (not a ReplicaClient kwarg)
        # gives this worker's client its own head-sampling tracer;
        # trace health then rides the normal stats reply
        obs_sample = int(client_kw.pop("obs_sample", 0) or 0)
        tracer = None
        if obs_sample:
            from repro_torch.obs.trace import Tracer
            tracer = Tracer(sample_every=obs_sample,
                            proc=f"fleet-{worker_id}")
            client_kw["tracer"] = tracer
        client = ReplicaClient(handle, **client_kw)
    except Exception as e:
        res_q.put(("error", worker_id,
                   f"{e!r}\n{traceback.format_exc()}"))
        return
    res_q.put(("ready", worker_id))
    base_kw = dict(search_kw or {})
    while True:
        msg = cmd_q.get()
        tag = msg[0]
        if tag == "stop":
            break
        try:
            if tag == "pass":
                kw = dict(base_kw)
                kw.update(msg[1] or {})
                # rounds > 1 repeats the pool inside ONE timed pass so
                # short steady measurements amortize the driver's
                # broadcast/collect barrier instead of re-paying it
                rounds = int(kw.pop("rounds", 1))
                t0 = time.perf_counter()
                cands = 0
                for _ in range(rounds):
                    results = OS.search_pool(client, pool,
                                             offset=worker_id, **kw)
                    cands += sum(r.evaluated + 1 for r in results)
                dt = time.perf_counter() - t0
                # each searched graph's best, by the root's struct key
                # (outside the timed window), so the FleetDriver can hold the
                # fleet's searches to a direct one
                best = {r.root.struct_key(): (r.best.struct_key(),
                                              r.best_score)
                        for r in results}
                res_q.put(("pass", worker_id, dt, cands, best))
            elif tag == "clear":
                # remote clear from worker 0 only — one broadcast per
                # fleet reset, not one per worker
                client.clear_caches(remote=(worker_id == 0))
                res_q.put(("clear", worker_id))
            elif tag == "stats":
                payload = client.stats()
                # the featurizer is on the CPU: a worker that opened a
                # CUDA context would show here
                import torch
                payload["cuda_initialized"] = torch.cuda.is_initialized()
                if tracer is not None:
                    from repro_torch.obs.trace import assemble, completeness
                    recs = tracer.recorder.snapshot()
                    trees = assemble(recs)
                    payload["obs"] = {
                        "spans": len(recs), "traces": len(trees),
                        "complete_frac": completeness(trees)}
                if msg[1]:                   # include replica-side stats
                    payload["replicas"] = client.replica_stats()
                res_q.put(("stats", worker_id, payload))
            else:
                res_q.put(("error", worker_id, f"unknown cmd {tag!r}"))
        except Exception as e:               # keep the worker alive
            res_q.put(("error", worker_id,
                       f"{e!r}\n{traceback.format_exc()}"))


@dataclass
class FleetDriver:
    """Parent-side controller over N spawned fleet-worker processes."""

    procs: List[mp.Process]
    cmd_qs: List[Any]
    res_q: Any
    n_workers: int
    errors: List[str] = field(default_factory=list)

    @classmethod
    def start(cls, tier, pool, n_workers: int, *,
              client_kw: Optional[Dict[str, Any]] = None,
              search_kw: Optional[Dict[str, Any]] = None,
              start_timeout_s: float = 300.0) -> "FleetDriver":
        """Spawn workers bound to ``tier`` (which must have been started
        with ``n_clients >= n_workers``) and wait until every client has
        built its featurizer."""
        ctx = mp.get_context("spawn")
        cmd_qs = [ctx.Queue() for _ in range(n_workers)]
        res_q = ctx.Queue()
        procs = []
        for w in range(n_workers):
            p = ctx.Process(
                target=fleet_worker_main,
                args=(w, tier.client_handle(w), pool, client_kw,
                      search_kw, cmd_qs[w], res_q),
                name=f"fleet-worker-{w}", daemon=True)
            p.start()
            procs.append(p)
        drv = cls(procs=procs, cmd_qs=cmd_qs, res_q=res_q,
                  n_workers=n_workers)
        for _ in range(n_workers):
            msg = drv._get(start_timeout_s)
            if msg[0] != "ready":
                drv.stop()
                raise RuntimeError(f"fleet worker failed: {msg[2]}")
        return drv

    def _get(self, timeout_s: float):
        try:
            return self.res_q.get(timeout=timeout_s)
        except Exception:
            raise RuntimeError(
                f"fleet worker reply timed out after {timeout_s:.0f}s "
                f"(alive={[p.is_alive() for p in self.procs]})") from None

    def _collect(self, tag: str, timeout_s: float) -> List[Any]:
        out: List[Any] = []
        while len(out) < self.n_workers:
            msg = self._get(timeout_s)
            if msg[0] == tag:
                out.append(msg)
            elif msg[0] == "error":
                self.errors.append(msg[2])
                raise RuntimeError(
                    f"fleet worker {msg[1]} errored: {msg[2]}")
        return out

    def run_pass(self, timeout_s: float = 600.0,
                 **search_overrides) -> Dict[str, Any]:
        """Broadcast one search pass to every worker; returns driver
        wall time plus per-worker walls, total candidates costed and
        each worker's best ``(struct key, score)`` by root struct key
        (from its last round), in worker order. Pass ``rounds=K`` to
        repeat the pool K times per worker within the single timed pass
        (barrier paid once, not K times)."""
        t0 = time.perf_counter()
        for q in self.cmd_qs:
            q.put(("pass", search_overrides))
        msgs = self._collect("pass", timeout_s)
        wall = time.perf_counter() - t0
        return {"wall_s": wall,
                "candidates": sum(m[3] for m in msgs),
                "worker_wall_s": [m[2] for m in msgs],
                "best": [m[4] for m in sorted(msgs, key=lambda m: m[1])]}

    def clear(self, timeout_s: float = 60.0) -> None:
        """Fleet-wide cache reset: every worker's local featurizer, the
        replica LRUs (broadcast once, from worker 0)."""
        for q in self.cmd_qs:
            q.put(("clear",))
        self._collect("clear", timeout_s)

    def stats(self, include_replicas: bool = False,
              timeout_s: float = 60.0) -> List[Dict[str, Any]]:
        """Per-worker client stats, ordered by worker id; worker 0 can
        also carry the replica-side snapshots."""
        for w, q in enumerate(self.cmd_qs):
            q.put(("stats", include_replicas and w == 0))
        msgs = self._collect("stats", timeout_s)
        return [m[2] for m in sorted(msgs, key=lambda m: m[1])]

    def stop(self, timeout: float = 10.0) -> None:
        for q in self.cmd_qs:
            try:
                q.put(("stop",))
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=timeout)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)

    def __enter__(self) -> "FleetDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
