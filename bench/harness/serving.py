"""What the drivers that serve through the gateway share: the port's
service and server at a configuration's settings, the recording of the
batches it forwards, the warm-up of its shapes, its counters, and
:class:`Served`, the work, stop and check of a served window."""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, List

import numpy as np

from bench.harness import check as C
from bench.harness import graphs as G
from bench.harness import model as M
from bench.harness import roofline as R
from bench.harness import spec as SP


def program(run):
    """The port's service and server at the configuration's settings,
    with the benchmark's weights, vocabulary and norm stats (each a
    copy: the reference keeps its own)."""
    from repro_torch.core import tokenizer as TOK
    from repro_torch.core.server import CostModelServer
    from repro_torch.core.service import CostModelService
    cfg, svc_cfg, gw = run.cfg, run.cfg["service"], run.cfg["gateway"]
    service = CostModelService(
        cfg["kind"], SP.model(cfg["kind"]).port_config(cfg),
        M.tree_to(run.params, run.device),
        TOK.Vocab(dict(run.vocab)), {t: dict(s) for t, s in
                                     run.stats.items()},
        mode=cfg["mode"], max_seq=cfg["max_seq"],
        cache_size=svc_cfg["cache_size"], dtype=svc_cfg["dtype"],
        use_kernel=svc_cfg["use_kernel"], device=str(run.device))
    server = CostModelServer(service, max_batch=gw["max_batch"],
                             flush_us=gw["flush_us"],
                             max_queue=gw["max_queue"])
    return service, server


def record_batches(service, run) -> List:
    """While ``run.recording`` is set, the (n, S) ids of each batch the
    service forwards: the rows that carry requests, before the service
    pads the batch to its ladder."""
    batches: List = []
    dispatch = service.forward_entries_dispatch

    def recorded(entries):
        if run.recording:
            batches.append([ids for _, ids in entries])
        return dispatch(entries)
    service.forward_entries_dispatch = recorded
    return batches


def warm_forward(service, run, fams, max_batch: int) -> None:
    """Run the service's forward path (stack, pinned copy, launch, event,
    copy back) once at every (bucket, batch) shape this traffic reaches,
    each batch of distinct fresh graphs, so that nothing the window does
    loads or allocates for the first time."""
    from bench.reference import tokenizer as RT
    rng = random.Random(f"warm-forward/{run.seed}")
    ladder = [b for b in service.batch_ladder if b <= max_batch]
    need = sum(ladder)
    by_bucket: Dict[int, list] = {}
    for _ in range(run.traffic["warmup_graphs"]):
        g = G.sample(rng, fams)
        by_bucket.setdefault(RT.bucket_of(
            len(RT.graph_tokens(g, run.cfg["mode"])), run.cfg), []).append(g)
    for gs in by_bucket.values():
        gs = gs[:need]
        for b in ladder:
            if b > len(gs):
                break
            service.predict_all(gs[:b])
            gs = gs[b:]


def phase(service) -> Dict[str, float]:
    p = service.phase_stats()
    return {"hash_s": p["hash_s"], "encode_s": p["encode_s"]}


def server_counts(server) -> Dict[str, float]:
    snap = server.metrics_snapshot()
    return {k: snap[k] for k in ("requests", "batches", "shed",
                                 "cache_hits", "coalesced")} | {
        "batched_entries": server.metrics.batched_entries}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def sleep_until(t: float) -> None:
    d = t - time.perf_counter()
    if d > 0:
        time.sleep(d)


class Served:
    """What the two serving drivers share: the work of the batches the
    traced window forwarded, the program's stop, and the check of the
    sampled answers against the reference."""

    def work(self, run, st, win):
        return [R.batch_work(run.cfg, np.stack(b)) for b in st["batches"]]

    def stop(self, st) -> None:
        st["server"].stop()

    def check(self, run, ans) -> Dict[str, float]:
        graphs, got = ans
        if not graphs:
            return {"pred_rel_err": float("inf")}
        ref = C.reference_predictions(graphs, run.cfg, run.vocab,
                                      run.params, run.stats, run.device)
        run.reference = ref
        return {"pred_rel_err": C.rel_err(got, ref)}


class TimedServer:
    """The server as a search sees it, with the time each thread spends
    inside ``predict_all`` and the rows it passes counted."""

    def __init__(self, server, tracer):
        self._server = server
        self._tracer = tracer
        self._tl = threading.local()

    @property
    def heads(self):
        return self._server.heads

    def resolve_target(self, target):
        return self._server.resolve_target(target)

    def counters(self):
        tl = self._tl
        if not hasattr(tl, "inside"):
            tl.inside, tl.rows = 0.0, 0
        return tl

    def predict_all(self, graphs):
        tl = self.counters()
        t0 = time.perf_counter()
        with self._tracer.span("bench.predict_all"):
            out = self._server.predict_all(graphs)
        tl.inside += time.perf_counter() - t0
        tl.rows += len(graphs)
        return out
