"""``open_loop``: single queries from many compile jobs. Poisson
arrivals at a fixed rate, each a fresh sampled graph sent through
``CostModelServer.submit``; a request is timed from when it was due to
when its prediction is in hand, and a shed or unanswered one counts as
+inf."""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, List

import numpy as np

from bench.harness import graphs as G
from bench.harness import model as M
from bench.harness import serving as S


class Driver(S.Served):
    kind = "serve"

    def setup(self, run) -> dict:
        tr = run.traffic
        fams = M.families(tr)
        service, server = S.program(run)
        batches = S.record_batches(service, run)
        server.start(warmup=True)
        S.warm_forward(service, run, fams, server.max_batch)
        arrivals = self.arrivals(tr, run.seed, run.seconds)
        graphs = self.graphs(tr, run.seed, len(arrivals))
        # the host path warmed at the cell's rate on graphs of its own
        rate = float(tr["rate_per_s"])
        wrng = random.Random(f"warmup/{run.seed}")
        warm = [G.sample(wrng, fams) for _ in range(tr["warmup_requests"])]
        t0 = time.perf_counter()
        futs = []
        for i, g in enumerate(warm):
            S.sleep_until(t0 + i / rate)
            futs.append(server.submit(g))
        for f in futs:
            f.result(timeout=60)
        return {"service": service, "server": server, "graphs": graphs,
                "arrivals": np.asarray(arrivals), "batches": batches}

    @staticmethod
    def arrivals(tr: dict, seed: int, seconds: float) -> np.ndarray:
        """Due times in [0, seconds): a Poisson process at ``rate_per_s``."""
        rng = random.Random(f"arrivals/{seed}")
        rate = float(tr["rate_per_s"])
        out, t = [], 0.0
        while True:
            t += rng.expovariate(rate)
            if t >= seconds:
                return np.asarray(out)
            out.append(t)

    @staticmethod
    def graphs(tr: dict, seed: int, n: int) -> list:
        """A fresh sampled graph a request."""
        fams = M.families(tr)
        rng = random.Random(f"graphs/{seed}")
        return [G.sample(rng, fams) for _ in range(n)]

    def window(self, run, st) -> dict:
        from repro_torch.core.server import ServerOverloadedError
        server, service, graphs = st["server"], st["service"], st["graphs"]
        n = len(graphs)
        done = np.full(n, np.nan)
        rows: List = [None] * n
        failed = np.zeros(n, bool)
        late = np.zeros(n)
        depth = {}

        def on_done(i, fut):
            done[i] = time.perf_counter()
            if fut.exception() is not None:
                failed[i] = True
            else:
                rows[i] = fut.result()

        go = threading.Event()
        clock: Dict[str, float] = {}

        def submitter():
            go.wait()
            due = clock["due"]
            for i, g in enumerate(graphs):
                S.sleep_until(due[i])
                late[i] = time.perf_counter() - due[i]
                try:
                    with run.tracer.span("bench.submit"):
                        fut = server.submit(g)
                except ServerOverloadedError:
                    failed[i] = True
                    continue
                fut.add_done_callback(lambda f, i=i: on_done(i, f))

        th = threading.Thread(target=submitter, name="bench-submitter")
        th.start()
        before = (S.server_counts(server), S.phase(service))
        run.tracer.start()
        t_start = time.perf_counter() + 0.005
        due = clock["due"] = t_start + st["arrivals"]
        t_mid, t_end = t_start + run.seconds / 2, t_start + run.seconds
        run.setup_s = t_start - run.t0
        run.recording = run.trace
        go.set()
        S.sleep_until(t_mid)
        depth["mid"] = server.queue_depth()
        S.sleep_until(t_end)
        depth["end"] = server.queue_depth()
        th.join()
        run.recording = False
        run.tracer.stop()
        after = (S.server_counts(server), S.phase(service))
        wait_until = time.perf_counter() + 60.0
        while np.isnan(done[~failed]).any() and \
                time.perf_counter() < wait_until:
            time.sleep(0.01)
        missing = np.isnan(done) & ~failed
        lat = np.where(failed | missing, np.inf, done - due)
        return {"n": n, "lat_s": lat, "late_s": late, "rows": rows,
                "failed": int((failed | missing).sum()),
                "completed_in_window": int((done <= t_end).sum()),
                "depth": depth,
                "server": S.delta(after[0], before[0]),
                "phase": S.delta(after[1], before[1])}

    def answers(self, run, st, win):
        """(graphs, served predictions) of the sampled answered requests."""
        ok = [i for i, r in enumerate(win["rows"]) if r is not None]
        sizes = [len(st["graphs"][i].ops) for i in ok]
        pick = run.sample(len(ok), sizes)
        idx = [ok[k] for k in pick]
        raw = np.stack([win["rows"][i] for i in idx]) if idx else \
            np.zeros((0, len(run.cfg["heads"])), np.float32)
        den = st["service"].denormalize_rows(raw)
        got = np.stack([den[t] for t in run.cfg["heads"]], axis=1)
        return [st["graphs"][i] for i in idx], got

    def end_to_end(self, run, win) -> Dict[str, float]:
        lat = np.sort(win["lat_s"])
        p95 = lat[int(np.ceil(0.95 * len(lat))) - 1] if len(lat) else \
            np.inf
        return {"query_p95_ms": float(p95) * 1e3}

    def attempted(self, win) -> int:
        return win["n"]

    def report(self, win) -> str:
        late = win["late_s"] * 1e3
        halves = [float(np.percentile(h, 99)) for h in
                  np.array_split(late, 2)]
        return (f"generator lateness ms: p50 {np.percentile(late, 50)} "
                f"p99 {np.percentile(late, 99)} (halves {halves}) max "
                f"{late.max()}; "
                f"requests {win['n']} completed in window "
                f"{win['completed_in_window']} queue depth mid "
                f"{win['depth']['mid']} end {win['depth']['end']}")
