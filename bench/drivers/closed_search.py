"""``closed_search``: a parallel build's optimizer. Threads each run
``opt.search.beam_search`` on a fresh unoptimized graph through one
server, the next search as soon as the last returns; the search is
handed a timing proxy of the server, which counts the time and the rows
inside ``predict_all``."""
from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Dict

import numpy as np

from bench.harness import graphs as G
from bench.harness import model as M
from bench.harness import serving as S


class Driver(S.Served):
    kind = "search"

    def setup(self, run) -> dict:
        tr = run.traffic
        fams = M.families(tr)
        service, server = S.program(run)
        batches = S.record_batches(service, run)
        server.start(warmup=True)
        S.warm_forward(service, run, fams, server.max_batch)
        rng = random.Random(f"pool/{run.seed}")
        n_pool = int(tr["pool_per_s"] * run.seconds) + tr["threads"]
        pool = [G.unoptimized_ir(G.sample(rng, fams), rng)
                for _ in range(n_pool)]
        wrng = random.Random(f"warmup/{run.seed}")
        warm = [G.unoptimized_ir(G.sample(wrng, fams), wrng)
                for _ in range(tr["warmup_searches"])]
        proxy = S.TimedServer(server, run.tracer)
        self._warm(proxy, warm, tr)
        return {"service": service, "server": server, "pool": pool,
                "batches": batches, "proxy": proxy}

    @staticmethod
    def _searches(proxy, pool, tr, stop_at):
        """Start ``tr["threads"]`` search threads over ``pool``, each
        starting searches until ``stop_at``. Returns the threads and
        what they fill in: ``done`` (pool index -> (start, end, result,
        self seconds, rows costed)), ``errors``, ``exhausted``."""
        from repro_torch.opt.search import beam_search
        nxt = itertools.count()
        got: dict = {"done": {}, "errors": [], "exhausted": []}

        def worker():
            tl = proxy.counters()
            while time.perf_counter() < stop_at:
                i = next(nxt)
                if i >= len(pool):
                    got["exhausted"].append(i)
                    return
                in0, rows0 = tl.inside, tl.rows
                t0 = time.perf_counter()
                try:
                    with proxy._tracer.span("bench.beam_search"):
                        res = beam_search(
                            proxy, pool[i], beam_width=tr["beam_width"],
                            max_steps=tr["max_steps"],
                            max_candidates=tr["max_candidates"],
                            eval_budget=tr["eval_budget"])
                except Exception as e:         # counted as failed
                    got["errors"].append(e)
                    got["done"][i] = (t0, time.perf_counter(), None, 0.0, 0)
                    continue
                t1 = time.perf_counter()
                got["done"][i] = (t0, t1, res,
                                  (t1 - t0) - (tl.inside - in0),
                                  tl.rows - rows0)

        threads = [threading.Thread(target=worker, name=f"bench-search-{k}")
                   for k in range(tr["threads"])]
        for th in threads:
            th.start()
        return threads, got

    def _warm(self, proxy, warm, tr) -> None:
        threads, got = self._searches(proxy, warm, tr,
                                      time.perf_counter() + 3600.0)
        for th in threads:
            th.join()
        if got["errors"]:
            raise got["errors"][0]

    def window(self, run, st) -> dict:
        server, service = st["server"], st["service"]
        before = (S.server_counts(server), S.phase(service))
        run.tracer.start()
        t_start = time.perf_counter()
        run.setup_s = t_start - run.t0
        t_end = t_start + run.seconds
        run.recording = run.trace
        threads, got = self._searches(st["proxy"], st["pool"],
                                      run.traffic, t_end)
        S.sleep_until(t_end)
        run.recording = False
        run.tracer.stop()
        for th in threads:
            th.join()
        after = (S.server_counts(server), S.phase(service))
        if got["exhausted"]:
            raise RuntimeError(
                f"the pool of {len(st['pool'])} graphs ran out before the "
                f"window closed; raise pool_per_s in the traffic file")
        done = got["done"]
        ok = [v for v in done.values() if v[1] <= t_end and v[2] is not None]
        return {"n": len(done), "failed": len(got["errors"]),
                "errors": [repr(e) for e in got["errors"][:3]],
                "completed": len(ok), "done": done,
                "self_s": sum(v[3] for v in ok),
                "rows": sum(v[4] for v in ok),
                "server": S.delta(after[0], before[0]),
                "phase": S.delta(after[1], before[1])}

    def answers(self, run, st, win):
        """(graphs, returned predictions): the root and the best graph of
        each sampled finished search, with the predictions it returned."""
        res = [v[2] for _, v in sorted(win["done"].items())
               if v[2] is not None]
        pick = run.sample(len(res), [len(r.best.ops) for r in res])
        graphs, got = [], []
        for k in pick:
            r = res[k]
            for g, preds in ((r.root, r.root_preds), (r.best, r.best_preds)):
                graphs.append(g)
                got.append([preds[t] for t in run.cfg["heads"]])
        return graphs, np.asarray(got, np.float64).reshape(
            len(graphs), len(run.cfg["heads"]))

    def end_to_end(self, run, win) -> Dict[str, float]:
        return {"searches_per_s": win["completed"] / run.seconds}

    def attempted(self, win) -> int:
        return win["n"]

    def report(self, win) -> str:
        return (f"searches started {win['n']} completed in window "
                f"{win['completed']} failed {win['failed']} "
                f"{win['errors']}")
