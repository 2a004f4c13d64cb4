"""The readings an ``lmtrain`` cell's limits are set from, on the chip,
in one process: for each seed, a run of the cell (a short window) and the
training check's numbers of the program, then of each control the plain
reference gives with a fault in the program's place
(``bench/drivers/lm_train.py``'s ``CONTROLS``: a bfloat16 scan state,
the inner norms left out, the state restarted at each chunk, half of
each batch's rows left out).

    python3 bench/tools/calibrate_lm.py --workload jamba2-3b-train-s4096 \\
        --seeds 1,2,3 --seconds 5 [--controls 1]

Prints one JSON line a seed and a summary line: the largest program
reading and the smallest reading of each control, number by number.
Each seed's line also gives every leaf's gap of the first gradient's
norm and of the change's over its own reference norm (``leaf_gaps``).
``--plant`` runs the program once more on the first seed for each of
two planted faults, a scan whose gradient of A (``dA``) or of D
(``dD``) is doubled, and prints their numbers.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", type=int, default=1,
                    help="controls on the first N seeds (all: -1)")
    ap.add_argument("--plant", action="store_true",
                    help="the planted dA and dD faults on the first seed")
    args = ap.parse_args(argv)
    from bench.run import prepare_env
    prepare_env()
    import torch
    from bench.drivers import lm_train as LT
    from bench.harness import runner
    from bench.harness import spec as SP
    bench = SP.load_benchmark(ROOT)
    rows = []
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        out = runner.run_cell(bench, args.workload, seed, args.seconds,
                              False, "cuda", limits={})
        run, ans = out["_run"], out["_answers"]
        row = {"seed": seed, "run_s": time.perf_counter() - t0,
               "program": LT.lm_numbers(run, ans),
               "leaf_gaps": leaf_gaps(run, ans),
               "memory_peak_bytes": out["device"]["memory_peak_bytes"],
               "report": out["_report"], "setup_s": run.setup_s}
        if args.controls < 0 or i < args.controls:
            for fault in LT.CONTROLS:
                row[fault] = LT.lm_numbers(run, ans, fault)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out, run, ans
        torch.cuda.empty_cache()
        if args.plant and i == 0:
            for arg in ("dA", "dD"):
                with planted(arg):
                    out = runner.run_cell(bench, args.workload, seed,
                                          args.seconds, False, "cuda",
                                          limits={})
                run, ans = out["_run"], out["_answers"]
                print(json.dumps({"seed": seed, "planted": arg,
                                  "program": LT.lm_numbers(run, ans),
                                  "leaf_gaps": leaf_gaps(run, ans)}),
                      flush=True)
                del out, run, ans
                torch.cuda.empty_cache()
    summary = {}
    for k in rows[0]["program"]:
        summary[k] = {"program_max": max(r["program"][k] for r in rows)}
        for fault in LT.CONTROLS:
            got = [r[fault][k] for r in rows if fault in r]
            if got:
                summary[k][f"{fault}_min"] = min(got)
    print(json.dumps({"summary": summary, "seeds": len(rows)}), flush=True)
    return 0


def leaf_gaps(run, ans) -> dict:
    """Each leaf's |program - reference| / reference of the first
    gradient's norm and of the change's norm, by the leaf's path."""
    from bench.drivers import lm_train as LT
    from bench.reference import train as RTR
    names = [n for n, _ in RTR.leaves(LT.first_params(run))]
    r = ans["_ref"]
    return {n: [float(abs(g - rg) / rg), float(abs(d - rd) / rd)]
            for n, g, rg, d, rd in zip(names, ans["gn"], r["gn"], ans["dn"],
                                       r["dn"])}


class planted:
    """Inside, ``models.mamba.selective_scan`` doubles the gradient of
    its A (``"dA"``) or D (``"dD"``) input."""

    def __init__(self, arg: str):
        self.at = {"dA": 2, "dD": 5}[arg]

    def __enter__(self):
        import torch
        from repro_torch.models import mamba
        self.mamba, self.plain = mamba, mamba.selective_scan

        class Double(torch.autograd.Function):
            """The identity, whose backward doubles the gradient."""
            @staticmethod
            def forward(ctx, t):
                return t.view_as(t)

            @staticmethod
            def backward(ctx, g):
                return 2 * g

        def wrong(*ins):
            ins = list(ins)
            ins[self.at] = Double.apply(ins[self.at])
            return self.plain(*ins)
        mamba.selective_scan = wrong
        return self

    def __exit__(self, *exc):
        self.mamba.selective_scan = self.plain
        return False


if __name__ == "__main__":
    sys.exit(main())
