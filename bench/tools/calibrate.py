"""The readings a cell's limits are set from, on the chip, in one
process: for each seed, a run of the cell (a short window at its own
load and sizes) and the number each check compares, then the same
numbers with the plain reference put in the program's place in the
nearest lower precision (TF32 for float32: the control) and, for a
training cell, with the planted half-batch fault.

    python3 bench/tools/calibrate.py --workload base-search \\
        --seeds 1,2,3 --seconds 3

Prints one JSON line a seed and a summary line: the largest program
reading and the smallest control reading of each number.
"""
import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bench.run import prepare_env
    prepare_env()
    import torch
    from bench.harness import check as C
    from bench.harness import runner
    from bench.harness import spec as SP
    bench = SP.load_benchmark(ROOT)
    no_limit = None
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = runner.run_cell(bench, args.workload, seed, args.seconds,
                              False, args.device, limits=no_limit)
        run, ans = out["_run"], out["_answers"]
        prog = {k: v["value"] for k, v in out["check"].items()}
        if run.traffic["driver"] == "train":
            numbers = SP.driver("train").train_numbers
            prog = numbers(run, ans)
            ctl = numbers(run, ans, "tf32")
            fault = numbers(run, ans, "ieee", 0.5)
        else:
            graphs, _ = ans
            tf32 = C.reference_predictions(graphs, run.cfg, run.vocab,
                                           run.params, run.stats,
                                           torch.device(args.device),
                                           "tf32")
            ctl = {"pred_rel_err": C.rel_err(tf32, run.reference)}
            fault = {}
        row = {"seed": seed, "program": prog, "control": ctl,
               "half_batch": fault, "correct": out["correct"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for k in rows[0]["control"]:
        summary[k] = {
            "program_max": max(r["program"][k] for r in rows),
            "control_min": min(r["control"][k] for r in rows),
            "half_batch_min": min((r["half_batch"].get(k, math.inf)
                                   for r in rows), default=math.inf)}
    print(json.dumps({"summary": summary, "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
