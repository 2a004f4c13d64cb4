"""The knee sweep of an open-loop cell: one run at each offered rate,
in one process, on the chip.

    python3 bench/tools/sweep.py --workload base-serve-open \\
        --rates 1000,2000,4000 --seconds 5 --seed 7

Prints a JSON line a rate: requests offered, the share completed inside
the window, the gateway's queue depth at the window's middle and end,
p95 from due time, the generator's lateness. The knee is the highest
rate with at least 99% completed in the window and the end depth no
higher than the middle's.
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from bench.run import prepare_env
    prepare_env()
    import numpy as np
    from bench.harness import runner
    from bench.harness import spec as SP
    bench = SP.load_benchmark(ROOT)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        out = runner.run_cell(bench, args.workload, args.seed + k,
                              args.seconds, False, "cuda",
                              traffic_overrides={"rate_per_s": rate})
        win = out["_window"]["win"]
        late = win["late_s"] * 1e3
        print(json.dumps({
            "rate_per_s": rate, "offered": win["n"],
            "completed_share": win["completed_in_window"] / max(win["n"], 1),
            "depth_mid": win["depth"]["mid"],
            "depth_end": win["depth"]["end"],
            "p95_ms": SP.driver("open_loop").Driver().end_to_end(
                out["_run"], win)["query_p95_ms"],
            "failed": win["failed"], "correct": out["correct"],
            "entries_per_batch": win["server"]["batched_entries"]
            / max(win["server"]["batches"], 1),
            "p50_ms": float(np.median(win["lat_s"])) * 1e3,
            "late_ms_p99": float(np.percentile(late, 99)),
            "late_ms_p99_halves": [float(np.percentile(h, 99)) for h in
                                   np.array_split(late, 2)],
            "late_over_10ms": int((late > 10).sum()),
            "late_ms_max": float(late.max())}), flush=True)
        time.sleep(0.5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
