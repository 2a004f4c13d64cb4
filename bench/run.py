"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. Loads,
warms up, measures for ``--seconds``, checks what the window produced
against the plain reference, and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` ``breakdown``, and last ``check``, each
number compared beside its limit. The numbers compared are also the last
lines of standard error. Without a CUDA card, or with JAX or the JAX
package loaded when the window has closed, it exits non-zero and prints
no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def prepare_env() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout; set before the program is imported."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        ROOT / "build" / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()

    import torch
    from bench.harness import roofline as R
    from bench.harness import runner
    from bench.harness import spec as SP

    bench = SP.load_benchmark(ROOT)
    cell = SP.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    seed = args.seed % (2 ** 63)
    out = runner.run_cell(bench, args.workload, seed, args.seconds,
                          bool(args.trace), "cuda", t0=T0)
    bad = runner.forbidden_modules()
    if bad:
        print(f"loaded when the window closed: {bad}", file=sys.stderr)
        return 3
    print(out["_report"], file=sys.stderr)
    if args.trace:
        print(f"peaks: {R.DATASHEET}; power.limit {power_limit()}",
              file=sys.stderr)
        from bench.harness import layers as L
        ffma = L.k1_roofline_pct(out["_window"], peak=R.PEAK_FFMA_FLOPS)
        print(f"K1 share of the FFMA-rate roofline (67 TFLOP/s, reading "
              f"only): {ffma!r} %", file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    line = {k: v for k, v in out.items() if not k.startswith("_")}
    print(json.dumps(line), flush=True)
    return 0


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


if __name__ == "__main__":
    sys.exit(main())
