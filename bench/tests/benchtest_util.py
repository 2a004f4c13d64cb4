"""What the benchmark's CPU tests share: the import paths, a small
harness run on the CPU, and throwaway traffic overrides."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# small sizes a CPU test run holds: a low rate, few warm-up graphs and
# searches, a small training corpus
SMALL = {
    "open_loop": {"rate_per_s": 60, "warmup_requests": 16,
                  "warmup_graphs": 200, "vocab_graphs": 300,
                  "check_sample": 48, "check_largest": 8},
    "closed_search": {"threads": 3, "warmup_searches": 2, "pool_per_s": 20,
                      "warmup_graphs": 100, "vocab_graphs": 300,
                      "check_sample": 8, "check_largest": 2},
    "train": {"corpus_graphs": 384, "warmup_steps": 4, "vocab_graphs": 300},
}


# the host-bound cells, whose drivers, mixes and configurations stay
# under bench/ while their end-to-end metrics spread too widely on the
# chip's host to hold a bound (PERF.md, Open questions): entries a
# later BENCHMARK.json adds as they stand
PARKED = {
    "configs": [{"name": "costmodel-operand",
                 "file": "bench/configs/costmodel-operand.json"}],
    "workloads": [
        {"name": "base-serve-open", "config": "costmodel-base",
         "traffic": "open-fresh-base", "chips": 1},
        {"name": "operand-serve-open", "config": "costmodel-operand",
         "traffic": "open-fresh-operand", "chips": 1},
        {"name": "base-search", "config": "costmodel-base",
         "traffic": "search-unoptimized", "chips": 1},
        {"name": "base-train", "config": "costmodel-base",
         "traffic": "train-bucketed", "chips": 1}],
}


def load_bench() -> dict:
    """``BENCHMARK.json`` with the parked cells and configurations that
    it does not list added."""
    from bench.harness import spec as SP
    bench = SP.load_benchmark(ROOT)
    for key, entries in PARKED.items():
        have = {e["name"] for e in bench[key]}
        bench[key] = bench[key] + [e for e in entries
                                   if e["name"] not in have]
    return bench


def run_small(cell: str, seed: int = 12345, seconds: float = 1.0,
              trace: bool = False, limits=None):
    """One harness run of ``cell`` on the CPU at test sizes (the look for
    a chip left out)."""
    import torch
    from bench.harness import runner
    from bench.harness import spec as SP
    torch.set_num_threads(2)
    bench = load_bench()
    driver = SP.traffic(SP.workload(bench, cell)["traffic"])["driver"]
    return runner.run_cell(bench, cell, seed, seconds, trace, "cpu",
                           limits=limits, traffic_overrides=SMALL[driver])
