"""One run of one cell: set-up, the measured window, the check, and the
result's line.

:func:`run_cell` is the whole of a run but the look for a chip and the
printing, so that tests can drive it on the CPU with the timed path
broken underneath.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from bench.harness import check as C
from bench.harness import model as M
from bench.harness import spec as SP
from bench.harness import trace as TR

# top-level module names that must not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    bench: dict
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    tracer: Any = None
    params: Any = None
    stats: Any = None
    vocab: Any = None
    recording: bool = False
    setup_s: float = 0.0

    def sample(self, n: int, sizes) -> np.ndarray:
        return C.sample_indices(n, sizes, self.traffic["check_sample"],
                                self.traffic["check_largest"], self.seed)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t0: Optional[float] = None,
             limits: Optional[Dict[str, float]] = None,
             traffic_overrides: Optional[dict] = None) -> dict:
    """One run of cell ``name``; returns the result's fields (``metrics``
    and ``device`` filled in as far as this device can read them) and
    ``check`` with each number compared beside its limit."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = SP.workload(bench, name)
    cfg = SP.config(bench, cell["config"])
    traffic = dict(SP.traffic(cell["traffic"]), **(traffic_overrides or {}))
    dev = torch.device(device)
    run = Run(bench, cell, cfg, traffic, seed, seconds, trace, dev, t0)
    run.tracer = TR.Tracer(trace, dev)
    driver = SP.driver(traffic["driver"]).Driver()
    run.vocab = M.fit_vocab(cfg, seed, traffic["vocab_graphs"])
    run.params = M.seeded_params(cfg, seed, dev)
    run.stats = M.norm_stats(cfg, seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = driver.setup(run)
    gc.freeze()                 # the inputs made in set-up leave the GC
    win = driver.window(run, state)
    gc.unfreeze()
    mem_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    answers = driver.answers(run, state, win)
    reduced = TR.reduce(run.tracer)
    window = {"kind": driver.kind, "cfg": cfg, "seconds": seconds,
              "win": win, "trace": reduced,
              "work": driver.work(run, state, win)}
    driver.stop(state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check(run, answers)
    numbers["unanswered"] = float(win["failed"])
    lim = dict(cfg["limits"][driver.kind], unanswered=0.0) \
        if limits is None else dict(limits, unanswered=0.0)
    verdict = C.verdict(numbers, lim)
    if trace:
        metrics = SP.read_per_layer(bench, name, window)
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        vals = dict(driver.end_to_end(run, win), setup_s=run.setup_s)
        metrics = {m["name"]: {"value": float(vals[m["name"]]),
                               "unit": units[m["name"]]}
                   for m in SP.cell_metrics(bench, name, "end_to_end")}
    out = {"correct": verdict["correct"],
           "attempted": int(driver.attempted(win)),
           "failed": int(win["failed"]), "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(mem_peak)}}
    if trace and reduced is not None:
        out["device"]["busy_s"] = reduced["busy_s"]
        out["device"]["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    out["check"] = verdict["numbers"]
    out["_report"] = driver.report(win)
    out["_window"] = window
    out["_answers"] = answers
    out["_run"] = run
    return out
