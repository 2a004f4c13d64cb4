"""The device trace of a traced window, reduced to what the per-layer
metrics and the result's ``device`` and ``breakdown`` read.

``torch.profiler`` records the card's activity (kernels, copies,
memsets) and the host's PyTorch ops and the benchmark's own spans
(``record_function``). Busy time is the union of the device intervals;
an idle gap is labelled by the host span or op that covered most of it.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

N_TOP = 10
N_GAPS = 400            # the longest gaps get a label


class Tracer:
    """Starts and stops the profiler around a window; the host-clock
    length of the window is ``window_s``."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self._t0 = 0.0

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def span(self, name: str):
        """A host span in the trace (a no-op when not tracing)."""
        if self.prof is None:
            return _NULL
        return torch.profiler.record_function(name)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(tracer: Tracer) -> Optional[dict]:
    """What the trace shows, or None when nothing ran on a device:
    ``busy_s`` (union of device intervals), ``window_s``, ``kernels``
    ({name: seconds}), ``launches`` ({name: count}), ``device_ops`` and
    ``idle_gaps`` (the breakdown's two lists, each at most 10)."""
    if tracer.prof is None:
        return None
    dev, host = [], []
    for e in tracer.prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    if not dev:
        return None
    busy_iv = _union([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy_iv) / 1e6
    kernels: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for name, s, e in dev:
        kernels[name] += (e - s) / 1e6
        launches[name] += 1
    gaps = sorted(((busy_iv[i + 1][0] - busy_iv[i][1], busy_iv[i][1],
                    busy_iv[i + 1][0]) for i in range(len(busy_iv) - 1)),
                  reverse=True)[:N_GAPS]
    host.sort()
    starts = [h[0] for h in host]
    longest = max((h[1] - h[0] for h in host), default=0.0)
    idle: Dict[str, float] = defaultdict(float)
    for dur, s, e in gaps:
        best, cover = "host Python, no torch op or span", 0.0
        lo = bisect.bisect_left(starts, s - longest)
        hi = bisect.bisect_right(starts, e)
        for hs, he, name in host[lo:hi]:
            ov = min(he, e) - max(hs, s)
            if ov > cover:
                best, cover = name, ov
        idle[best] += dur / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:N_TOP]
    return {"busy_s": busy_s, "window_s": tracer.window_s,
            "kernels": dict(kernels), "launches": dict(launches),
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:N_TOP]]}


def kernel_seconds(trace: dict, needle: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``needle``."""
    sec = sum(s for n, s in trace["kernels"].items() if needle in n)
    cnt = sum(c for n, c in trace["launches"].items() if needle in n)
    return sec, cnt
