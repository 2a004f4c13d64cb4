"""Where the time of the fused conv forward kernel (K1,
``csrc/conv_forward.cu`` on ``csrc/conv_tile.cuh``) goes, measured on
the card.

    PYTHONPATH=src python -m repro_torch.kernels.conv_tile_probe

A probe, not a check: it prints one JSON line for each measurement and
no verdict. At COSTMODEL_BASE's shape (fs=2 convs, FC 256 and 64, 3
heads), S=256, float32, B in {1, 4, 64}, with every width (embedding
and conv channels) C in {64 (COSTMODEL_BASE's), 32, 16}, it times K1
with the first L = 1..6 conv layers of the tower and the FC stack, and
with all six layers and no hidden FC layer (heads straight after the
pool): the slope over L is what a layer costs, the rest what a launch
costs whatever its depth, and the FC stack's share is the difference
of the last two. A layer's cost across C says whether a tap is bound
by its work (C^2 per position) or by what it costs whatever its work.
Each of these times is the card's alone (:func:`time_queued`). Last,
the host's time for one wrapper call at B=4 beside the PyTorch calls
it makes or could make (an allocation, the current stream as an object
or as a raw handle, the device guard, the current device). It needs a
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from repro_torch.kernels import conv1d_stack as K


def time_queued(fn, n_samples: int = 11, reps: int = 10) -> tuple:
    """(device ms, host ms) per call of fn, medians: each sample's calls
    are queued behind a kernel that spins for a few ms, so the CUDA
    events around them see the card's time alone, and the host clock
    around the loop sees the host's time to issue them."""
    for _ in range(3):                              # warm-up
        fn()
    dev_ms, host_ms = [], []
    for _ in range(n_samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(10_000_000)               # ~5 ms of spinning
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms.append((time.perf_counter() - t0) * 1e3 / reps)
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end) / reps)
    return float(np.median(dev_ms)), float(np.median(host_ms))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("conv_tile_probe needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale,
                            dtype=torch.float32, device=dev)

    V, S = 8192, 256
    for C in (64, 32, 16):
        emb = rand(V, C)
        conv_w = [rand(2, C, C, scale=C ** -0.5) for _ in range(6)]
        conv_b = [rand(C, scale=0.1) for _ in range(6)]
        fc_w = [rand(C, 256, scale=C ** -0.5), rand(256, 64, scale=1 / 16)]
        fc_b = [rand(256, scale=0.1), rand(64, scale=0.1)]
        head_w, head_b = rand(64, 3, scale=1 / 8), rand(3, scale=0.1)
        head_c = rand(C, 3, scale=C ** -0.5)         # heads after the pool
        for B in (1, 4, 64):
            ids = torch.from_numpy(rng.integers(1, V, (B, S)).astype(
                np.int32)).to(dev)
            for L in range(1, 7):
                ms, host = time_queued(lambda: K._launch(
                    ids, emb, conv_w[:L], conv_b[:L], fc_w, fc_b, head_w,
                    head_b))
                print(json.dumps({
                    "B": B, "channels": C, "conv_layers": L, "fc_layers": 2,
                    "device_ms": ms, "host_ms": host,
                    "plan": K.plan(B, S, C, [2] * L, [C] * L,
                                   [256, 64])}), flush=True)
            ms, host = time_queued(lambda: K._launch(
                ids, emb, conv_w, conv_b, [], [], head_c, head_b))
            print(json.dumps({"B": B, "channels": C, "conv_layers": 6,
                              "fc_layers": 0, "device_ms": ms,
                              "host_ms": host}), flush=True)
    # the host's share of a launch: the whole wrapper call beside the
    # PyTorch calls it makes (COSTMODEL_BASE's widths, B=4)
    def device_guard():
        with torch.cuda.device(dev):
            pass
    steps = {
        "launch": lambda: K._launch(ids4, emb, conv_w, conv_b, fc_w, fc_b,
                                    head_w, head_b),
        "torch_empty": lambda: torch.empty((4, 3), device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "device_guard": device_guard,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "current_device": torch.cuda.current_device,
    }
    C = 64
    emb = rand(V, C)
    conv_w = [rand(2, C, C, scale=C ** -0.5) for _ in range(6)]
    conv_b = [rand(C, scale=0.1) for _ in range(6)]
    fc_w = [rand(C, 256, scale=C ** -0.5), rand(256, 64, scale=1 / 16)]
    fc_b = [rand(256, scale=0.1), rand(64, scale=0.1)]
    head_w, head_b = rand(64, 3, scale=1 / 8), rand(3, scale=0.1)
    ids4 = torch.from_numpy(rng.integers(1, V, (4, S)).astype(
        np.int32)).to(dev)
    for name, fn in steps.items():
        per = []
        for _ in range(11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            per.append((time.perf_counter() - t0) * 1e3 / 100)
        print(json.dumps({"host_step": name, "host_ms": float(
            np.median(per))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
