#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    PYTHONPATH=src python3 chip_smoke.py     # (src/ is also added here)

Phases, each printing JSON lines:

1. ``device``  — the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints them (that raw line is printed too).
2. ``build``   — builds the CUDA kernel library from ``src/repro_torch/
   kernels/csrc`` and reports the seconds it took.
3. ``kernels`` — holds the fused conv forward kernel against its plain
   PyTorch version on the card (TF32 off), with ragged ids and one
   all-PAD row, both head layouts: COSTMODEL_BASE widths at S in {32,
   256}, B in {1, 5, 64}; COSTMODEL_OPERAND's (16,16,8,8,2,1) filter mix
   at S=1024 (several sequence tiles); bf16 params; and bit-identical
   rows for every batch size of the service's ladder up to 64. Params
   are drawn from a seed with every bias nonzero and the embedding
   scaled so the limit is tight, and the phase checks that the plain
   version with any group of biases zeroed misses the limit, so the
   parity checks can fail. Times the kernel and the plain version with
   CUDA events, and reports how far a TF32 plain version lands.
4. ``serve``   — the port's main path: ``build_dataset`` (300 graphs),
   random COSTMODEL_BASE multi-head params from a seed, a
   ``CostModelService(use_kernel=True)`` on the card behind a
   ``CostModelServer``, 256 requests from 8 client threads (half of them
   repeats). Checks that the kernel ran once for every batch the server
   flushed after warm-up, that rows are finite and equal a direct plain
   forward of the same ids, and that the LRU answered.

Then one ``{"kernels": [...]}`` line, and the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0 and no result line is printed; so does a machine without
a CUDA card, or a directory without the repository's ``src/``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

TOL = 2e-4              # float32 parity: accumulation order differs
SPEARMAN_MIN = 0.99     # bf16 params vs float32 params
# conv_init's 0.02-scale embedding leaves COSTMODEL_BASE's outputs small;
# x100 brings them to a few tenths, where 2e-4 is tight enough that a
# TF32 plain version misses it (the sensitivity line reports by how much)
EMB_SCALE = 100.0
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12            # HBM3
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/conv_forward.cu"
TPU_KERNEL = "src/repro/kernels/conv1d_stack.py:171"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def ragged_ids(rng, B: int, S: int, vocab: int):
    """Random ids with ragged valid lengths and row 0 all PAD."""
    import numpy as np
    ids = rng.integers(1, vocab, (B, S))
    lens = rng.integers(1, S + 1, (B,))
    ids[np.arange(S)[None, :] >= lens[:, None]] = 0
    ids[0] = 0
    return ids.astype(np.int32)


def seeded_params(cfg, heads, seed: int):
    """COSTMODEL-shaped params from a seed: conv_init's shapes and
    scales, the embedding scaled by EMB_SCALE so the 2e-4 limit is
    tight, and every bias drawn N(0, 0.1) where
    conv_init leaves it 0, so a kernel that drops a bias, or pads a
    layer's input with relu(bias), misses the limit."""
    import torch
    from repro_torch import params as P
    g = torch.Generator().manual_seed(seed)
    p = P.conv_init(cfg, heads, generator=g)
    p["emb"] = p["emb"] * EMB_SCALE
    for lyr in [*p["convs"], *p["fc"], *p.get("heads", {}).values()]:
        lyr["b"] = torch.randn(lyr["b"].shape, generator=g) * 0.1
    return p


def spearman(a, b) -> float:
    import numpy as np

    def ranks(x):
        r = np.empty(len(x))
        r[np.argsort(x, kind="stable")] = np.arange(len(x))
        return r
    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def bound_ms(ids, args) -> tuple:
    """Least time the card could take for one fused forward on ``ids``:
    the larger of operations over the float32 peak and bytes over the
    memory rate. Bytes: ids, the embedding rows these ids gather, every
    other param and the output, each once."""
    import torch
    emb, conv_ws, conv_bs, fc_ws, fc_bs, head_w, head_b = args
    B, S = ids.shape
    flops = sum(2 * S * w.shape[0] * w.shape[1] * w.shape[2]
                for w in conv_ws)
    flops += sum(2 * w.shape[0] * w.shape[1] for w in [*fc_ws, head_w])
    flops *= B
    n_rows = int(torch.unique(ids[ids != 0]).numel())
    others = sum(t.numel() * t.element_size() for t in
                 [*conv_ws, *conv_bs, *fc_ws, *fc_bs, head_w, head_b])
    nbytes = ids.numel() * 4 + n_rows * emb.shape[1] * emb.element_size() \
        + others + B * head_w.shape[1] * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def time_pair(fa, fb, n_samples: int = 21, reps: int = 10) -> tuple:
    """Median ms per call of fa and fb, timed in turns with CUDA events
    (each sample is ``reps`` back-to-back calls)."""
    import numpy as np
    import torch

    def sample(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    for _ in range(3):                              # warm-up
        fa(), fb()
    ta, tb = [], []
    for i in range(n_samples):
        for fn, acc in ((fa, ta), (fb, tb)) if i % 2 == 0 else \
                ((fb, tb), (fa, ta)):
            acc.append(sample(fn))
    return float(np.median(ta)), float(np.median(tb))


def phase_device() -> dict:
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return {"name": name, "nvidia_smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import _build, conv1d_stack
    t0 = time.perf_counter()
    conv1d_stack.build()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             _build.build_log(conv1d_stack.LIB).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas})


def phase_kernels() -> dict:
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import (COSTMODEL_BASE,
                                               COSTMODEL_OPERAND)
    from repro_torch.core.models import DEFAULT_HEADS
    from repro_torch.kernels import conv1d_stack as K
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    max_err = 0.0

    def params_for(cfg, heads, dtype=None):
        return P.from_numpy(seeded_params(cfg, heads, 1), dev, dtype)

    def compare(cfg, heads, S, B, dtype=None, label=""):
        nonlocal max_err
        p = params_for(cfg, heads, dtype)
        args, _ = ops.fused_args(p)
        ids = torch.from_numpy(ragged_ids(rng, B, S, cfg.vocab_size)).to(dev)
        got = K.conv_forward_fused(ids, *args)
        want = REF.conv_forward_fused_ref(ids, *args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.isfinite(got).all().item(), f"{label} finite")
        check(err <= TOL, f"{label} {cfg.name} S={S} B={B} err {err}")
        max_err = max(max_err, err)
        return {"case": label, "config": cfg.name, "heads": len(heads or
                (0,)), "S": S, "B": B, "max_abs_err": err}

    cases = []
    for heads in (DEFAULT_HEADS, None):
        for S in (32, 256):
            for B in (1, 5, 64):
                cases.append(compare(COSTMODEL_BASE, heads, S, B,
                                     label="base_f32"))
        cases.append(compare(COSTMODEL_OPERAND, heads, 1024, 5,
                             label="operand_f32"))
        cases.append(compare(COSTMODEL_BASE, heads, 256, 64,
                             torch.bfloat16, label="base_bf16"))
        cases.append(compare(COSTMODEL_OPERAND, heads, 1024, 5,
                             torch.bfloat16, label="operand_bf16"))
    for c in cases:
        emit({"phase": "kernels", **c})

    # the limit can fail: zeroing any group of biases in the plain
    # version moves it far outside 2e-4 of the kernel
    ids = torch.from_numpy(ragged_ids(rng, 64, 256, 8192)).to(dev)
    args, _ = ops.fused_args(params_for(COSTMODEL_BASE, DEFAULT_HEADS))
    got = K.conv_forward_fused(ids, *args)
    miss = {}
    for name, idx in (("conv", (2,)), ("fc", (4,)), ("head", (6,))):
        cut = list(args)
        for i in idx:
            cut[i] = [torch.zeros_like(b) for b in cut[i]] \
                if isinstance(cut[i], list) else torch.zeros_like(cut[i])
        miss[name] = float((REF.conv_forward_fused_ref(ids, *cut)
                            - got).abs().max())
        check(miss[name] > 10 * TOL, f"zeroed {name} biases only miss by "
              f"{miss[name]}: the parity limit cannot catch it")
    # TF32 in the plain version, against the kernel
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = float((REF.conv_forward_fused_ref(ids, *args) - got).abs().max())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "kernels", "case": "sensitivity",
          "zeroed_biases_err": miss, "tf32_plain_err": tf32,
          "out_abs_max": float(got.abs().max())})

    # bf16 params keep the f32 ranking of rows, per head
    ids = torch.from_numpy(ragged_ids(rng, 64, 256, 8192)).to(dev)
    a32, _ = ops.fused_args(params_for(COSTMODEL_BASE, DEFAULT_HEADS))
    a16, _ = ops.fused_args(params_for(COSTMODEL_BASE, DEFAULT_HEADS,
                                   torch.bfloat16))
    o32 = K.conv_forward_fused(ids, *a32).cpu().numpy()
    o16 = K.conv_forward_fused(ids, *a16).cpu().numpy()
    rho = [spearman(o32[1:, i], o16[1:, i]) for i in range(o32.shape[1])]
    check(min(rho) >= SPEARMAN_MIN, f"bf16 Spearman {rho}")
    emit({"phase": "kernels", "case": "bf16_spearman", "spearman": rho})

    # each row is bit-identical for every batch size of the ladder
    ladder = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
    for S in (32, 256):
        ids = torch.from_numpy(ragged_ids(rng, 64, S, 8192)).to(dev)
        full = K.conv_forward_fused(ids, *a32)
        same = all(torch.equal(K.conv_forward_fused(ids[:b].contiguous(),
                                                    *a32), full[:b])
                   for b in ladder)
        check(same, f"rows bit-identical across the batch ladder, S={S}")
        emit({"phase": "kernels", "case": "bit_identity", "S": S,
              "ladder": list(ladder), "identical": same})

    # times at the main path's widths, kernel and plain version in turns
    timings = {}
    for B in (64, 1):
        ids = torch.from_numpy(ragged_ids(rng, B, 256, 8192)).to(dev)
        with torch.inference_mode():
            k_ms, p_ms = time_pair(lambda: K._launch(ids, *a32),
                                   lambda: REF.conv_forward_fused_ref(
                                       ids, *a32))
            # the wrapper as the service calls it (ids checked on the
            # host) and with its device id check, which waits for the card
            w_ms, wc_ms = time_pair(
                lambda: K.conv_forward_fused(ids, *a32, check_ids=False),
                lambda: K.conv_forward_fused(ids, *a32))
        b_ms, by, flops, nbytes = bound_ms(ids, a32)
        timings[B] = {"B": B, "S": 256, "ms": k_ms, "plain_ms": p_ms,
                      "wrapper_ms": w_ms, "checked_wrapper_ms": wc_ms,
                      "bound_ms": b_ms, "bound_by": by,
                      "flops": flops, "bytes": nbytes}
        emit({"phase": "kernels", "case": "timing", **timings[B]})
    return {"max_abs_err": max_err, "timings": timings}


def phase_serve(card: str) -> dict:
    import numpy as np
    import torch
    from repro_torch import params as P
    from repro_torch.configs.costmodel import COSTMODEL_BASE
    from repro_torch.core.models import DEFAULT_HEADS
    from repro_torch.core.server import CostModelServer
    from repro_torch.core.service import CostModelService
    from repro_torch.ir import dataset as DS
    from repro_torch.ir import samplers
    from repro_torch.kernels import conv1d_stack as K
    from repro_torch.kernels import ref as REF

    t0 = time.perf_counter()
    ds = DS.build_dataset(300, mode="ops", max_seq=256, vocab_size=8192,
                          seed=0)
    _, stats = DS.normalize_targets_multi(ds.targets, DEFAULT_HEADS)
    params = seeded_params(COSTMODEL_BASE, DEFAULT_HEADS, 0)
    rng = np.random.default_rng(1)
    graphs = [samplers.sample_graph(rng) for _ in range(128)]
    setup_s = time.perf_counter() - t0

    svc = CostModelService("conv1d", COSTMODEL_BASE, params, ds.vocab,
                           stats, mode="ops", max_seq=256, max_batch=64,
                           use_kernel=True)
    server = CostModelServer(svc, max_batch=64, flush_us=2000)
    t1 = time.perf_counter()
    server.start(warmup=True)
    warm_s = time.perf_counter() - t1
    K.conv_forward_fused.launches = 0       # served batches from here on
    rows, lat = {}, []
    lock = threading.Lock()
    errors = []

    def client(k: int) -> None:
        mine = list(range(16 * k, 16 * k + 16))
        try:
            for i in mine + mine:                  # second pass: repeats
                ts = time.perf_counter()
                row = server.submit(graphs[i]).result(timeout=120)
                dt = time.perf_counter() - ts
                with lock:
                    rows[i] = row
                    lat.append(dt)
        except Exception as e:                     # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(8)]
    t2 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t2
    check(not any(t.is_alive() for t in threads), "client threads ended")
    check(not errors, f"client errors {errors[:3]}")
    preds = server.predict_all(graphs[:8])
    snap = server.metrics_snapshot()
    server.stop()
    launches = K.conv_forward_fused.launches

    check(len(rows) == len(graphs), "every graph answered")
    got = np.stack([rows[i] for i in range(len(graphs))])
    check(bool(np.isfinite(got).all()), "served rows finite")
    check(all(np.isfinite(v).all() for v in preds.values()),
          "denormalized predictions finite")
    check(snap["cache_hits"] > 0, f"LRU hits {snap['cache_hits']}")
    check(launches > 0 and launches == snap["batches"],
          f"one launch per served batch: {launches} launches, "
          f"{snap['batches']} batches")

    # served rows == a direct plain forward of the same ids (TF32 off)
    dev_p = P.from_numpy(params, "cuda")
    by_len = {}
    for i, g in enumerate(graphs):
        _, ids = svc.entry(g)
        by_len.setdefault(len(ids), []).append((i, ids))
    err = 0.0
    with torch.inference_mode():
        for group in by_len.values():
            idx = [i for i, _ in group]
            ids = torch.from_numpy(np.stack([x for _, x in group])).cuda()
            want = REF.conv_forward_ref(dev_p, ids)
            want = torch.stack([want[t] for t in svc.heads], 1).cpu().numpy()
            err = max(err, float(np.abs(got[idx] - want).max()))
    check(err <= TOL, f"served rows vs plain forward err {err}")
    lat_ms = np.asarray(lat) * 1e3
    out = {"phase": "serve", "requests": len(lat),
           "requests_per_s": len(lat) / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "server_p50_us": snap["latency_p50_us"],
           "server_p99_us": snap["latency_p99_us"],
           "cache_hits": snap["cache_hits"], "batches": snap["batches"],
           "batch_occupancy": snap["batch_occupancy"],
           "launches": launches, "max_abs_err_vs_plain": err,
           "setup_s": setup_s, "warmup_s": warm_s,
           "phase_forward_s": snap["phase_forward_s"], "card": card}
    emit(out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here outside a checkout)
    torch.backends.cudnn.allow_tf32 = False         # f32 yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = phase_device()
    phase_build()
    kern = phase_kernels()
    serve = phase_serve(dev["nvidia_smi"])
    t64, t1 = kern["timings"][64], kern["timings"][1]
    emit({"kernels": [{
        "name": "conv_forward_fused", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": serve["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": t64["ms"], "plain_ms": t64["plain_ms"],
        "bound_ms": t64["bound_ms"], "bound_by": t64["bound_by"],
        "library_ms": None,
        "kernel_ms": t64["ms"], "bound": "flops"
        if t64["bound_by"] == "operations" else "bytes",
        "shape": {"B": 64, "S": 256}, "wrapper_ms": t64["wrapper_ms"],
        "checked_wrapper_ms": t64["checked_wrapper_ms"],
        "b1": {k: t1[k] for k in ("ms", "plain_ms", "wrapper_ms",
                                  "checked_wrapper_ms", "bound_ms",
                                  "bound_by")},
        "card": dev["nvidia_smi"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
