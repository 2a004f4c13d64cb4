"""What a step of the LSTM recurrence kernel (``csrc/lstm_scan.cu``) is
spent on, measured on the card.

    PYTHONPATH=src python -m repro_torch.kernels.lstm_scan_variants

A probe, not a check. It builds copies of the kernel's source with one
design choice undone at a time (:data:`VARIANTS`, text substitutions:
each replaced text must occur exactly once in the source, so an edit
that moves it makes the probe fail and name it), and times each at
COSTMODEL_BASE's H=128, S=256, B in {64, 1}, float32, in turns with the
shipped kernel. It also times the shipped kernel alone with 1, 3, 10 and
30 launches a sample, each sample starting on an idle card, which
separates what a sample costs once from what each launch costs, and
beside its plain version with 3 and 10 launches a sample (chip_smoke.py
times K2's ``ms`` with 3), which shows whether the plain version in
between changes the kernel's time. It prints one JSON line for each
measurement and no verdict: a variant may compute another function, and
its error against the plain version is printed beside its time. It
needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import lstm_scan as K2
from repro_torch.kernels import ref as REF

_FAST_TANH = """
__device__ __forceinline__ float fast_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
"""

# name -> [(text of the source, its replacement)]
VARIANTS = {
    # the arrival with its default release semantics (MEMBAR.ALL.GPU)
    "release_cluster_barrier": [
        ("barrier.cluster.arrive.relaxed.aligned;",
         "barrier.cluster.arrive.aligned;")],
    # no cluster barrier in the loop, one at the exit: the mbarriers alone
    # order the steps (safe only where no lane is idle, as at H=128)
    "no_cluster_barrier": [
        ("        if (n > 0) cluster_wait();\n", ""),
        ("        cluster_arrive();", ""),
        ("      cluster_wait();\n    }",
         "      cluster_arrive();\n      cluster_wait();\n    }")],
    # approximate expf, division and tanhf (another function)
    "fast_math": [
        ("namespace {\n", "namespace {\n" + _FAST_TANH),
        ("return 1.f / (1.f + expf(-x));",
         "return __fdividef(1.f, 1.f + __expf(-x));"),
        ("gate == 2 ? tanhf(pre)", "gate == 2 ? fast_tanh(pre)"),
        ("og * tanhf(c)", "og * fast_tanh(c)")],
    # no h @ wh (another function: the gates see only x)
    "no_h_product": [("for (int r = 0; r < kSlice; r += 4) {",
                      "for (int r = 0; r < 0; r += 4) {")],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sample_ms(fn, reps: int) -> float:
    """ms per call of ``reps`` back-to-back calls, timed with CUDA events
    from an idle card."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(fa, fb, n_samples: int = 21, reps: int = 10) -> tuple:
    """Median ms per call of fa and fb, sampled in turns."""
    for _ in range(3):
        fa(), fb()
    ta, tb = [], []
    for i in range(n_samples):
        order = ((fa, ta), (fb, tb)) if i % 2 == 0 else ((fb, tb), (fa, ta))
        for fn, acc in order:
            acc.append(sample_ms(fn, reps))
    return float(np.median(ta)), float(np.median(tb))


def build_variant(source: str, name: str):
    """The ids entry (float32) of the source with variant ``name``
    applied, compiled beside the shipped library."""
    text = source
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} occurs "
                               f"{text.count(old)} times in lstm_scan.cu")
        text = text.replace(old, new)
    out_dir = _build.BUILD_DIR / "lstm_scan_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(text)
    _build._compile(cu, so)
    return name, _build.bind(ctypes.CDLL(str(so)), "lstm_scan_ids_f32",
                             K2._IDS_ARGS)


def long_ids(rng, B: int, S: int, vocab: int) -> np.ndarray:
    """Ids whose valid prefixes fill more than half of S, as the rows of
    the service's S bucket do."""
    ids = rng.integers(1, vocab, (B, S))
    lens = rng.integers(S // 2 + 1, S + 1, (B,))
    ids[np.arange(S)[None, :] >= lens[:, None]] = 0
    return ids.astype(np.int32)


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_scan_variants: needs a CUDA card", file=sys.stderr)
        return 1
    K2.max_hidden()                          # builds the shipped library
    source = (_build.CSRC / "lstm_scan.cu").read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(pool.map(lambda n: build_variant(source, n), VARIANTS))
    rng = np.random.default_rng(5)
    H, V, S = 128, 8192, 256
    table = torch.tensor(rng.normal(size=(V, 4 * H)) * 0.5,
                         dtype=torch.float32, device="cuda")
    wh = torch.tensor(rng.normal(size=(H, 4 * H)) * H ** -0.5,
                      dtype=torch.float32, device="cuda")
    for B in (64, 1):
        ids = torch.from_numpy(long_ids(rng, B, S, V)).cuda()
        longest = int((ids != 0).sum(1).max())
        want = REF.lstm_scan_ids_ref(table, ids, wh)
        out = torch.empty((B, H), device="cuda")

        def shipped():
            return K2._launch_ids(table, ids, wh)
        # a sample's fixed cost and a launch's: ms per call at 1 to 30
        # launches a sample, each from an idle card
        shipped()
        for reps in (1, 3, 10, 30):
            ms = float(np.median([sample_ms(shipped, reps)
                                  for _ in range(21)]))
            emit({"case": "launches_a_sample", "B": B, "S": S, "H": H,
                  "reps": reps, "ms": ms, "longest_row": longest})
        for reps in (3, 10):
            k_ms, p_ms = time_pair(
                shipped, lambda: REF.lstm_scan_ids_ref(table, ids, wh),
                n_samples=7, reps=reps)
            emit({"case": "beside_plain", "B": B, "S": S, "H": H,
                  "reps": reps, "ms": k_ms, "plain_ms": p_ms,
                  "longest_row": longest})
        for name, fn in fns.items():
            def variant(fn=fn):
                _build.launch(None, K2.LIB, fn, table.device,
                              (table.data_ptr(), ids.data_ptr(), V,
                               wh.data_ptr(), None, None, 0, B, S, H,
                               out.data_ptr(), None), K2._ERRORS,
                              (H, K2.max_hidden()))
            variant()
            err = float((out - want).abs().max())
            v_ms, k_ms = time_pair(variant, shipped)
            emit({"case": "variant", "variant": name, "B": B, "S": S,
                  "H": H, "ms": v_ms, "shipped_ms": k_ms,
                  "us_per_step": v_ms * 1e3 / longest,
                  "shipped_us_per_step": k_ms * 1e3 / longest,
                  "longest_row": longest, "max_abs_err": err})
    return 0


if __name__ == "__main__":
    sys.exit(main())
