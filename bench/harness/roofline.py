"""Operations and bytes of a cost model's work, and the H100's peaks:
the yardstick of every roofline and ``mfu`` share.

A row's operations and the weights' bytes are the model kind's
(``bench/models/<kind>.py``; conv1d's are ``chip_smoke.py``'s
``bound_ms`` counts, frozen there). A row that carries a request counts
at its bucket's width (the max-pool covers the padded positions, so
they are part of the model's work); the all-PAD rows that pad a batch
up to the service's batch ladder do not count, so a kernel that
computes fewer of them never reads as doing less work. Each input
byte is read once and each output byte written once: the ids, the
embedding rows they gather, every other weight, the predictions.
Training counts three forwards a row.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from bench.harness import spec as SP

DATASHEET = ("NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5, dense: "
             "TF32 tensor core 495 TFLOP/s, FP32 67 TFLOP/s, HBM3 "
             "3.35 TB/s, at the 700 W limit")
# float32 inputs reach at most the TF32 tensor-core rate, on any route
PEAK_FLOPS = 495e12
# the FFMA rate outside the tensor cores, for reading only
PEAK_FFMA_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def batch_work(cfg: dict, ids: np.ndarray) -> Tuple[int, int]:
    """(operations, bytes) of one forward over ``ids``, the (n, S) rows
    that carry requests (no ladder padding)."""
    kind = SP.model(cfg["kind"])
    n, seq = ids.shape
    gathered = int(np.unique(ids[ids != 0]).size)
    nbytes = (ids.size * F32 + gathered * cfg["embed_dim"] * F32
              + kind.weight_bytes(cfg) + n * len(cfg["heads"]) * F32)
    return n * kind.row_flops(cfg, seq), nbytes


def least_seconds(work: Iterable[Tuple[int, int]],
                  peak: float = PEAK_FLOPS) -> float:
    """The least time the card could take for these launches, each bound
    by the larger of its operations over ``peak`` and its bytes over
    the memory rate."""
    return sum(max(f / peak, b / PEAK_BYTES) for f, b in work)
