"""What the per-layer metrics' readers share: each reader in
``bench/metrics/`` checks that its cell's kind matches and calls one of
these on the window's readings. A function returns None where the
window holds nothing to read (no trace, no batch, no kernel)."""
from __future__ import annotations

from typing import Optional

from bench.harness import roofline as R
from bench.harness import trace as TR

K1_KERNEL = "conv_forward_kernel"


def k1_roofline_pct(w, peak: float = R.PEAK_FLOPS) -> Optional[float]:
    """K1's share of its roofline: the least time for the batches it
    served in the traced window over its device time there."""
    t = w["trace"]
    if t is None or not w["work"]:
        return None
    sec, _ = TR.kernel_seconds(t, K1_KERNEL)
    if sec <= 0:
        return None
    return 100.0 * R.least_seconds(w["work"], peak) / sec


def mfu_pct(w) -> Optional[float]:
    """Model operations of the work done in the traced window (served
    rows, or trained rows at three forwards each), over the window times
    the card's peak."""
    t = w["trace"]
    if t is None or not w["work"] or t["window_s"] <= 0:
        return None
    flops = sum(f for f, _ in w["work"])
    return 100.0 * flops / (t["window_s"] * R.PEAK_FLOPS)


def idle_pct(w) -> Optional[float]:
    """Share of the traced window in which nothing ran on the card."""
    t = w["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def featurize_us(w) -> Optional[float]:
    """The service's hashing and encoding, host time a graph submitted
    in the window."""
    n = w["win"]["server"]["requests"]
    if not n:
        return None
    ph = w["win"]["phase"]
    return 1e6 * (ph["hash_s"] + ph["encode_s"]) / n


def entries_per_batch(w) -> Optional[float]:
    s = w["win"]["server"]
    return s["batched_entries"] / s["batches"] if s["batches"] else None
