"""The scan's kernels' share of the card's busy time in the traced
steps."""
from bench.harness import trace as TR


def read(w):
    t = w["trace"]
    if w["kind"] != "lmtrain" or t is None or t["busy_s"] <= 0:
        return None
    sec, n = TR.kernel_seconds(t, "selective_scan_")
    return 100.0 * sec / t["busy_s"] if n else None
