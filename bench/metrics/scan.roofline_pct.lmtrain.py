"""The scan kernel's share of its roofline in the traced steps: the
least time its forward and backward entries could take, each bound by
its bytes at the card's memory rate (``bench/models/jamba.py``'s
``scan_bytes``), over the device time of the scan's kernels (forward,
backward and the backward's sums)."""
from bench.harness import roofline as R
from bench.harness import trace as TR


def read(w):
    t = w["trace"]
    if w["kind"] != "lmtrain" or t is None:
        return None
    sec, _ = TR.kernel_seconds(t, "selective_scan_")
    _, n_fwd = TR.kernel_seconds(t, "selective_scan_fwd_k")
    _, n_bwd = TR.kernel_seconds(t, "selective_scan_bwd_k")
    if sec <= 0:
        return None
    from bench.models import jamba
    win = w["win"]
    fwd, bwd = jamba.scan_bytes(win["rows_per_step"], win["seq"],
                                win["d_inner"], win["d_state"])
    return 100.0 * (n_fwd * fwd + n_bwd * bwd) / R.PEAK_BYTES / sec
