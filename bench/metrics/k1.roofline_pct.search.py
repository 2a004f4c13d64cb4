"""K1's share of its roofline in the traced window (device time by kernel
name)."""
from bench.harness import layers as L


def read(w):
    return L.k1_roofline_pct(w) if w["kind"] == "search" else None
