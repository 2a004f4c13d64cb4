"""Model operations served in the traced window over the window times the
card's TF32 peak."""
from bench.harness import layers as L


def read(w):
    return L.mfu_pct(w) if w["kind"] == "serve" else None
