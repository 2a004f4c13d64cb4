"""Model operations of the rows trained in the traced steps (three forwards
a row) over the traced time times the card's TF32 peak."""
from bench.harness import layers as L


def read(w):
    return L.mfu_pct(w) if w["kind"] == "train" else None
