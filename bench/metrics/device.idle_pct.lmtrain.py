"""Share of the traced steps' window with nothing on the card."""
from bench.harness import layers as L


def read(w):
    return L.idle_pct(w) if w["kind"] == "lmtrain" else None
