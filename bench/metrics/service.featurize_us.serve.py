"""Host microseconds of the service's hashing and encoding a graph
submitted (phase_stats hash_s + encode_s)."""
from bench.harness import layers as L


def read(w):
    return L.featurize_us(w) if w["kind"] == "serve" else None
