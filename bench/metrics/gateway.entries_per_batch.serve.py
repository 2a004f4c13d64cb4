"""Entries a forward batch the gateway flushed in the window (ServerMetrics
batched_entries / batches)."""
from bench.harness import layers as L


def read(w):
    return L.entries_per_batch(w) if w["kind"] == "serve" else None
