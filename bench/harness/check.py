"""The comparison that decides ``correct``: what the timed path served,
against the plain reference on the same graphs, vocabulary and weights.

The reference is the configuration's kind's,
``bench/reference/<kind>.py``. The number compared is the largest
relative gap, over the sampled answers and the three heads, between a
served prediction and the reference's (``pred_rel_err``). The
reference runs once the window has closed and the program's state is
freed, in blocks of rows, in IEEE float32; ``precision="tf32"``
computes the lower-precision control.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch

from bench.harness import spec as SP
from bench.reference import tokenizer as RT

BLOCK_ROWS = 256


def reference_predictions(graphs: Sequence, cfg: dict, vocab: Dict[str, int],
                          params: dict, stats: dict, device,
                          precision: str = "ieee") -> np.ndarray:
    """(len(graphs), n_heads) denormalized reference predictions, float64.
    Graphs are grouped by bucket and forwarded in blocks of rows."""
    by_len: Dict[int, List[int]] = defaultdict(list)
    ids = [RT.graph_ids(g, cfg, vocab) for g in graphs]
    for i, row in enumerate(ids):
        by_len[len(row)].append(i)
    out = np.zeros((len(graphs), len(cfg["heads"])), np.float64)
    RC = SP.reference(cfg["kind"])
    with torch.inference_mode():
        for _, rows in sorted(by_len.items()):
            for k in range(0, len(rows), BLOCK_ROWS):
                blk = rows[k:k + BLOCK_ROWS]
                x = torch.from_numpy(np.stack([ids[i] for i in blk])).to(
                    device)
                raw = RC.forward(params, x, precision)
                out[blk] = RC.denormalize(raw, stats,
                                          cfg["heads"]).numpy()
    return out


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest |got - ref| / |ref| over every entry (a NaN reads
    as inf)."""
    if got.size == 0:
        return float("inf")
    err = np.abs(np.asarray(got, np.float64) - ref) / np.abs(ref)
    return float(np.nan_to_num(err, nan=np.inf).max())


def sample_indices(n: int, sizes: Sequence[int], k: int, n_largest: int,
                   seed: int) -> np.ndarray:
    """Up to ``k`` of ``n`` answers drawn from the seed, always with the
    ``n_largest`` largest by ``sizes`` among them."""
    if n <= k:
        return np.arange(n)
    order = np.argsort(np.asarray(sizes), kind="stable")
    big = order[-n_largest:]
    rest = np.setdiff1d(np.arange(n), big)
    rng = np.random.default_rng([seed, 11])
    pick = rng.choice(rest, size=k - len(big), replace=False)
    return np.sort(np.concatenate([big, pick]))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` and whether every value is within
    its limit."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return {"numbers": out, "correct": bool(ok)}
