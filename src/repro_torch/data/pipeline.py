"""Data-pipeline helpers shared by the dataset layer.

Only :func:`fit_width` is here for now; the sharded, prefetching
``Loader`` arrives with the training slice.
"""
from __future__ import annotations

import numpy as np


def fit_width(arr: np.ndarray, width: int) -> np.ndarray:
    """Trim or zero-pad (PAD id 0) the trailing dim to ``width``. The one
    place the pad convention for id rows lives (ir/dataset.py reuses it)."""
    if arr.shape[1] == width:
        return arr
    if arr.shape[1] > width:
        return np.ascontiguousarray(arr[:, :width])
    out = np.zeros((arr.shape[0], width), arr.dtype)
    out[:, :arr.shape[1]] = arr
    return out
