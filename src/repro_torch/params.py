"""Weight bridge: parameter trees between numpy and torch.

A parameter tree is a plain dict with the reference layout:

* ``emb`` ``(V, E)``;
* ``convs[i]`` ``{"w": (fs, Cin, Cout), "b": (Cout,)}``;
* ``fc[i]`` ``{"w": (Fin, Fout), "b": (Fout,)}``;
* multi-head: ``heads[t]`` ``{"w": (F, 1), "b": (1,)}``, one per target;
  single-head: no ``heads`` key, ``fc[-1]`` is the scalar head;
* the LSTM instead of ``convs``/``fc``: ``wx`` ``(E, 4H)``, ``wh``
  ``(H, 4H)``, ``b`` ``(4H,)``, and ``heads[t]`` or, single-head, one
  ``head`` ``{"w": (H, 1), "b": (1,)}``.

Dict keys keep their names through every conversion, so a consumer maps
head outputs by name and never by position (a tree that went through a
key-sorting transform lists its heads in another order).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _sorted_items(tree):
    """(path part, child) pairs in the reference's flatten order: dict
    keys sorted at every level, lists and tuples in order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def tree_flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` in the reference's flatten order; a path
    is the keys and indices joined by ``/`` (``"0/convs/0/b"``), as the
    reference's checkpoint names them. ``None`` is an empty subtree and
    gives no leaf."""
    if tree is None:
        return []
    if not isinstance(tree, (dict, list, tuple)):
        return [(prefix, tree)]
    out = []
    for part, child in _sorted_items(tree):
        out += tree_flatten_with_paths(
            child, f"{prefix}/{part}" if prefix else part)
    return out


def tree_flatten(tree) -> list:
    """The leaves in the reference's flatten order (not insertion
    order, as :func:`tree_leaves` walks): what the checkpoint files and
    the optimizer's leaf pairing use."""
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_unflatten(like, leaves):
    """Rebuild ``like``'s structure from ``leaves`` given in
    :func:`tree_flatten` order. Dicts keep ``like``'s key order, so head
    names come back in the order they went in."""
    leaves = list(leaves)
    n = len(tree_flatten(like))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """numpy (or tensor) leaves -> torch tensors on ``device``.

    ``dtype`` casts the floating leaves only (the bf16 serving cast);
    integer leaves keep their type."""
    def conv(a):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device).contiguous()
    return tree_map(conv, tree)


def to_numpy(tree):
    """torch (or numpy) leaves -> numpy arrays (bf16 widens to float32:
    numpy has no bfloat16)."""
    def conv(t):
        if not torch.is_tensor(t):
            return np.asarray(t)
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(conv, tree)


def _normal(shape, scale: float, generator: torch.Generator):
    return torch.randn(shape, generator=generator) * scale


def _fan_in_scale(shape) -> float:
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    return 1.0 / float(np.sqrt(fan_in))


def conv_init(cfg, heads: Optional[Sequence[str]] = None, *,
              generator: torch.Generator):
    """Conv1D+MaxPool+FC params with the reference's shapes and scales:
    embedding N(0, 0.02); conv taps N(0, 1/(fs*Cin)); FC and head weights
    N(0, 1/fan_in); zero biases. float32, on the CPU (the service places
    them). The random bits differ from the reference's generator, so
    parity tests carry the reference's params across instead."""
    p = {"emb": _normal((cfg.vocab_size, cfg.embed_dim), 0.02, generator),
         "convs": []}
    c_in = cfg.embed_dim
    for fs, c_out in zip(cfg.conv_filters, cfg.conv_channels):
        p["convs"].append({
            "w": _normal((fs, c_in, c_out), 1.0 / float(np.sqrt(fs * c_in)),
                         generator),
            "b": torch.zeros((c_out,))})
        c_in = c_out
    dims = [c_in, *cfg.fc_dims] + ([] if heads else [1])
    p["fc"] = []
    for i in range(len(dims) - 1):
        shape = (dims[i], dims[i + 1])
        p["fc"].append({"w": _normal(shape, _fan_in_scale(shape), generator),
                        "b": torch.zeros((dims[i + 1],))})
    if heads:
        f = cfg.fc_dims[-1]
        p["heads"] = {t: {"w": _normal((f, 1), _fan_in_scale((f, 1)),
                                       generator),
                          "b": torch.zeros((1,))} for t in heads}
    return p


def lstm_init(cfg, heads: Optional[Sequence[str]] = None, *,
              generator: torch.Generator):
    """LSTM params with the reference's shapes and scales: embedding
    N(0, 0.02); input and recurrent weights ``wx`` (E, 4H) and ``wh``
    (H, 4H), gates in i, f, g, o order, N(0, 1/fan_in); zero gate bias
    ``b`` (4H,); per-target heads (H, 1) in ``heads``, or one ``head`` in
    the single-head layout. float32, on the CPU."""
    h = cfg.lstm_hidden

    def weight(shape):
        return _normal(shape, _fan_in_scale(shape), generator)
    p = {"emb": _normal((cfg.vocab_size, cfg.embed_dim), 0.02, generator),
         "wx": weight((cfg.embed_dim, 4 * h)),
         "wh": weight((h, 4 * h)),
         "b": torch.zeros((4 * h,))}
    if heads:
        p["heads"] = {t: {"w": weight((h, 1)), "b": torch.zeros((1,))}
                      for t in heads}
    else:
        p["head"] = {"w": weight((h, 1)), "b": torch.zeros((1,))}
    return p
