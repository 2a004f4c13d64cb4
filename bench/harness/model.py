"""What the benchmark makes from the seed and hands to both the program
and the plain reference: the vocabulary, the weights and the norm stats.

The weights are the leaves that the configuration's model kind lists
(``bench/models/<kind>.py``'s ``param_shapes``), drawn on the device
from a ``torch.Generator`` there, in one call.
"""
from __future__ import annotations

import random
from collections import Counter
from typing import Dict, Sequence

import numpy as np
import torch

from bench.harness import graphs as G
from bench.harness import spec as SP
from bench.reference import tokenizer as RT


def seeded_params(cfg: dict, seed: int, device) -> dict:
    """The param tree of the configuration's kind in the port's layout
    (``repro_torch.params``): float32 leaves on ``device``, drawn in one
    ``randn`` call there."""
    shapes = SP.model(cfg["kind"]).param_shapes(cfg)
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    tree: dict = {}
    off = 0
    for (path, shape, std), n in zip(shapes, sizes):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (flat[off:off + n] * std).view(shape)
        off += n
    return _lists(tree)


def _lists(node):
    """Dicts keyed 0..n-1 (a path's int keys) as lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def norm_stats(cfg: dict, seed: int) -> Dict[str, Dict[str, float]]:
    """Per-head (mu, sigma) of the log1p z-score the service denormalizes
    with: mu in [2, 4), sigma in [0.5, 1), so every prediction is a
    positive number well away from 0."""
    rng = np.random.default_rng([seed, 7])
    return {t: {"mu": float(rng.uniform(2.0, 4.0)),
                "sigma": float(rng.uniform(0.5, 1.0))}
            for t in cfg["heads"]}


def fit_vocab(cfg: dict, seed: int, n_graphs: int) -> Dict[str, int]:
    """Token -> id over a corpus of ``n_graphs`` sampled graphs drawn from
    the seed (apart from the traffic's draws), as a trained model's
    vocabulary would be fit: the specials first (PAD 0, UNK 1, BOS 2,
    EOS 3, SEP 4), then every opcode (fused included) and every shape
    token of the corpus, each in f32 and bf16 (the rewrites narrow
    intermediates), most frequent first, capped at ``vocab_size``. A
    token the traffic brings that the corpus lacked encodes as UNK, on
    both sides."""
    rng = random.Random(f"vocab/{seed}")
    fams = sorted(G.SAMPLERS)
    counts: Counter = Counter()
    for _ in range(n_graphs):
        counts.update(RT.graph_tokens(G.sample(rng, fams), cfg["mode"]))
    for tok in list(counts):
        if tok.endswith("xf32"):
            counts[tok[:-3] + "bf16"] += counts[tok]
    for op in G.OPCODES:
        counts[f"xpu.{op}"] += 1
    vocab = {t: i for i, t in enumerate(RT.SPECIALS)}
    for tok, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(vocab) >= cfg["vocab_size"]:
            break
        if tok not in vocab:
            vocab[tok] = len(vocab)
    return vocab


def tree_to(tree, device):
    """A copy of a param tree on ``device``, float32."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.detach().to(device=device, dtype=torch.float32).clone()


def families(traffic: dict) -> Sequence[str]:
    return sorted(traffic.get("families", sorted(G.SAMPLERS)))
