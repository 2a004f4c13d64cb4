"""A frozen copy of the paper's two tokenizations (Fig. 4) and of the
service's bucketing, over any object with a graph's fields.

* ``ops``: BOS, each argument's shape, SEP, then each op's opcode
  (``xpu.<op>``) and its result's shape, SEP, each output's shape, EOS.
* ``ops_operands``: as ``ops``, but each op is its result's SSA name,
  its opcode, its operands' SSA names and its result's shape.

A shape is one token (``8x224x224x3xf32``); SSA names are ``%arg<i>``
for arguments and ``%<k>`` for op results. Ids come from the vocabulary
the benchmark made; a token outside it is UNK; PAD (id 0) fills the
bucket. A graph's bucket is the smallest of the power-of-two ladder
(32 up to ``max_seq``) that holds its tokens plus the conv tower's pad
slack, ``2 * sum(fs // 2)``; longer sequences are cut to ``max_seq``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

PAD, UNK, BOS, EOS, SEP = "<pad>", "<unk>", "<bos>", "<eos>", "<sep>"
SPECIALS = [PAD, UNK, BOS, EOS, SEP]


def shape_token(t) -> str:
    dims = "x".join(str(d) for d in t.shape)
    return f"{dims}x{t.dtype}" if t.shape else t.dtype


def ssa_name(g, vid: int) -> str:
    return f"%arg{vid}" if vid < g.n_args else f"%{vid - g.n_args}"


def graph_tokens(g, mode: str) -> List[str]:
    toks = [BOS]
    toks += [shape_token(g.values[i]) for i in range(g.n_args)]
    toks.append(SEP)
    for op in g.ops:
        if mode == "ops":
            toks += [f"xpu.{op.opcode}", shape_token(g.values[op.result])]
        elif mode == "ops_operands":
            toks += [ssa_name(g, op.result), f"xpu.{op.opcode}"]
            toks += [ssa_name(g, o) for o in op.operands]
            toks.append(shape_token(g.values[op.result]))
        else:
            raise ValueError(f"unknown mode {mode!r}")
    toks.append(SEP)
    toks += [shape_token(g.values[o]) for o in g.outputs]
    toks.append(EOS)
    return toks


def buckets(max_seq: int, min_bucket: int = 32) -> List[int]:
    out, b = [], min_bucket
    while b < max_seq:
        out.append(b)
        b *= 2
    return out + [max_seq]


def pad_slack(conv_filters: Sequence[int]) -> int:
    return 2 * sum(fs // 2 for fs in conv_filters)


def bucket_of(n_tokens: int, cfg: dict) -> int:
    slack = pad_slack(cfg["conv_filters"])
    for b in buckets(cfg["max_seq"]):
        if n_tokens + slack <= b:
            return b
    return cfg["max_seq"]


def encode(tokens: Sequence[str], vocab: Dict[str, int],
           length: int) -> np.ndarray:
    unk = vocab[UNK]
    ids = [vocab.get(t, unk) for t in tokens[:length]]
    out = np.full((length,), vocab[PAD], np.int64)
    out[:len(ids)] = ids
    return out


def graph_ids(g, cfg: dict, vocab: Dict[str, int]) -> np.ndarray:
    """One graph's ids at its bucket's width."""
    toks = graph_tokens(g, cfg["mode"])
    return encode(toks, vocab, bucket_of(len(toks), cfg))
