"""MLIR tokenization — the paper's two schemes (Fig. 4).

* ``ops``           — opcode sequence + graph input/output tensor shapes;
                      operands dropped; each full shape is ONE token
                      (e.g. ``8x224x224x3xf32``).
* ``ops_operands``  — opcodes AND SSA operand names (``%3``, ``%arg1``) and
                      per-op output shape, in source order (~4x longer).

Unseen shape tokens or ``%k`` names become ``<unk>`` (the paper's OOV
failure mode, reproduced faithfully) — unless the vocab was built or
extended with the OOV machinery below, in which case they degrade
gracefully instead of collapsing onto a single id:

* **hash-bucketed unk shards** (``n_unk_buckets > 0``): an unseen token
  maps to ``<unk#crc32(token) % n>``, so distinct unseen ops/dtypes
  stay distinguishable to the model instead of aliasing onto one
  ``<unk>`` embedding. The shard hash is crc32 over the token's UTF-8
  bytes — deterministic across processes, unlike python ``hash()``, so
  a router-side featurizer and a replica encode identically.
* **byte fallback** (``byte_fallback=True``): short unseen tokens
  (<= :data:`BYTE_FALLBACK_MAX` UTF-8 bytes) expand to per-byte
  ``<0xNN>`` tokens, preserving their spelling end-to-end (the
  SentencePiece byte-fallback idea, applied to MLIR identifiers).

Both default OFF, so existing vocabs behave exactly as before; enable
via :func:`extend_vocab_oov` (post-hoc, on a trained vocab with spare
id capacity) or ``vocab_from_counts(..., n_unk_buckets=, byte_fallback=)``
at fit time. Every added id stays below the embedding-table cap the
caller passes, so a trained model serves extended vocabs unchanged.

The tokenizer also accepts raw MLIR *text* (e.g. StableHLO emitted by
a framework's lowering of a traced function) via :func:`tokenize_text` — a
whitespace/punctuation lexer that keeps opcodes, SSA names, and
``NxMxf32`` shapes as single tokens.
"""
from __future__ import annotations

import json
import re
import zlib
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence

import numpy as np

from repro_torch.ir.graph import Graph

PAD, UNK, BOS, EOS, SEP = "<pad>", "<unk>", "<bos>", "<eos>", "<sep>"
SPECIALS = [PAD, UNK, BOS, EOS, SEP]

# Longest unseen token (in UTF-8 bytes) the byte fallback will expand;
# longer ones (huge attribute blobs) go to an unk shard instead so one
# pathological token can't flood the sequence budget.
BYTE_FALLBACK_MAX = 16


def unk_shard_token(k: int) -> str:
    return f"<unk#{k}>"


def byte_token(b: int) -> str:
    return f"<0x{b:02X}>"


def shard_of(token: str, n_unk_buckets: int) -> int:
    """Deterministic unk-shard index (crc32, stable across processes)."""
    return zlib.crc32(token.encode("utf-8")) % n_unk_buckets

# Bare NxMx<dtype> shape tokens: the dtype alternation must cover every
# MLIR element type the corpus can emit — longer spellings first (``i16``
# before ``i1``, ``f64`` before ``f6``-style prefixes) so the regex never
# matches a prefix and shatters the rest of the shape into fragment
# tokens that become <unk>.
_SHAPE_DTYPES = r"(?:bf16|f64|f32|f16|i64|i32|i16|i8|i1)"
_TEXT_TOKEN_RE = re.compile(
    r"%[A-Za-z0-9_]+|\"[a-z_]+\.[a-z0-9_.]+\"|[a-z_]+\.[a-z0-9_.]+"
    r"|tensor<[^>]*>|\d+x[0-9x]*" + _SHAPE_DTYPES +
    r"|[A-Za-z_][A-Za-z0-9_]*")


def graph_tokens(g: Graph, mode: str = "ops") -> List[str]:
    """Token sequence for a Graph, per the paper's Fig. 4 layout."""
    toks = [BOS]
    # (2) input tensor shapes, each shape a single token
    for i in range(g.n_args):
        toks.append(g.values[i].shape_token())
    toks.append(SEP)
    if mode == "ops":
        # (1) the xpu.op sequence with per-op output shape; operand names
        # (and hence data dependence) dropped — paper's first scheme
        for op in g.ops:
            toks.append(f"xpu.{op.opcode}")
            toks.append(g.values[op.result].shape_token())
    elif mode == "ops_operands":
        for op in g.ops:
            toks.append(g.ssa_name(op.result))
            toks.append(f"xpu.{op.opcode}")
            toks.extend(g.ssa_name(o) for o in op.operands)
            toks.append(g.values[op.result].shape_token())
    else:
        raise ValueError(f"unknown mode {mode!r}")
    toks.append(SEP)
    # (3) output tensor shapes
    for o in g.outputs:
        toks.append(g.values[o].shape_token())
    toks.append(EOS)
    return toks


def tokenize_text(mlir_text: str) -> List[str]:
    """Lex raw MLIR text (StableHLO/affine dialects) into tokens; tensor
    types collapse to single shape tokens per the paper's policy."""
    toks = [BOS]
    for m in _TEXT_TOKEN_RE.finditer(mlir_text):
        t = m.group(0)
        if t.startswith("tensor<"):
            t = t[len("tensor<"):-1].replace("?", "D")
        toks.append(t.strip('"'))
    toks.append(EOS)
    return toks


@dataclass
class Vocab:
    token_to_id: Dict[str, int]
    # OOV machinery (0/False = legacy single-<unk> behavior). The shard
    # and byte tokens themselves live in token_to_id like any other
    # token; these fields just tell encode() how to resolve a miss.
    n_unk_buckets: int = 0
    byte_fallback: bool = False

    @property
    def size(self) -> int:
        return len(self.token_to_id)

    def _oov_ids(self, token: str) -> List[int]:
        """Ids for one out-of-vocabulary token; never raises. Byte
        fallback first (short tokens keep their spelling), then the
        crc32 unk shard, then the bare <unk>."""
        if self.byte_fallback:
            bs = token.encode("utf-8", "replace")
            if 0 < len(bs) <= BYTE_FALLBACK_MAX:
                ids = [self.token_to_id.get(byte_token(b)) for b in bs]
                if all(i is not None for i in ids):
                    return ids          # type: ignore[return-value]
        if self.n_unk_buckets > 0:
            i = self.token_to_id.get(
                unk_shard_token(shard_of(token, self.n_unk_buckets)))
            if i is not None:
                return [i]
        return [self.token_to_id[UNK]]

    @property
    def _oov_active(self) -> bool:
        return self.n_unk_buckets > 0 or self.byte_fallback

    def encode(self, tokens: Sequence[str], max_len: int) -> np.ndarray:
        """Sequences longer than ``max_len`` are silently truncated —
        serving layers that bucket-pad surface a truncation counter
        (see CostModelService.truncations) so drops stay observable.
        With the OOV machinery enabled, an unseen token may expand to
        several byte-fallback ids (before truncation)."""
        t2i = self.token_to_id
        unk = t2i[UNK]
        if not self._oov_active:
            ids = [t2i.get(t, unk) for t in tokens[:max_len]]
        else:
            ids = []
            for t in tokens:
                i = t2i.get(t)
                if i is not None:
                    ids.append(i)
                else:
                    ids.extend(self._oov_ids(t))
                if len(ids) >= max_len:
                    ids = ids[:max_len]
                    break
        out = np.full((max_len,), t2i[PAD], np.int32)
        out[:len(ids)] = ids
        return out

    def _frozen_table(self):
        """Sorted numpy token table for vectorized lookup, built lazily
        and rebuilt if the vocab dict grew (it never does in practice —
        vocabs are frozen after fit)."""
        tab = getattr(self, "_tab", None)
        if tab is None or tab[2] != len(self.token_to_id):
            toks = np.array(list(self.token_to_id.keys()))
            ids = np.fromiter(self.token_to_id.values(), np.int32,
                              len(self.token_to_id))
            order = np.argsort(toks)
            tab = (toks[order], ids[order], len(self.token_to_id))
            self._tab = tab
        return tab[0], tab[1]

    def encode_many(self, token_seqs: Sequence[Sequence[str]],
                    max_len: int) -> np.ndarray:
        """Vectorized batch encode -> (len(token_seqs), max_len) int32.

        One ``np.searchsorted`` over the frozen sorted token table
        replaces per-token ``dict.get`` calls; row-identical to
        :meth:`encode` (same truncation, PAD, and <unk> behavior).
        Rows that are fully in-vocabulary keep the vectorized fast path
        even when the OOV machinery is enabled; only rows containing an
        unseen token fall back to the per-row :meth:`encode` (shard /
        byte-fallback resolution is per-token python anyway)."""
        pad, unk = self.token_to_id[PAD], self.token_to_id[UNK]
        out = np.full((len(token_seqs), max_len), pad, np.int32)
        if not token_seqs:
            return out
        lens = np.fromiter((min(len(s), max_len) for s in token_seqs),
                           np.int64, len(token_seqs))
        flat = [t for s in token_seqs for t in s[:max_len]]
        if not flat:
            return out
        toks, ids_sorted = self._frozen_table()
        arr = np.asarray(flat)
        idx = np.minimum(np.searchsorted(toks, arr), len(toks) - 1)
        found = toks[idx] == arr
        vals = np.where(found, ids_sorted[idx], unk).astype(np.int32)
        rows = np.repeat(np.arange(len(token_seqs)), lens)
        cols = np.arange(int(lens.sum())) - np.repeat(
            np.cumsum(lens) - lens, lens)
        out[rows, cols] = vals
        if self._oov_active and not found.all():
            for r in np.unique(rows[~found]):
                out[r] = self.encode(token_seqs[r], max_len)
        return out

    def oov_rate(self, tokens: Sequence[str]) -> float:
        """Fraction of tokens absent from token_to_id. Shard / byte
        resolution does NOT change this number — it measures vocabulary
        drift on incoming traffic, not encoding failure (see
        :meth:`unk_fraction` for the latter)."""
        if not tokens:
            return 0.0
        return sum(t not in self.token_to_id for t in tokens) / len(tokens)

    def unk_fraction(self, ids: np.ndarray) -> float:
        """Fraction of non-PAD positions that collapsed onto the bare
        ``<unk>`` id. 0.0 on an OOV-extended vocab means every unseen
        token resolved to a shard or byte ids instead."""
        ids = np.asarray(ids)
        live = ids != self.token_to_id[PAD]
        n = int(live.sum())
        if n == 0:
            return 0.0
        return float((ids[live] == self.token_to_id[UNK]).sum()) / n

    def save(self, path: str) -> None:
        payload = {"token_to_id": self.token_to_id,
                   "n_unk_buckets": self.n_unk_buckets,
                   "byte_fallback": self.byte_fallback}
        with open(path, "w") as f:
            json.dump(payload, f)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            obj = json.load(f)
        if isinstance(obj.get("token_to_id"), dict):
            return cls(obj["token_to_id"],
                       n_unk_buckets=int(obj.get("n_unk_buckets", 0)),
                       byte_fallback=bool(obj.get("byte_fallback", False)))
        return cls(obj)              # legacy format: the plain id dict


def extend_vocab_oov(v: Vocab, n_unk_buckets: int = 32,
                     byte_fallback: bool = True,
                     max_size: int = 0) -> Vocab:
    """Append the OOV machinery tokens to a (trained) vocab.

    Returns a NEW Vocab sharing no dict with ``v``; ids already present
    keep their values, so a model trained on ``v`` serves the extension
    unchanged. ``max_size`` (usually the model's ``cfg.vocab_size``,
    i.e. its embedding-table row count) caps the grown vocab — the
    extension must fit in the trained model's id range or the new ids
    would index past the embedding table."""
    t2i = dict(v.token_to_id)
    want = [unk_shard_token(k) for k in range(n_unk_buckets)]
    if byte_fallback:
        want += [byte_token(b) for b in range(256)]
    new = [t for t in want if t not in t2i]
    if max_size and len(t2i) + len(new) > max_size:
        raise ValueError(
            f"OOV extension needs {len(t2i) + len(new)} ids but the "
            f"embedding table caps at {max_size}; shrink n_unk_buckets "
            f"or refit the vocab with headroom")
    for t in new:
        t2i[t] = len(t2i)
    return Vocab(t2i, n_unk_buckets=n_unk_buckets,
                 byte_fallback=byte_fallback)


def vocab_from_counts(counts: Counter, max_size: int = 8192,
                      min_count: int = 1, n_unk_buckets: int = 0,
                      byte_fallback: bool = False) -> Vocab:
    """Build a Vocab from pre-accumulated token counts (the streaming
    count-then-encode path: pass 1 counts, pass 2 encodes). With
    ``n_unk_buckets`` / ``byte_fallback``, the OOV machinery tokens are
    reserved FIRST so they always fit under ``max_size``."""
    vocab = {t: i for i, t in enumerate(SPECIALS)}
    for k in range(n_unk_buckets):
        vocab[unk_shard_token(k)] = len(vocab)
    if byte_fallback:
        for b in range(256):
            vocab[byte_token(b)] = len(vocab)
    for tok, c in counts.most_common():
        if len(vocab) >= max_size:
            break
        if c >= min_count and tok not in vocab:
            vocab[tok] = len(vocab)
    return Vocab(vocab, n_unk_buckets=n_unk_buckets,
                 byte_fallback=byte_fallback)


def fit_vocab(token_seqs: Iterable[Sequence[str]],
              max_size: int = 8192, min_count: int = 1,
              n_unk_buckets: int = 0,
              byte_fallback: bool = False) -> Vocab:
    counts: Counter = Counter()
    for seq in token_seqs:
        counts.update(seq)
    return vocab_from_counts(counts, max_size=max_size,
                             min_count=min_count,
                             n_unk_buckets=n_unk_buckets,
                             byte_fallback=byte_fallback)
