"""Dataset builder: sampled graphs -> (tokens, targets) arrays + vocab.

Mirrors the paper's corpus: >20k MLIR functions from the five families plus
augmentation; ~10% held out for test. Rows carry the full MLIR text, the
input/output shapes (via shape tokens), and every target variable.

The build is streaming and two-pass ("count-then-encode"): pass 1 walks a
deterministic graph generator accumulating token counts (vocab fit), targets
and sequence lengths; pass 2 re-walks the same generator and encodes ids
directly into preallocated arrays. No pass holds more than one graph's
tokens, so corpus size is bounded by the *output* arrays, not the working
set — the corpus is no longer RAM-bound.

Two id layouts exist:

* ``layout="dense"`` (default) — one ``(N, max_seq)`` array, every row
  padded to the global ``max_seq``. The legacy layout; all in-memory
  callers keep working unchanged.
* ``layout="bucketed"`` — ids grouped by power-of-two sequence bucket
  (:func:`default_buckets`, the same ladder serving uses): bucket ``b``
  holds an ``(n_b, b)`` array plus the global row indices it covers.
  Mixed-length corpora store ~the sum of bucket lengths instead of
  ``N * max_seq``, and the train Loader batches bucket-homogeneously so
  each step jits one program per bucket instead of padding to ``max_seq``.
"""
from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import augment as AUG
from repro_torch.core import tokenizer as TOK
from repro_torch.ir import analyzers, printer, samplers
from repro_torch.ir.graph import Graph


def default_buckets(max_seq: int, min_bucket: int = 32) -> Tuple[int, ...]:
    """Power-of-two sequence-length buckets up to (and including) max_seq.

    Canonical definition — ``repro_torch.core.service`` re-exports it
    (serving and training share one bucket ladder)."""
    out = []
    b = min_bucket
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)


def bucket_lengths(seq_lens: np.ndarray, buckets: Tuple[int, ...],
                   pad_slack: int = 0) -> np.ndarray:
    """Per-row bucket length: the smallest bucket >= seq_len + pad_slack
    (rows longer than every bucket land in the largest)."""
    ladder = np.asarray(sorted(buckets))
    idx = np.searchsorted(ladder, np.asarray(seq_lens) + pad_slack)
    return ladder[np.minimum(idx, len(ladder) - 1)]


@dataclass
class CostDataset:
    # dense layout: (N, max_seq) int32 token ids; None when bucketed
    ids: Optional[np.ndarray]
    targets: Dict[str, np.ndarray]
    vocab: TOK.Vocab
    mode: str
    max_seq: int
    texts: Optional[List[str]] = None   # raw MLIR (kept for service demos)
    seq_lens: Optional[np.ndarray] = None  # true (pre-pad) token count/row
    # bucketed layout: bucket length -> (n_b, bucket) ids / global row idx
    bucket_ids: Optional[Dict[int, np.ndarray]] = None
    bucket_rows: Optional[Dict[int, np.ndarray]] = None

    @property
    def n(self) -> int:
        return len(next(iter(self.targets.values())))

    def __len__(self) -> int:
        return self.n

    # ------------------------------------------------------------ id access
    def get_seq_lens(self) -> np.ndarray:
        """True token count per row (derived from PAD=0 when not stored)."""
        if self.seq_lens is None:
            self.seq_lens = (self.dense_ids() != 0).sum(axis=1) \
                .astype(np.int32)
        return self.seq_lens

    def _row_map(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-global-row (bucket_len, local_index) for the bucketed
        layout; built once and cached (row_ids is the per-batch hot path)."""
        cached = getattr(self, "_row_map_cache", None)
        if cached is None:
            rb = np.zeros(self.n, np.int64)
            rl = np.zeros(self.n, np.int64)
            for b, rows in self.bucket_rows.items():
                rb[rows] = b
                rl[rows] = np.arange(len(rows))
            cached = self._row_map_cache = (rb, rl)
        return cached

    def row_ids(self, idx: np.ndarray, width: int) -> np.ndarray:
        """Gather rows ``idx`` as an (len(idx), width) id array, slicing or
        zero-padding (PAD id is 0) to ``width`` as needed."""
        from repro_torch.data.pipeline import fit_width
        idx = np.asarray(idx)
        if self.ids is not None:
            return fit_width(self.ids[idx], width)
        out = np.zeros((len(idx), width), np.int32)
        rb, rl = self._row_map()
        for b, arr in self.bucket_ids.items():
            sel = np.flatnonzero(rb[idx] == b)
            if not len(sel):
                continue
            w = min(b, width)
            out[sel, :w] = arr[rl[idx[sel]], :w]
        return out

    def dense_ids(self) -> np.ndarray:
        """The (N, max_seq) dense view (materialized for bucketed layouts)."""
        if self.ids is not None:
            return self.ids
        return self.row_ids(np.arange(self.n), self.max_seq)

    # ---------------------------------------------------------------- split
    def split(self, test_frac: float = 0.1, seed: int = 0):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.n)
        n_test = int(self.n * test_frac)
        te, tr = perm[:n_test], perm[n_test:]
        return self.take(tr), self.take(te)

    def take(self, idx: np.ndarray) -> "CostDataset":
        """Row subset (in ``idx`` order), preserving the id layout."""
        idx = np.asarray(idx)
        sub = dict(
            targets={k: v[idx] for k, v in self.targets.items()},
            vocab=self.vocab, mode=self.mode, max_seq=self.max_seq,
            seq_lens=None if self.seq_lens is None else self.seq_lens[idx])
        if self.ids is not None:
            return CostDataset(ids=self.ids[idx], **sub)
        new_index = np.full(self.n, -1, np.int64)
        new_index[idx] = np.arange(len(idx))
        b_ids, b_rows = {}, {}
        for b, rows in self.bucket_rows.items():
            keep = new_index[rows] >= 0
            if not keep.any():
                continue
            b_ids[b] = self.bucket_ids[b][keep]
            b_rows[b] = new_index[rows][keep]
        return CostDataset(ids=None, bucket_ids=b_ids, bucket_rows=b_rows,
                           **sub)

    # ------------------------------------------------------------------ io
    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {f"target_{k}": v for k, v in self.targets.items()}
        if self.seq_lens is not None:
            payload["seq_lens"] = self.seq_lens
        if self.ids is not None:
            payload["ids"] = self.ids
        else:
            for b in self.bucket_ids:
                payload[f"bucket_ids_{b}"] = self.bucket_ids[b]
                payload[f"bucket_rows_{b}"] = self.bucket_rows[b]
        np.savez_compressed(
            path, mode=self.mode, max_seq=self.max_seq,
            vocab=np.array(list(self.vocab.token_to_id.items()), object),
            **payload)

    @classmethod
    def load(cls, path: str) -> "CostDataset":
        z = np.load(path, allow_pickle=True)
        vocab = TOK.Vocab({k: int(v) for k, v in z["vocab"]})
        targets = {k[len("target_"):]: z[k] for k in z.files
                   if k.startswith("target_")}
        common = dict(targets=targets, vocab=vocab, mode=str(z["mode"]),
                      max_seq=int(z["max_seq"]),
                      seq_lens=z["seq_lens"] if "seq_lens" in z.files
                      else None)
        if "ids" in z.files:
            return cls(ids=z["ids"], **common)
        b_ids = {int(k[len("bucket_ids_"):]): z[k] for k in z.files
                 if k.startswith("bucket_ids_")}
        b_rows = {int(k[len("bucket_rows_"):]): z[k] for k in z.files
                  if k.startswith("bucket_rows_")}
        return cls(ids=None, bucket_ids=b_ids, bucket_rows=b_rows, **common)


def sample_graph_stream(n_graphs: int, *, augment_factor: int = 1,
                        seed: int = 0,
                        families: Optional[List[str]] = None,
                        rewrite_factor: int = 0
                        ) -> Iterator[Graph]:
    """Deterministic generator over sampled (+augmented) graphs.

    Two walks with the same arguments yield identical graphs — the
    count-then-encode build's contract.

    ``rewrite_factor`` additionally yields, per base graph, that many
    variants produced by short random ``repro_torch.opt`` rewrite sequences
    (fusion, CSE, DCE, recompute, bf16 narrowing, unrolling) with
    targets recomputed by the analyzers. This is how ``xpu.fused`` ops
    and ``...xbf16`` shape tokens get into training corpora — and hence
    the vocab — so a deployed model can rank the optimizer's candidate
    rewrites instead of seeing them as OOV text."""
    rng = np.random.default_rng(seed)
    fams = families or sorted(samplers.SAMPLERS)
    if rewrite_factor:
        from repro_torch.opt import rewrites as RW   # opt sits above ir
        rules = RW.default_rules()
    for i in range(n_graphs):
        g = samplers.sample_graph(rng, fams[i % len(fams)])
        yield g
        for _ in range(augment_factor - 1):
            yield AUG.augment(g, rng)
        for _ in range(rewrite_factor):
            yield RW.random_rewrite(g, rng, rules)


def build_dataset(n_graphs: int = 2000, *, mode: str = "ops",
                  max_seq: int = 256, vocab_size: int = 8192,
                  augment_factor: int = 1, seed: int = 0,
                  keep_texts: bool = False,
                  families: Optional[List[str]] = None,
                  layout: str = "dense",
                  rewrite_factor: int = 0) -> CostDataset:
    """Stream graphs, fit vocab from counts, encode, analyze.

    Pass 1 accumulates token counts, targets, lengths (and texts);
    pass 2 regenerates the same graphs and encodes ids straight into the
    output arrays — graphs and token sequences are never all in memory.
    """
    if layout not in ("dense", "bucketed"):
        raise ValueError(f"unknown layout {layout!r}")
    stream = dict(augment_factor=augment_factor, seed=seed,
                  families=families, rewrite_factor=rewrite_factor)
    counts: Counter = Counter()
    targets: Dict[str, List[float]] = {k: [] for k in analyzers.TARGETS}
    seq_lens: List[int] = []
    texts: Optional[List[str]] = [] if keep_texts else None
    for g in sample_graph_stream(n_graphs, **stream):
        toks = TOK.graph_tokens(g, mode)
        counts.update(toks)
        seq_lens.append(min(len(toks), max_seq))
        for k, v in analyzers.analyze(g).items():
            targets[k].append(v)
        if keep_texts:
            texts.append(printer.to_mlir(g))
    vocab = TOK.vocab_from_counts(counts, max_size=vocab_size)
    lens = np.asarray(seq_lens, np.int32)
    common = dict(
        targets={k: np.asarray(v, np.float32) for k, v in targets.items()},
        vocab=vocab, mode=mode, max_seq=max_seq, texts=texts, seq_lens=lens)

    if layout == "dense":
        # encode in bounded chunks through the vectorized encode_many
        # (one frozen-table lookup per chunk instead of a dict.get per
        # token) — the working set stays CHUNK sequences, not the corpus
        CHUNK = 512
        ids = np.zeros((len(lens), max_seq), np.int32)   # PAD id is 0
        buf: List[List[str]] = []
        row0 = 0
        for row, g in enumerate(sample_graph_stream(n_graphs, **stream)):
            buf.append(TOK.graph_tokens(g, mode))
            if len(buf) == CHUNK:
                ids[row0:row0 + len(buf)] = vocab.encode_many(buf, max_seq)
                row0 += len(buf)
                buf = []
        if buf:
            ids[row0:row0 + len(buf)] = vocab.encode_many(buf, max_seq)
        return CostDataset(ids=ids, **common)

    row_buckets = bucket_lengths(lens, default_buckets(max_seq))
    b_ids = {int(b): np.zeros((int(c), int(b)), np.int32)
             for b, c in zip(*np.unique(row_buckets, return_counts=True))}
    b_rows = {b: np.flatnonzero(row_buckets == b) for b in b_ids}
    cursor = {b: 0 for b in b_ids}
    for row, g in enumerate(sample_graph_stream(n_graphs, **stream)):
        b = int(row_buckets[row])
        b_ids[b][cursor[b]] = vocab.encode(TOK.graph_tokens(g, mode), b)
        cursor[b] += 1
    return CostDataset(ids=None, bucket_ids=b_ids, bucket_rows=b_rows,
                       **common)


def build_text_dataset(rows, *, max_seq: int = 1024,
                       vocab_size: int = 16384,
                       target: str = "latency_us") -> CostDataset:
    """Dataset from raw MLIR text (e.g. the StableHLO corpus from
    ir/stablehlo.py): rows = [(mlir_text, {target: value, ...}), ...].

    This is the paper's lower-dialect pathway — 'affine or scf ... much
    larger sequences of the order of thousands of tokens'."""
    from repro_torch.core import tokenizer as TOK
    token_seqs = [TOK.tokenize_text(text) for text, _ in rows]
    vocab = TOK.fit_vocab(token_seqs, max_size=vocab_size)
    ids = vocab.encode_many(token_seqs, max_seq)
    keys = rows[0][1].keys()
    targets = {k: np.asarray([t[k] for _, t in rows], np.float32)
               for k in keys}
    return CostDataset(ids=ids, targets=targets, vocab=vocab,
                       mode="text", max_seq=max_seq,
                       texts=[text for text, _ in rows],
                       seq_lens=np.asarray(
                           [min(len(t), max_seq) for t in token_seqs],
                           np.int32))


def normalize_targets(y: np.ndarray) -> Tuple[np.ndarray, Dict[str, float]]:
    """log1p + z-score; returns (normalized, stats for denorm)."""
    ly = np.log1p(y)
    mu, sigma = float(ly.mean()), float(ly.std() + 1e-8)
    return (ly - mu) / sigma, {"mu": mu, "sigma": sigma}


def denormalize(pred: np.ndarray, stats: Dict[str, float]) -> np.ndarray:
    return np.expm1(pred * stats["sigma"] + stats["mu"])


def normalize_targets_multi(
        targets: Dict[str, np.ndarray], heads: Tuple[str, ...]
) -> Tuple[Dict[str, np.ndarray], Dict[str, Dict[str, float]]]:
    """Per-target normalize_targets; stats keyed by target name."""
    ys, stats = {}, {}
    for t in heads:
        ys[t], stats[t] = normalize_targets(targets[t])
    return ys, stats


def stacked_normalized_targets(
        targets: Dict[str, np.ndarray], heads: Tuple[str, ...]
) -> Tuple[np.ndarray, Dict[str, Dict[str, float]]]:
    """Multi-target labels as one (N, len(heads)) float32 array.

    Column i is heads[i] — the contract the joint loss's ``y[:, i]``
    indexing consumes (the single place this ordering is encoded)."""
    ys, stats = normalize_targets_multi(targets, heads)
    y = np.stack([ys[t] for t in heads], axis=1).astype(np.float32)
    return y, stats
