"""Sharded, deterministic, prefetching data pipeline.

Design mirrors production input pipelines (tf.data/grain style) without the
dependency: a Source yields indexable records; the Loader owns a deterministic
shuffle (seeded per epoch), shards by (host, data-parallel rank), batches, and
prefetches on a background thread. Every batch is tagged with (epoch, step)
so a restarted job resumes mid-epoch from the checkpointed cursor — the
fault-tolerance contract (see runtime/fault.py).

Bucket-aware batching: pass ``bucket_by`` (a per-row sequence-bucket length)
and each batch's ``ids`` are trimmed/padded to a bucket instead of the
global ``max_seq``, so a train step runs one shape per bucket (the same
trick serving uses; see core/service.py). Two modes:

* ``bucket_mode="batch_max"`` (default) — the global shuffle is untouched
  (batch composition is **identical** to unbucketed loading) and each batch
  is padded to the smallest bucket covering its longest member. Because
  every model family's output is invariant to padding beyond its bucket
  (incl. the conv pad-slack rule), training is gradient-identical to
  max_seq padding — just faster.
* ``bucket_mode="homogeneous"`` — batches are drawn from rows of a single
  bucket (per-bucket shuffle -> fixed-size batches -> shuffled batch
  order). Maximum step-time win, but batches become length-correlated,
  which on length-correlated targets adds gradient noise; prefer
  ``batch_max`` when eval parity with padded training matters.

Either way the epoch plan is a pure function of (seed, epoch), so the
(epoch, step) cursor contract — and checkpoint/resume determinism — is
unchanged. Numpy only: the same seed, shard and bucket mode give the
reference's batches, in its order, and :func:`synthetic_lm_batches`
gives the reference's token stream bit for bit.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np


class ArraySource:
    """In-memory record source over parallel arrays (e.g. ids + targets)."""

    def __init__(self, **arrays: np.ndarray):
        lens = {len(v) for v in arrays.values()}
        assert len(lens) == 1, "all arrays must share leading dim"
        self.arrays = arrays
        self.n = lens.pop()

    def __len__(self):
        return self.n

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}


class FnSource:
    """Record source over a gather function (e.g. bucket-grouped storage
    that materializes rows on demand); ``fn(idx) -> {key: array}``."""

    def __init__(self, n: int, fn: Callable[[np.ndarray],
                                            Dict[str, np.ndarray]]):
        self.n = n
        self.fn = fn

    def __len__(self):
        return self.n

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return self.fn(idx)


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


@dataclass
class LoaderState:
    epoch: int = 0
    step_in_epoch: int = 0

    def as_dict(self):
        return {"epoch": self.epoch, "step_in_epoch": self.step_in_epoch}


class Loader:
    """Deterministic sharded loader with background prefetch.

    drop_remainder=False keeps each epoch's tail batch (per bucket, in
    bucketed mode), trimmed to a multiple of ``num_shards`` so every
    shard still sees the same local batch size within a step.
    """

    def __init__(self, source, batch_size: int, *,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1,
                 drop_remainder: bool = True, prefetch: int = 2,
                 bucket_by: Optional[np.ndarray] = None,
                 bucket_mode: str = "batch_max",
                 width_key: str = "ids",
                 state: Optional[LoaderState] = None):
        assert batch_size % num_shards == 0
        assert bucket_mode in ("batch_max", "homogeneous"), bucket_mode
        self.source = source
        self.global_batch = batch_size
        self.local_batch = batch_size // num_shards
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.bucket_by = None if bucket_by is None \
            else np.asarray(bucket_by)
        self.bucket_mode = bucket_mode
        self.width_key = width_key
        self.state = state or LoaderState()
        self._plan: Optional[Tuple[int, List]] = None   # (epoch, batches)
        if self.bucket_by is not None:
            assert len(self.bucket_by) == len(source), \
                "bucket_by must give one bucket length per source row"

    # ------------------------------------------------------------- planning
    def _chop(self, rows: np.ndarray, width: Optional[int], out: List):
        gb, ns = self.global_batch, self.num_shards
        n_full = len(rows) // gb
        for i in range(n_full):
            out.append((rows[i * gb:(i + 1) * gb], width))
        if not self.drop_remainder:
            tail = rows[n_full * gb:]
            tail = tail[:len(tail) - len(tail) % ns]
            if len(tail):
                out.append((tail, width))

    def _epoch_plan(self, epoch: int) -> List[Tuple[np.ndarray,
                                                    Optional[int]]]:
        """Batches of one epoch: a pure function of (seed, epoch)."""
        cached = self._plan   # single read: producer thread may swap it
        if cached is not None and cached[0] == epoch:
            return cached[1]
        rng = np.random.default_rng((self.seed, epoch))
        batches: List[Tuple[np.ndarray, Optional[int]]] = []
        if self.bucket_by is None:
            self._chop(rng.permutation(len(self.source)), None, batches)
        elif self.bucket_mode == "batch_max":
            # same permutation -> same batch composition as unbucketed;
            # only the pad width shrinks to the batch's largest bucket
            self._chop(rng.permutation(len(self.source)), None, batches)
            batches = [(idx, int(self.bucket_by[idx].max()))
                       for idx, _ in batches]
        else:
            # buckets too small for even one batch promote their rows to
            # the next bucket up (wider pad, but the rows stay trainable;
            # without this a small bucket would be excluded every epoch)
            carried = np.empty((0,), np.int64)
            ladder = np.unique(self.bucket_by)
            for j, b in enumerate(ladder):
                rows = np.concatenate(
                    [carried, np.flatnonzero(self.bucket_by == b)])
                if len(rows) < self.global_batch and j < len(ladder) - 1:
                    carried = rows
                    continue
                carried = np.empty((0,), np.int64)
                self._chop(rng.permutation(rows), int(b), batches)
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        self._plan = (epoch, batches)
        return batches

    def steps_per_epoch(self) -> int:
        return len(self._epoch_plan(self.state.epoch))

    # ------------------------------------------------------------- batching
    def _make_batch(self, epoch: int, step: int) -> Dict[str, np.ndarray]:
        idx, width = self._epoch_plan(epoch)[step]
        local = idx[self.shard_index::self.num_shards]
        batch = self.source.gather(local)
        if width is not None and self.width_key in batch:
            # a bucket is always >= every member row's true length, so
            # trimming only ever removes padding
            batch[self.width_key] = fit_width(batch[self.width_key], width)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # validate eagerly on the consumer thread: an empty plan would
        # otherwise kill the producer and leave the consumer blocked forever
        if not self._epoch_plan(self.state.epoch):
            raise ValueError(
                f"empty epoch: no batch of {self.global_batch} rows can be "
                f"formed from {len(self.source)} source rows (lower "
                f"batch_size or pass drop_remainder=False)")
        return self._iterate()

    def _iterate(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            epoch, step = self.state.epoch, self.state.step_in_epoch
            while not stop.is_set():
                if step >= len(self._epoch_plan(epoch)):
                    epoch, step = epoch + 1, 0
                batch = self._make_batch(epoch, step)
                batch["_epoch"] = np.int64(epoch)
                batch["_step"] = np.int64(step)
                step += 1
                q.put(batch)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                self.state.epoch = int(b.pop("_epoch"))
                self.state.step_in_epoch = int(b.pop("_step")) + 1
                yield b
        finally:
            stop.set()
            # drain so the producer can observe stop
            try:
                q.get_nowait()
            except queue.Empty:
                pass


def synthetic_lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic token stream for the LM training drivers (structured enough
    to have learnable statistics: Zipfian unigram + local repeats)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        rep = rng.random((batch, seq + 1)) < 0.3   # local bigram structure
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
