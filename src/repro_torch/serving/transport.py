"""Wire format + picklable service recipe for the replicated tier.

Replicas are separate OS processes (spawned — CUDA cannot be forked
once a process has initialised it), so everything crossing the boundary
is defined here:

* :class:`ServiceSpec` — a picklable recipe that rebuilds an identical
  :class:`~repro_torch.core.service.CostModelService` in any process
  (params are carried as numpy; the rebuilt service moves them to its
  device itself). The router builds one too — as its *featurizer*
  (struct keys + token ids + the client-side LRU), on the CPU; it never
  runs a forward pass.
* request/response packing — requests ship ``(struct_key, token ids)``
  per entry: the router featurizes ONCE client-side, the replica's
  key-first cache probe and ids-first submit seam mean nothing is ever
  re-tokenized server-side. Batches pack all ids into one contiguous
  ``int32`` buffer (one allocation each way, cheap to pickle); response
  rows pack as one ``(n, n_heads) float32`` block.

Message tuples (first element is the type tag):

  ``(MSG_REQ, client_id, batch_id, keys, lens_b, ids_b[, trace])``
  router->replica; ``(MSG_RES, batch_id, rids, rows_b, n_heads[, spans])``
  replica->router; ``(MSG_OVERLOAD, batch_id, rids, retry_after_s)``
  replica->router; ``(MSG_ERR, batch_id, rids, repr)``    replica->router
  ``(MSG_STATS, client_id, rid)`` / ``(MSG_STATS_RES, rid, payload)``
  ``(MSG_CLEAR, client_id, rid)`` — drop replica caches (bench cold runs)
  ``(MSG_STOP,)``

Tracing rides the wire as *optional trailing elements* — requests the
client head-sampled append a 7th element ``trace = (trace_id,
parent_span_id)`` to MSG_REQ, and the replica ships that trace's span
records back as a 6th MSG_RES element. Untraced traffic keeps the
original tuple arity, so both sides unpack length-tolerantly
(:func:`req_trace` / :func:`res_spans`) and old-shaped messages remain
valid forever.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import params as P

MSG_REQ = "req"
MSG_RES = "res"
MSG_OVERLOAD = "overload"
MSG_ERR = "err"
MSG_STATS = "stats"
MSG_STATS_RES = "stats_res"
MSG_CLEAR = "clear"
MSG_STOP = "stop"


def req_trace(msg) -> Optional[Tuple[str, str]]:
    """Optional trace context on a MSG_REQ tuple (None when untraced)."""
    return msg[6] if len(msg) > 6 else None


def res_spans(msg) -> Optional[list]:
    """Optional span records riding a MSG_RES tuple."""
    return msg[5] if len(msg) > 5 else None


@dataclass
class ServiceSpec:
    """Everything needed to rebuild one CostModelService, picklable.

    ``params`` is a numpy tree (converted via :meth:`from_service`);
    the rebuilt service moves it to its device exactly like a
    directly-constructed one. ``device`` is carried like every other
    field, so a spec taken from a card service rebuilds on the card
    (``None`` means ``"cuda"``, as in the service)."""

    kind: str
    cfg: Any
    params: Any
    vocab: Any
    norm_stats: Dict[str, Any]
    mode: str = "ops"
    max_seq: int = 256
    max_batch: int = 256
    cache_size: int = 4096
    dtype: str = "f32"
    fast_encode: bool = True
    use_kernel: bool = False
    buckets: Optional[Tuple[int, ...]] = None
    batch_ladder: Optional[Tuple[int, ...]] = None
    # OOV vocab mode, mirrored explicitly on the wire: the pickled
    # Vocab carries these fields itself on current builds, but the
    # spec is the authoritative copy — build() re-applies them, so a
    # legacy-pickled vocab (plain id dict) still comes up in the mode
    # the router featurizes with. Router and replica MUST agree here:
    # the shard/byte id resolution happens client-side in encode().
    n_unk_buckets: int = 0
    byte_fallback: bool = False
    device: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_service(cls, svc) -> "ServiceSpec":
        """Capture a live service's configuration (params -> numpy)."""
        return cls(kind=svc.kind, cfg=svc.cfg,
                   params=P.to_numpy(svc.params),
                   vocab=svc.vocab, norm_stats=svc.norm_stats,
                   mode=svc.mode, max_seq=svc.max_seq,
                   max_batch=svc.max_batch, cache_size=svc.cache_size,
                   dtype=svc.dtype, fast_encode=svc.fast_encode,
                   use_kernel=svc.use_kernel,
                   buckets=tuple(svc.buckets),
                   batch_ladder=tuple(svc.batch_ladder),
                   n_unk_buckets=getattr(svc.vocab, "n_unk_buckets", 0),
                   byte_fallback=getattr(svc.vocab, "byte_fallback",
                                         False),
                   device=svc.device)

    def build(self, **overrides):
        """Instantiate the CostModelService in THIS process (``device=``
        among ``overrides`` builds it elsewhere, as the router's
        featurizer does)."""
        from repro_torch.core.service import CostModelService
        from repro_torch.core.tokenizer import Vocab
        vocab = self.vocab
        if (self.n_unk_buckets or self.byte_fallback) and \
                isinstance(vocab, Vocab) and (
                getattr(vocab, "n_unk_buckets", 0) != self.n_unk_buckets
                or getattr(vocab, "byte_fallback", False)
                != self.byte_fallback):
            vocab = Vocab(vocab.token_to_id,
                          n_unk_buckets=self.n_unk_buckets,
                          byte_fallback=self.byte_fallback)
        kw = dict(mode=self.mode, max_seq=self.max_seq,
                  max_batch=self.max_batch, cache_size=self.cache_size,
                  dtype=self.dtype, fast_encode=self.fast_encode,
                  use_kernel=self.use_kernel, buckets=self.buckets,
                  batch_ladder=self.batch_ladder, device=self.device,
                  **self.extra)
        kw.update(overrides)
        return CostModelService(self.kind, self.cfg, self.params,
                                vocab, self.norm_stats, **kw)


# ------------------------------------------------------------ entry packing
def pack_entries(entries: Sequence[Tuple[str, np.ndarray]]
                 ) -> Tuple[List[str], bytes, bytes]:
    """(key, ids) batch -> (keys, packed lengths, packed ids).

    Entries may span buckets (different ids lengths); ids concatenate
    into one int32 buffer with an explicit length table so unpacking is
    two ``np.frombuffer`` views + slicing, no per-entry pickling."""
    keys = [k for k, _ in entries]
    lens = np.asarray([len(ids) for _, ids in entries], np.int32)
    if entries:
        ids_b = np.concatenate(
            [np.asarray(ids, np.int32) for _, ids in entries]).tobytes()
    else:
        ids_b = b""
    return keys, lens.tobytes(), ids_b


def unpack_entries(keys: Sequence[str], lens_b: bytes, ids_b: bytes
                   ) -> List[Tuple[str, np.ndarray]]:
    lens = np.frombuffer(lens_b, np.int32)
    flat = np.frombuffer(ids_b, np.int32)
    out: List[Tuple[str, np.ndarray]] = []
    pos = 0
    for k, n in zip(keys, lens):
        out.append((k, flat[pos:pos + n]))
        pos += int(n)
    return out


def pack_rows(rows: Sequence[np.ndarray]) -> Tuple[bytes, int]:
    """Normalized (n_heads,) rows -> one f32 block + the head count."""
    block = np.stack([np.asarray(r, np.float32) for r in rows])
    return block.tobytes(), int(block.shape[1])


def unpack_rows(rows_b: bytes, n_heads: int) -> np.ndarray:
    return np.frombuffer(rows_b, np.float32).reshape(-1, n_heads)
