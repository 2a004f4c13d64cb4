"""Shared cross-replica prediction cache (lock-guarded shared memory).

Struct-key routing keeps each replica's *own* LRU hot, but a key's first
query still misses everywhere — and after a reroute (replica death,
overload cooldown) the fallback replica starts cold for that key's
neighborhood. This tier is the fleet's second-chance cache: a fixed-slot
open-addressed hash table in a ``multiprocessing`` shared byte array,
consulted by every replica on local-LRU miss and published to after
every computed batch. Writes are tiny (one 20-byte digest + the
``n_heads`` float32 row), so a single cross-process mutex is plenty at
cost-model scale.

Slot layout (fixed ``n_heads``):

  [1B valid][20B sha1 digest][n_heads * 4B f32 row][4B crc32]

The trailing crc32 covers digest + row and is what makes the table safe
against a *holder dying mid-write*: a replica SIGKILLed halfway through
a slot update leaves either ``valid == 0`` (write-in-progress marker) or
a payload whose checksum no longer matches — both read as a miss, never
as a wrong row. The same property catches deliberate corruption from
the fault harness (:mod:`repro_torch.serving.faults`).

Because a dead holder also leaves the cross-process mutex acquired
forever, every operation takes the lock with a *bounded*
``acquire(timeout=lock_timeout_s)`` and degrades to a cache miss (or a
skipped publish) on timeout instead of wedging the whole fleet;
``lock_timeouts`` counts those per process. The supervisor calls
:meth:`recover` after killing a replica to force-release an orphaned
lock.

Collisions overwrite (cache semantics); two *different* keys sharing a
full 160-bit digest is out of scope. The table is picklable into
spawned children (the shared block and lock travel through
``multiprocessing``'s inheritance machinery), so one instance built by
the parent serves every replica and client process.
"""
from __future__ import annotations

import hashlib
import multiprocessing as mp
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIGEST = 20                     # sha1
_CRC = 4                         # trailing crc32 (little-endian u32)


def _digest(key: str) -> bytes:
    """20-byte digest of a struct key. Graph.struct_key is already a
    sha1 hexdigest, so the common case is a cheap unhex."""
    if len(key) == 2 * _DIGEST:
        try:
            return bytes.fromhex(key)
        except ValueError:
            pass
    return hashlib.sha1(key.encode()).digest()


def _crc32(payload: np.ndarray) -> np.ndarray:
    """crc32 of a uint8 payload as a 4-byte little-endian array."""
    c = zlib.crc32(payload.tobytes()) & 0xFFFFFFFF
    return np.frombuffer(c.to_bytes(_CRC, "little"), np.uint8)


class SharedRowCache:
    """Fixed-capacity shared-memory map: struct key -> (n_heads,) f32."""

    PROBES = 8

    def __init__(self, n_heads: int, n_slots: int = 16384,
                 ctx: Optional[mp.context.BaseContext] = None,
                 lock_timeout_s: float = 1.0):
        ctx = ctx or mp.get_context("spawn")
        self.n_heads = int(n_heads)
        self.n_slots = int(n_slots)
        self.row_bytes = 4 * self.n_heads
        self.slot_bytes = 1 + _DIGEST + self.row_bytes + _CRC
        self.lock_timeout_s = float(lock_timeout_s)
        self._buf = ctx.RawArray("B", self.n_slots * self.slot_bytes)
        self._lock = ctx.Lock()
        # per-process degradation counters (each process pickles its own
        # copy; replicas report theirs through the stats RPC)
        self.lock_timeouts = 0
        self.torn_drops = 0

    # NOTE: np.frombuffer views are rebuilt per call — the object must
    # stay picklable (views of shared ctypes are not).
    def _view(self) -> np.ndarray:
        return np.frombuffer(self._buf, np.uint8).reshape(
            self.n_slots, self.slot_bytes)

    def _slots_for(self, dig: bytes) -> List[int]:
        h = int.from_bytes(dig[:8], "little")
        return [(h + i) % self.n_slots for i in range(self.PROBES)]

    def _acquire(self) -> bool:
        """Bounded lock acquire; a timeout means a wedged/dead holder
        and the caller degrades (miss / skipped publish), never blocks
        the fleet."""
        if self._lock.acquire(timeout=self.lock_timeout_s):
            return True
        self.lock_timeouts += 1
        return False

    def _row_of(self, slot: np.ndarray) -> Optional[np.ndarray]:
        """Validated row copy, or None (torn/corrupt payload is dropped
        so later probes stop paying the crc check)."""
        payload = slot[1:1 + _DIGEST + self.row_bytes]
        if not np.array_equal(slot[1 + _DIGEST + self.row_bytes:],
                              _crc32(payload)):
            slot[0] = 0
            self.torn_drops += 1
            return None
        return slot[1 + _DIGEST:1 + _DIGEST + self.row_bytes] \
            .copy().view(np.float32)

    def get(self, key: str) -> Optional[np.ndarray]:
        dig = np.frombuffer(_digest(key), np.uint8)
        if not self._acquire():
            return None
        try:
            view = self._view()
            for s in self._slots_for(dig.tobytes()):
                slot = view[s]
                if slot[0] and np.array_equal(slot[1:1 + _DIGEST], dig):
                    return self._row_of(slot)
        finally:
            self._lock.release()
        return None

    def get_many(self, keys: Sequence[str]
                 ) -> List[Optional[np.ndarray]]:
        digs = [np.frombuffer(_digest(k), np.uint8) for k in keys]
        out: List[Optional[np.ndarray]] = [None] * len(keys)
        if not self._acquire():
            return out
        try:
            view = self._view()
            for i, dig in enumerate(digs):
                for s in self._slots_for(dig.tobytes()):
                    slot = view[s]
                    if slot[0] and np.array_equal(
                            slot[1:1 + _DIGEST], dig):
                        out[i] = self._row_of(slot)
                        break
        finally:
            self._lock.release()
        return out

    def put(self, key: str, row: np.ndarray) -> None:
        self.put_many([(key, row)])

    def put_many(self, items: Sequence[Tuple[str, np.ndarray]]) -> None:
        packed = []
        for key, row in items:
            dig = _digest(key)
            row8 = np.ascontiguousarray(
                np.asarray(row, np.float32)).view(np.uint8)
            packed.append((dig, np.frombuffer(dig, np.uint8), row8))
        if not self._acquire():
            return                               # skipped publish
        try:
            view = self._view()
            for dig, dig8, row8 in packed:
                slots = self._slots_for(dig)
                target = None
                for s in slots:
                    slot = view[s]
                    if not slot[0]:          # first empty slot
                        if target is None:
                            target = s
                        continue
                    if np.array_equal(slot[1:1 + _DIGEST], dig8):
                        target = s           # refresh in place
                        break
                if target is None:           # probe window full: evict a
                    target = slots[dig[8] % self.PROBES]   # stable victim
                slot = view[target]
                # write-in-progress marker first: a writer dying inside
                # this block leaves valid=0, not a half-written "hit"
                slot[0] = 0
                slot[1:1 + _DIGEST] = dig8
                slot[1 + _DIGEST:1 + _DIGEST + self.row_bytes] = row8
                slot[1 + _DIGEST + self.row_bytes:] = _crc32(
                    slot[1:1 + _DIGEST + self.row_bytes])
                slot[0] = 1
        finally:
            self._lock.release()

    def fill(self) -> int:
        """Occupied slot count (diagnostics; takes the lock).
        Returns -1 when the lock holder is wedged."""
        if not self._acquire():
            return -1
        try:
            return int(self._view()[:, 0].sum())
        finally:
            self._lock.release()

    def clear(self) -> bool:
        """Invalidate every slot (bench cold-pass reset)."""
        if not self._acquire():
            return False
        try:
            self._view()[:, 0] = 0
            return True
        finally:
            self._lock.release()

    def recover(self, timeout_s: Optional[float] = None) -> bool:
        """Force-release a lock orphaned by a dead holder.

        Call *only* after the suspect process is confirmed dead (the
        supervisor does, post-SIGKILL). If the lock is free or a live
        holder releases it within ``timeout_s`` nothing is done; an
        acquire timeout then means no live holder exists and the
        semaphore is posted back. Returns True when a recovery
        happened."""
        t = self.lock_timeout_s if timeout_s is None else float(timeout_s)
        if self._lock.acquire(timeout=t):
            self._lock.release()
            return False
        try:
            self._lock.release()
        except ValueError:                       # raced: already free
            return False
        return True

    def stats(self) -> dict:
        """Per-process degradation counters + occupancy."""
        return {"lock_timeouts": self.lock_timeouts,
                "torn_drops": self.torn_drops,
                "fill": self.fill()}
