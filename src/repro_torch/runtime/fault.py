"""Fault-tolerant training runtime: checkpoint/restart loop, preemption
handling, heartbeat-based straggler detection.

Host-side pieces a long training job needs (only the *failures* are
injected in tests):

* TrainSupervisor — owns the step loop; periodic + on-signal checkpointing,
  automatic resume from the last committed step (with the data-pipeline
  cursor), bounded retry on transient step failures.
* HeartbeatMonitor — per-worker heartbeats; workers falling behind the
  p50 step time by `straggler_factor` are flagged; the supervisor's policy
  hook can rebalance data shards or evict.

``elastic_reshard`` re-places a state on a new mesh.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import ckpt
from repro_torch.runtime import sharding as SH


@dataclass
class HeartbeatMonitor:
    """Tracks per-worker heartbeat timestamps and step durations."""
    n_workers: int
    straggler_factor: float = 2.0
    timeout_s: float = 60.0
    last_beat: Dict[int, float] = field(default_factory=dict)
    durations: Dict[int, List[float]] = field(default_factory=dict)

    def beat(self, worker: int, step_duration: Optional[float] = None,
             now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self.last_beat[worker] = now
        if step_duration is not None:
            self.durations.setdefault(worker, []).append(step_duration)
            self.durations[worker] = self.durations[worker][-32:]

    def _median_duration(self) -> Optional[float]:
        all_d = sorted(d for ds in self.durations.values() for d in ds)
        return all_d[len(all_d) // 2] if all_d else None

    def stragglers(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        med = self._median_duration()
        out = []
        for w in range(self.n_workers):
            if now - self.last_beat.get(w, now) > self.timeout_s:
                out.append(w)
                continue
            ds = self.durations.get(w)
            if med and ds and ds[-1] > self.straggler_factor * med:
                out.append(w)
        return out

    def rebalance_shards(self, shards: Dict[int, int],
                         now: Optional[float] = None) -> Dict[int, int]:
        """Move one unit of data-shard weight away from each straggler."""
        slow = set(self.stragglers(now=now))
        fast = [w for w in shards if w not in slow]
        if not fast:
            return shards
        new = dict(shards)
        for w in slow:
            if new.get(w, 0) > 0:
                new[w] -= 1
                new[min(fast, key=lambda f: new.get(f, 0))] += 1
        return new


@dataclass
class TrainSupervisor:
    """Checkpoint/restart step-loop wrapper.

    ``ckpt_dir=None`` disables persistence: the loop (and its retry
    policy) still runs, saves become no-ops and restore finds nothing —
    this is how the TrainEngine serves throwaway in-memory training and
    production resumable training through ONE step loop."""
    ckpt_dir: Optional[str]
    save_every: int = 100
    keep: int = 3
    max_step_retries: int = 2
    preempted: bool = field(default=False, init=False)

    def install_signal_handler(self):
        def _handler(signum, frame):
            self.preempted = True
        signal.signal(signal.SIGTERM, _handler)

    def _save(self, step, state, extra_fn: Optional[Callable]):
        if self.ckpt_dir is None:
            return
        ckpt.save(self.ckpt_dir, step, state,
                  extra=(extra_fn() if extra_fn else {}), keep=self.keep)

    def try_restore(self, state, shardings=None, check_treedef: bool = True):
        """Returns (state, start_step, extra) — or the inputs if no ckpt.
        Restored tensors land on the devices of ``state``'s leaves, or
        as DTensors placed by ``shardings`` (see ``ckpt.restore``).

        check_treedef is forwarded to ckpt.restore; pass False to resume
        across benign drift in the recorded key paths."""
        if self.ckpt_dir is None:
            return state, 0, {}
        try:
            state, step, extra = ckpt.restore(self.ckpt_dir, state,
                                              shardings=shardings,
                                              check_treedef=check_treedef)
            return state, step, extra
        except FileNotFoundError:
            return state, 0, {}

    def run(self, state, step_fn: Callable, n_steps: int, *,
            start_step: int = 0, extra_fn: Callable = None,
            on_step: Callable = None) -> Any:
        """step_fn(state, step) -> state. Checkpoints every save_every and on
        preemption; retries a failing step up to max_step_retries."""
        step = start_step
        while step < n_steps:
            t0 = time.monotonic()
            attempt = 0
            while True:
                try:
                    state = step_fn(state, step)
                    break
                except Exception:
                    attempt += 1
                    if attempt > self.max_step_retries:
                        self._save(step, state, extra_fn)
                        raise
            step += 1
            if on_step:
                on_step(step, time.monotonic() - t0)
            if step % self.save_every == 0 or self.preempted:
                self._save(step, state, extra_fn)
                if self.preempted:
                    return state
        self._save(n_steps, state, extra_fn)
        return state


def elastic_reshard(state, old_mesh_shape, new_rules, abstract_state_axes):
    """Recompute shardings for a new mesh and re-place the state: each
    leaf (a DTensor on the old mesh, gathered first, or a tensor every
    rank holds in full) becomes a DTensor placed by ``new_rules`` for its
    logical axes. ``old_mesh_shape`` is accepted as the reference's is
    and not needed: a DTensor carries its own mesh."""
    def one(axes, leaf):
        full = leaf.full_tensor() if isinstance(leaf, SH.DTensor) else leaf
        return SH.place(full, new_rules.sharding(axes, full.shape))
    return SH.map_axes(one, abstract_state_axes, state)
