"""Accuracy sentinel: online drift monitoring against the oracle.

A deployed cost model is only trustworthy while its *ranking* of
programs still tracks the ground truth — train-time eval says nothing
about the traffic it actually serves six hours in. The
:class:`DriftMonitor` closes that gap on the production side:

* ``observe_batch`` samples served ``(graph, prediction)`` pairs off
  the hot path (counter-based, default 1 in ``sample_every``). The
  sampling counter is deliberately *racy* — under concurrent callers
  it may pick slightly more or fewer items, which is fine for a
  sampler — so the common unsampled call costs one modulo and zero
  lock acquisitions; only an actual pick takes the queue lock;
* a background thread scores each sampled graph with the analyzer
  oracle (:func:`repro_torch.ir.analyzers.analyze` by default — the same
  ground truth the opt benches judge against) and feeds rolling
  per-target windows. Scoring is pure Python, so the thread paces
  itself (``score_interval_s`` between oracle calls) to keep the GIL
  available to the serving threads it shares the process with;
  ``flush()`` / ``stop(drain=True)`` drain the queue unpaced;
* ``gauges()`` exposes per-target Spearman + MAE over the window, the
  sample/score/drop counters, and the front door's ``oov_rate`` /
  ``unk_fraction`` EWMAs with **hysteresis alarms** (an alarm arms
  above ``hi`` and only disarms below ``lo``, so a rate oscillating
  around one threshold cannot flap the flywheel's drift gate).

Every gauge key is always present — a registry snapshot taken before
any traffic still carries ``spearman.<target>`` (0.0) and ``oov_rate``
— so downstream consumers (the hot-swap gate, dashboards) never need
existence checks.

The monitor attaches to a service as ``svc.drift``; the serving tiers
call the hooks through ``getattr``, so :mod:`repro_torch.core` keeps zero
import-time dependency on this package.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence


class Alarm:
    """Two-threshold hysteresis: arms at ``>= hi``, disarms at
    ``<= lo`` — never flaps in the band between them."""

    __slots__ = ("hi", "lo", "armed")

    def __init__(self, hi: float, lo: float):
        if lo > hi:
            raise ValueError(f"alarm lo={lo} must be <= hi={hi}")
        self.hi = float(hi)
        self.lo = float(lo)
        self.armed = False

    def update(self, value: float) -> bool:
        if self.armed:
            if value <= self.lo:
                self.armed = False
        elif value >= self.hi:
            self.armed = True
        return self.armed


class DriftMonitor:
    """Samples served predictions, scores them against the oracle in
    the background, and serves rolling accuracy gauges."""

    def __init__(self, oracle: Optional[Callable[[Any], Dict[str, float]]]
                 = None, *, targets: Sequence[str] = (),
                 sample_every: int = 16, window: int = 256,
                 max_queue: int = 128, score_interval_s: float = 0.05,
                 oov_alarm: tuple = (0.25, 0.10),
                 unk_alarm: tuple = (0.25, 0.10),
                 ewma_alpha: float = 0.2):
        if oracle is None:
            from repro_torch.ir.analyzers import analyze as oracle
        self.oracle = oracle
        self.targets = tuple(targets)
        self.sample_every = max(1, int(sample_every))
        self.window = int(window)
        self.max_queue = int(max_queue)
        self.score_interval_s = float(score_interval_s)
        self._n = 0
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._windows: Dict[str, deque] = {
            t: deque(maxlen=self.window) for t in self.targets}
        self.observed = 0
        self.scored = 0
        self.oracle_errors = 0
        self.queue_drops = 0
        self._oov_ewma: Optional[float] = None
        self._unk_ewma: Optional[float] = None
        self._alpha = float(ewma_alpha)
        self.oov_alarm = Alarm(*oov_alarm)
        self.unk_alarm = Alarm(*unk_alarm)
        self._stop = threading.Event()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "DriftMonitor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-drift-monitor", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the scorer; by default score whatever is still queued
        first, so short runs (benches, tests) keep their samples."""
        if drain:
            self.flush()
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "DriftMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------- hot path
    def observe_batch(self, graphs: Sequence[Any],
                      preds: Dict[str, Any]) -> None:
        """Hook for ``predict_all``-shaped results: ``preds`` maps
        target -> (N,) denormalized array aligned with ``graphs``.

        Lock-free until a pick: the counter update is racy on purpose
        (concurrent callers may shift which requests get sampled — a
        sampler tolerates that), so the 1-in-``sample_every`` common
        case never contends with other serving threads."""
        n = len(graphs)
        if n == 0:
            return
        k = self.sample_every
        base = self._n
        self._n = base + n
        picks: List[int] = [i for i in range(n)
                            if (base + i + 1) % k == 0]
        if not picks:
            return
        items = [(graphs[i], {t: float(preds[t][i]) for t in preds})
                 for i in picks]
        with self._lock:
            for item in items:
                if len(self._queue) >= self.max_queue:
                    self._queue.popleft()
                    self.queue_drops += 1
                self._queue.append(item)
                self.observed += 1
            self._wake.notify()

    def observe(self, graph: Any, preds: Dict[str, float]) -> None:
        self.observe_batch([graph],
                           {t: [v] for t, v in preds.items()})

    def note_text(self, oov_rate: float, unk_rate: float) -> None:
        """Front-door ingest hook: per-text OOV/unk rates feed the
        EWMAs the hysteresis alarms watch."""
        with self._lock:
            a = self._alpha
            self._oov_ewma = float(oov_rate) if self._oov_ewma is None \
                else (1 - a) * self._oov_ewma + a * float(oov_rate)
            self._unk_ewma = float(unk_rate) if self._unk_ewma is None \
                else (1 - a) * self._unk_ewma + a * float(unk_rate)
            self.oov_alarm.update(self._oov_ewma)
            self.unk_alarm.update(self._unk_ewma)

    # ------------------------------------------------------- background
    def _score_one(self, graph, preds: Dict[str, float]) -> None:
        try:
            truth = self.oracle(graph)
        except Exception:
            with self._lock:
                self.oracle_errors += 1
            return
        with self._lock:
            for t, p in preds.items():
                if t not in truth:
                    continue
                self._windows.setdefault(
                    t, deque(maxlen=self.window)).append(
                    (p, float(truth[t])))
            self.scored += 1

    def _run(self) -> None:
        while True:
            with self._wake:
                while not self._queue and not self._stop.is_set():
                    self._wake.wait(timeout=0.5)
                if self._stop.is_set() and not self._queue:
                    return
                item = self._queue.popleft() if self._queue else None
            if item is not None:
                self._score_one(*item)
                if self.score_interval_s > 0.0:
                    # pace the pure-Python oracle so the sentinel never
                    # monopolizes the GIL against the serving threads
                    self._stop.wait(self.score_interval_s)

    def flush(self, timeout_s: float = 10.0) -> None:
        """Synchronously score everything queued (bench/test barrier)."""
        import time as _time
        deadline = _time.monotonic() + timeout_s
        while _time.monotonic() < deadline:
            with self._lock:
                item = self._queue.popleft() if self._queue else None
            if item is None:
                return
            self._score_one(*item)

    # ------------------------------------------------------------ gauges
    def gauges(self) -> Dict[str, Any]:
        from repro_torch.opt.evaluate import spearman
        with self._lock:
            windows = {t: list(w) for t, w in self._windows.items()}
            out: Dict[str, Any] = {
                "observed": self.observed,
                "scored": self.scored,
                "oracle_errors": self.oracle_errors,
                "queue_drops": self.queue_drops,
                "queued": len(self._queue),
                "oov_rate": self._oov_ewma or 0.0,
                "unk_fraction": self._unk_ewma or 0.0,
                "oov_alarm": int(self.oov_alarm.armed),
                "unk_alarm": int(self.unk_alarm.armed),
            }
        for t in set(self.targets) | set(windows):
            pairs = windows.get(t, [])
            if len(pairs) >= 2:
                p = [a for a, _ in pairs]
                o = [b for _, b in pairs]
                rho = spearman(p, o)
                mae = sum(abs(a - b) for a, b in pairs) / len(pairs)
            else:
                rho, mae = 0.0, 0.0
            out[f"spearman.{t}"] = rho
            out[f"mae.{t}"] = mae
            out[f"window_n.{t}"] = len(pairs)
        return out


def attach(svc, monitor: DriftMonitor) -> DriftMonitor:
    """Bind a monitor to a service (or a router's featurizer): the
    serving tiers look for ``svc.drift`` via ``getattr``, so this is
    the only coupling point. Fills the monitor's target set from the
    service's heads when unset, and starts the scorer."""
    if not monitor.targets:
        monitor.targets = tuple(svc.heads)
        for t in monitor.targets:
            monitor._windows.setdefault(
                t, deque(maxlen=monitor.window))
    svc.drift = monitor
    return monitor.start()
