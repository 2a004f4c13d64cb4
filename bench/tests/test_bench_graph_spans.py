"""The readers of the trainer's CUDA graph spans, on a synthetic trace in
the process's default tracer: ``trainer.graphed_pct.train``, the share
of the newest fit's unprofiled steps after its first tagged
``graphed``, and ``trainer.replay_ms.train``, the mean
``trainer.replay`` span over them; each None for another kind of cell,
for no ``trainer.fit`` trace, for a program without the tracer, and for
one whose steps carry no ``graphed`` tag and no replay span."""
import pytest

import benchtest_util  # noqa: F401  (import paths)

from bench.harness import spec as SP  # noqa: E402
from repro_torch.obs import trace as OBS  # noqa: E402

GRAPHED, REPLAY = "trainer.graphed_pct.train", "trainer.replay_ms.train"
TRAIN = {"kind": "train"}


def _fit_trace(tracer, steps, tagged=True):
    """A ``trainer.fit`` trace: a prepare span and a step a
    ``(graphed, profiled, replay_ms)`` triple, a replayed step's children
    ``trainer.copy_in`` and ``trainer.replay``, an eager one's the copy
    and the three phases. ``tagged=False`` leaves out the ``graphed``
    tag (and so every replay), as a program without graphs records."""
    fit = tracer.start("trainer.fit", tracer.sample(force=True))
    tracer.emit("trainer.prepare", fit.ctx, 2.0)
    for n, (graphed, profiled, replay_ms) in enumerate(steps, start=1):
        tags = {"step": n, "profiled": profiled}
        if tagged:
            tags["graphed"] = graphed
        step = tracer.start("trainer.step", fit.ctx, tags)
        tracer.emit("trainer.copy_in", step.ctx, 1e-3)
        if graphed and tagged:
            tracer.emit("trainer.replay", step.ctx, replay_ms / 1e3)
        else:
            for name in ("forward", "backward", "optimizer"):
                tracer.emit(f"trainer.{name}", step.ctx, 4e-3)
        tracer.end(step)
    tracer.end(fit)


@pytest.fixture
def tracer(monkeypatch):
    t = OBS.Tracer(sample_every=1 << 30, proc="trainer")
    monkeypatch.setattr(OBS, "_DEFAULT", t)
    return t


def test_the_readers_read_the_newest_fit_with_graphed_steps(tracer):
    """Of the newest fit's steps after its first, the unprofiled ones:
    three replayed (0.02, 0.04 and 0.09 ms) and one eager, so 75% and
    0.05 ms; the first step, a profiled replay and an older fit are not
    read."""
    _fit_trace(tracer, [(False, False, 0)] + [(True, False, 9.0)] * 4)
    _fit_trace(tracer, [(False, False, 0), (True, False, 0.02),
                        (False, False, 0), (True, True, 7.0),
                        (True, False, 0.04), (True, False, 0.09)])
    assert SP.reader(GRAPHED)(TRAIN) == pytest.approx(75.0)
    assert SP.reader(REPLAY)(TRAIN) == pytest.approx(0.05)


def test_a_fit_of_eager_steps_reads_zero_and_no_replay(tracer):
    """Steps tagged ``graphed`` False (the CPU, a mesh, or a shape still
    warming up): 0%, and no replay to time."""
    _fit_trace(tracer, [(False, False, 0)] * 4)
    assert SP.reader(GRAPHED)(TRAIN) == 0.0
    assert SP.reader(REPLAY)(TRAIN) is None


@pytest.mark.parametrize("metric", [GRAPHED, REPLAY])
def test_the_readers_find_nothing_to_read(tracer, metric, monkeypatch):
    read = SP.reader(metric)
    assert read(TRAIN) is None                      # no trace yet
    _fit_trace(tracer, [(False, False, 0)] + [(True, False, 0.03)] * 2,
               tagged=False)                        # a program before graphs
    assert read(TRAIN) is None
    _fit_trace(tracer, [(False, False, 0)] + [(True, False, 0.03)] * 2)
    assert read(TRAIN) is not None
    assert read({"kind": "serve"}) is None
    assert read({"kind": "search"}) is None
    _fit_trace(tracer, [(False, False, 0), (True, True, 0.03)])
    assert read(TRAIN) is None                      # only a profiled step
    monkeypatch.delattr(OBS, "default_tracer")        # a program without it
    assert read(TRAIN) is None
