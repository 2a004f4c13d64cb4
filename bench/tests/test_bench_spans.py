"""The readers of the trainer's spans, on a synthetic trace in the
process's default tracer: the five phases' means over the steps after
the first, the set-up's seconds, and None for another kind of cell, for
no ``trainer.fit`` trace, or for a program without the tracer."""
import pytest

import benchtest_util  # noqa: F401  (import paths)

from bench.harness import spec as SP  # noqa: E402
from repro_torch.obs import trace as OBS  # noqa: E402

PHASES = {"loader.wait_ms.train": "trainer.batch",
          "trainer.copy_in_ms.train": "trainer.copy_in",
          "trainer.forward_ms.train": "trainer.forward",
          "trainer.backward_ms.train": "trainer.backward",
          "trainer.optimizer_ms.train": "trainer.optimizer"}
TRAIN = {"kind": "train"}


def _fit_trace(tracer, step_ms, prepare_s=2.5, first_s=0.75,
               profiled=()):
    """A ``trainer.fit`` trace: the prepare span, a first step of
    ``first_s`` and one step a list of ``step_ms`` (each phase's ms),
    those at the indices ``profiled`` tagged as recorded by a
    profiler."""
    fit = tracer.start("trainer.fit", tracer.sample(force=True))
    tracer.emit("trainer.prepare", fit.ctx, prepare_s)
    for n, phases in enumerate([None] + step_ms, start=1):
        step = tracer.start("trainer.step", fit.ctx,
                            {"step": n, "profiled": n - 2 in profiled})
        for name in PHASES.values():
            tracer.emit(name, step.ctx,
                        1.0 if phases is None else phases[name] / 1e3)
        step.close()
        step.dur_s = first_s if phases is None else \
            sum(phases.values()) / 1e3
        tracer.recorder.record(step)
    tracer.end(fit)


@pytest.fixture
def tracer(monkeypatch):
    t = OBS.Tracer(sample_every=1 << 30, proc="trainer")
    monkeypatch.setattr(OBS, "_DEFAULT", t)
    return t


def _step(i):
    return {name: (k + 1) * (i + 1) for k, name in enumerate(PHASES.values())}


def test_the_readers_read_the_newest_fit(tracer):
    """The phases average the newest fit's unprofiled steps after its
    first (here the second and fourth of five later steps are
    profiled)."""
    _fit_trace(tracer, [_step(9)] * 4, prepare_s=100.0)      # an older fit
    _fit_trace(tracer, [_step(i) for i in range(5)], profiled=(1, 3))
    for metric in PHASES:
        want = sum(_step(i)[PHASES[metric]] for i in (0, 2, 4)) / 3
        assert SP.reader(metric)(TRAIN) == pytest.approx(want)
    assert SP.reader("trainer.prepare_s.train")(TRAIN) == \
        pytest.approx(2.5 + 0.75)


@pytest.mark.parametrize("metric", [*PHASES, "trainer.prepare_s.train"])
def test_the_readers_find_nothing_to_read(tracer, metric, monkeypatch):
    read = SP.reader(metric)
    assert read(TRAIN) is None                      # no trace yet
    _fit_trace(tracer, [_step(0)])
    assert read({"kind": "serve"}) is None
    assert read({"kind": "search"}) is None
    assert read(TRAIN) is not None
    monkeypatch.delattr(OBS, "default_tracer")        # the parent program
    assert read(TRAIN) is None


@pytest.mark.parametrize("metric", list(PHASES))
def test_a_fit_with_no_unprofiled_later_step_has_no_phase(tracer, metric):
    """Neither the first step nor a profiled one is read."""
    _fit_trace(tracer, [])
    assert SP.reader(metric)(TRAIN) is None
    _fit_trace(tracer, [_step(0), _step(1)], profiled=(0, 1))
    assert SP.reader(metric)(TRAIN) is None
    assert SP.reader("trainer.prepare_s.train")(TRAIN) == \
        pytest.approx(3.25)
