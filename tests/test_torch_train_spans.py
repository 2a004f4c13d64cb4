"""The trainer's spans: ``TrainEngine.fit`` records one trace on the
process's tracer (``obs.trace.default_tracer``) with ``trainer.prepare``
and one ``trainer.step`` a sampled step, each step split into five
phases (on the CPU every step is eager: tagged ``graphed`` False).
Tracing changes no bit of the trained params; the spans never enter a
torch profiler, and their wall stamps lie on its clock."""
import os
import statistics
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import params as P  # noqa: E402
from repro_torch.configs.costmodel import COSTMODEL_SMALL  # noqa: E402
from repro_torch.core import trainer as TR  # noqa: E402
from repro_torch.ir import dataset as DS  # noqa: E402
from repro_torch.obs import trace as OBS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEPS = 5
PHASES = ["trainer.batch", "trainer.copy_in", "trainer.forward",
          "trainer.backward", "trainer.optimizer"]


@pytest.fixture(scope="module", autouse=True)
def one_deterministic_thread():
    """One intra-op thread (the suite runs several pytest workers), and
    deterministic algorithms, so two runs can be held bit for bit."""
    n, det = torch.get_num_threads(), \
        torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(det)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return DS.build_dataset(120, mode="ops", max_seq=64, vocab_size=512,
                            seed=3)


def _fit(data, tracer=None):
    engine = TR.TrainEngine("conv1d", COSTMODEL_SMALL,
                            ("latency_us", "register_pressure"),
                            steps=STEPS, batch_size=16, device="cpu",
                            tracer=tracer)
    return engine.fit(data)


@pytest.fixture(scope="module")
def default_run(data):
    """A fit on the process's default tracer and its one new trace."""
    before = {r["trace"] for r in OBS.default_tracer().recorder.snapshot()}
    result = _fit(data)
    recs = [r for r in OBS.default_tracer().recorder.snapshot()
            if r["trace"] not in before]
    return result, recs


def _one_trace(recs):
    trees = OBS.assemble(recs)
    assert len(trees) == 1
    tree, = trees.values()
    assert tree.complete and tree.roots[0]["name"] == "trainer.fit"
    return tree


@pytest.mark.parametrize("sample_every, sampled", [
    (1, [1, 2, 3, 4, 5]), (2, [1, 3, 5]), (1 << 30, [1])])
def test_a_fit_records_its_steps_phases(sample_every, sampled, data,
                                        default_run):
    """The first step and those ``sample()`` hits each record one
    ``trainer.step``, tagged unprofiled, whose five phases parent onto
    it, beside ``trainer.fit``'s ``trainer.prepare``; the phases cover
    at least 90% of the median sampled step. Either way the params are
    those of the default run, bit for bit.

    The coverage is the median step's, not every step's: on the wall
    clock, the OS preempting the thread between two phases leaves a
    single step's phases short of it (beside 10 busy processes on 8
    cores, 16 of 900 steps read under 0.9, the lowest 0.53), while the
    median sampled step of 300 fits read at least 0.985."""
    tracer = OBS.Tracer(sample_every=sample_every, proc="trainer")
    result = _fit(data, tracer)
    recs = tracer.recorder.snapshot()
    tree = _one_trace(recs)
    root = tree.roots[0]
    assert [s["name"] for s in tree.children[root["span"]]] == \
        ["trainer.prepare"] + ["trainer.step"] * len(sampled)
    steps = [s for s in recs if s["name"] == "trainer.step"]
    assert [s["tags"] for s in steps] == \
        [{"step": n, "profiled": False, "graphed": False} for n in sampled]
    covered = []
    for s in steps:
        kids = tree.children[s["span"]]
        assert [k["name"] for k in kids] == PHASES
        covered.append(sum(k["dur_s"] for k in kids) / s["dur_s"])
    assert statistics.median(covered) >= 0.9, covered
    assert len(recs) == 2 + 6 * len(steps)
    for a, b in zip(P.tree_flatten(result.params),
                    P.tree_flatten(default_run[0].params)):
        assert torch.equal(a, b)


def test_the_default_tracer_samples_1_in_32(default_run):
    """A fit with no tracer records its trace on the process's tracer,
    whose later steps are sampled 1 in ``TRAIN_SAMPLE_EVERY``."""
    tracer = OBS.default_tracer()
    assert tracer.sample_every == OBS.TRAIN_SAMPLE_EVERY == 32
    steps = [s["tags"]["step"] for s in _one_trace(default_run[1]).spans
             if s["name"] == "trainer.step"]
    assert steps[0] == 1 and len(steps) <= 2


def test_a_profiled_fit_samples_every_step_and_adds_no_event(data):
    """While a torch profiler records, every step is sampled and tagged
    ``profiled``, and no span of the trainer appears among the
    profiler's events."""
    from torch.profiler import ProfilerActivity, profile
    tracer = OBS.Tracer(sample_every=1 << 30, proc="trainer")
    assert not OBS.profiling()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert OBS.profiling()
        _fit(data, tracer)
    assert not OBS.profiling()
    steps = [s["tags"] for s in tracer.recorder.snapshot()
             if s["name"] == "trainer.step"]
    assert steps == [{"step": n, "profiled": True, "graphed": False}
                     for n in range(1, STEPS + 1)]
    names = {e.name for e in prof.events()}
    assert any(n.startswith("aten::") for n in names)
    assert not any(n.startswith("trainer.") for n in names)


def test_a_span_lies_on_the_profilers_clock():
    """An op run inside a span lies within ``[t_wall, t_wall + dur_s]``
    on the profiler's timeline (``trace_start_ns`` plus the event's
    offset), within 1 ms."""
    from torch.profiler import ProfilerActivity, profile
    tracer = OBS.Tracer(sample_every=1)
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("probe", tracer.sample(force=True)):
            for _ in range(20):
                x = torch.mm(x, x).tanh()
    span, = tracer.recorder.snapshot()
    base_ns = prof.profiler.kineto_results.trace_start_ns()
    mms = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mms) == 20
    lo_ns, hi_ns = span["t_wall"] * 1e9, \
        (span["t_wall"] + span["dur_s"]) * 1e9
    for e in (mms[0], mms[-1]):
        assert base_ns + e.time_range.start * 1e3 >= lo_ns - 1e6
        assert base_ns + e.time_range.end * 1e3 <= hi_ns + 1e6


def test_obs_trace_imports_only_the_standard_library():
    code = ("import sys, repro_torch.obs.trace as T; "
            "assert not T.profiling(); "
            "assert T.default_tracer() is T.default_tracer(); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.stdout.strip() == "[]"
