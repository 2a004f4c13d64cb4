"""The training step's CUDA graphs, as far as the CPU can hold them.

* On the CPU, ``TrainEngine.fit`` builds no graph, tags no step
  ``graphed``, and lands on the bits of a plain loop of
  ``make_sgd_step`` (threading the compression's error state by hand
  when it is on) over the loader's batches: params, both moments, the
  count and every step's loss.
* ``_StepGraphs``' bookkeeping, with ``torch.cuda``'s stream and graph
  calls replaced by stand-ins that record a capture and run it again at
  each replay: the first three steps of a batch shape run eagerly, the
  fourth captures and replays, later ones replay; shapes are keyed by
  the whole batch shape, so a short last batch has its own graph; the
  spans are the step's own phases (eager) or ``trainer.capture`` and
  ``trainer.replay``; a kernel's launch count stays one a step run;
  ``drop`` resets every graph.

The card's tests (``tests/test_torch_chip.py``) hold a replayed step to
an eager one bit for bit.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import params as P  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.costmodel import COSTMODEL_SMALL  # noqa: E402
from repro_torch.core import trainer as TR  # noqa: E402
from repro_torch.ir import dataset as DS  # noqa: E402
from repro_torch.kernels import _build as KB  # noqa: E402
from repro_torch.obs import trace as OBS  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402

HEADS = ("latency_us", "register_pressure")
STEPS = 6


@pytest.fixture(scope="module", autouse=True)
def one_deterministic_thread():
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


def eager_loop(engine, data, steps):
    """The engine's step written out: its init, its loader's batches,
    ``make_sgd_step`` (or, with compression, the same pieces with the
    error state threaded). Returns (params, opt state, error state,
    losses)."""
    e = engine.ecfg
    params = P.from_numpy(engine.init_fn(
        engine.cfg, heads=engine.heads,
        generator=torch.Generator().manual_seed(e.seed)), "cpu")
    y, _ = DS.stacked_normalized_targets(data.targets, engine.heads)
    opt_cfg = adamw.AdamWConfig(lr=e.lr, total_steps=e.steps,
                                warmup_steps=min(50, e.steps // 10),
                                weight_decay=e.weight_decay)
    state = adamw.init_state(params)
    err = compress.init_error_state(params) if e.compress_grads else None
    step = TR.make_sgd_step(engine.apply_fn, opt_cfg, heads=engine.heads)
    loss_fn = TR.make_loss_fn(engine.apply_fn, engine.heads)
    losses = []
    for _, b in zip(range(steps), engine.make_loader(data, y)):
        ids, yy = torch.from_numpy(b["ids"]), torch.from_numpy(b["y"])
        if err is None:
            params, state, loss = step(params, state, ids, yy)
        else:
            loss, grads = TR.value_and_grad(loss_fn, params, ids, yy)
            grads, err = compress.compress_grads(grads, err)
            with torch.no_grad():
                params, state, _ = adamw.apply_updates(params, grads,
                                                       state, opt_cfg)
        losses.append(float(loss))
    return params, state, err, losses


def _cfg(kind):
    """COSTMODEL_SMALL; the transformer's position table as long as the
    dataset's 64 tokens."""
    if kind == "xformer":
        return dataclasses.replace(COSTMODEL_SMALL, max_seq=64)
    return COSTMODEL_SMALL


@pytest.mark.parametrize("kind, compressed", [
    ("conv1d", False), ("conv1d", True), ("fc", False), ("lstm", False),
    ("xformer", False)])
def test_cpu_fit_is_the_eager_loop_bit_for_bit(kind, compressed, data,
                                               tmp_path, monkeypatch):
    """Params, moments, count, error state and losses of a CPU fit equal
    the plain loop's bits; no graph is built and no step is tagged
    ``graphed``."""
    def no_graphs(*a, **k):
        raise AssertionError("a CPU fit built step graphs")
    monkeypatch.setattr(TR, "_StepGraphs", no_graphs)
    tracer = OBS.Tracer(sample_every=1, proc="trainer")
    engine = TR.TrainEngine(kind, _cfg(kind), HEADS, steps=STEPS,
                            batch_size=16, device="cpu", log_every=1,
                            compress_grads=compressed,
                            ckpt_dir=str(tmp_path), tracer=tracer)
    got = engine.fit(data)
    params, state, err, losses = eager_loop(engine, data, STEPS)
    saved, step, _ = ckpt.restore(str(tmp_path), (params, state, err))
    assert step == STEPS
    assert [v for _, v in got.history] == losses
    for a, b in zip(P.tree_flatten((got.params, saved)),
                    P.tree_flatten((params, (params, state, err)))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tags = [s["tags"] for s in tracer.recorder.snapshot()
            if s["name"] == "trainer.step"]
    assert len(tags) == STEPS and not any(t["graphed"] for t in tags)


# ------------------------------------------- _StepGraphs with stand-ins
class FakeGraph:
    """A CUDA graph stand-in: the step run inside its capture is
    recorded (not run), and each replay runs it."""
    capturing = None

    def __init__(self):
        self.fn, self.replays, self.was_reset = None, 0, False

    def replay(self):
        self.replays += 1
        self.fn()

    def reset(self):
        self.was_reset = True


class FakeStream:
    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def fake_capture(graph, pool=None, stream=None):
    assert pool is not None and isinstance(stream, FakeStream)
    FakeGraph.capturing = graph
    try:
        yield
    finally:
        FakeGraph.capturing = None


@pytest.fixture
def fake_cuda(monkeypatch):
    graphs = []

    def new_graph():
        graphs.append(FakeGraph())
        return graphs[-1]
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    return graphs


def test_graphs_warm_up_capture_and_replay_by_whole_shape(fake_cuda):
    """A step with a state that counts its steps and sums the rows it
    saw, and one counted kernel launch: eager three times a shape, then
    captured once and replayed; (4, 8), (4, 16) and the short (3, 8)
    each get their own graph and buffers; the state ends where running
    every step eagerly ends, and the kernel's count is one a step, as a
    capture's count is taken back and each replay adds it."""
    total = torch.zeros((), dtype=torch.float64)
    count = torch.zeros((), dtype=torch.int64)
    loss = torch.zeros((), dtype=torch.float64)
    eager_calls = []

    def kernel():
        pass
    kernel.launches = 0

    def run_step(ids, y, ctx):
        def body():
            count.add_(1)
            total.add_(ids.double().sum() + y.double().sum())
            loss.copy_(total)
            return loss
        KB.count(kernel)            # the host counts the launch it makes
        if FakeGraph.capturing is not None:
            FakeGraph.capturing.fn = body
            return loss
        eager_calls.append(tuple(ids.shape))
        return body()

    tracer = OBS.Tracer(sample_every=1, proc="trainer")
    graphs = TR._StepGraphs(run_step, torch.device("cpu"), tracer)
    rng = np.random.default_rng(0)
    order = [(4, 8)] * 5 + [(4, 16), (3, 8)] * 4 + [(4, 8)]
    want_total, flags, kids = 0.0, [], []
    for shape in order:
        ids = torch.from_numpy(rng.integers(0, 9, shape).astype(np.int32))
        y = torch.from_numpy(rng.standard_normal(shape[0]).astype(
            np.float32))
        want_total += float(ids.sum()) + float(y.double().sum())
        step = tracer.start("trainer.step", tracer.sample(force=True))
        d_ids, d_y = graphs.inputs(ids, y)
        assert d_ids is graphs.shapes[shape].ids and torch.equal(d_ids, ids)
        out, replayed = graphs.step(d_ids, d_y, step.ctx)
        tracer.end(step)
        assert out is loss and float(loss) == pytest.approx(want_total)
        flags.append(replayed)
        kids.append([s["name"] for s in tracer.recorder.drain()
                     if s["parent"] == step.span_id])
    assert int(count) == len(order) == kernel.launches
    assert flags == [False] * 3 + [True] * 2 + [False, False] * 3 + \
        [True, True, True]
    assert eager_calls == [(4, 8)] * 3 + [(4, 16), (3, 8)] * 3
    assert kids[0] == []                            # phases: run_step's own
    assert kids[3] == ["trainer.capture", "trainer.replay"]
    assert kids[4] == kids[-1] == ["trainer.replay"]
    assert sorted(graphs.shapes) == [(3, 8), (4, 8), (4, 16)]
    assert [g.replays for g in fake_cuda] == [3, 1, 1]
    graphs.drop()
    assert all(g.was_reset for g in fake_cuda) and not graphs.shapes


def test_copy_into_groups_by_dtype_and_copies_every_pair(monkeypatch):
    """The graphed step's copy into its state: every pair copied exactly
    into the same tensors, one ``_foreach_copy_`` a dtype."""
    g = torch.Generator().manual_seed(0)
    src = [torch.randn(3, 4, generator=g), torch.tensor(7, dtype=torch.int32),
           torch.randn(5, generator=g), torch.randn((), generator=g)]
    dst = [torch.zeros_like(t) for t in src]
    ids = [id(t) for t in dst]
    calls = []
    real = torch._foreach_copy_

    def spy(ds, ss):
        calls.append([t.dtype for t in ds])
        return real(ds, ss)
    monkeypatch.setattr(torch, "_foreach_copy_", spy)
    TR._copy_into(dst, src)
    assert sorted(map(str, calls)) == sorted(map(str, [
        [torch.float32] * 3, [torch.int32]]))
    assert [id(t) for t in dst] == ids
    for d, s in zip(dst, src):
        assert d.dtype == s.dtype and torch.equal(d, s)
