"""The port's TrainEngine against the reference's, on the CPU.

JAX's random bits cannot be reproduced, so both engines start from the
reference's initial params (the port's carried across with
``params.from_numpy``, each engine's ``init_fn`` replaced) and read the
same Loader stream from identical copies of the dataset. Held against
each other: loss curves and final params for every family, single-
and multi-head, with and without int8 compression; and checkpoints
across the two packages in both directions, each resumed run landing on
the uninterrupted reference run.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import COSTMODEL_SMALL as R_SMALL
from repro.core import models as RM
from repro.core import trainer as RT
from repro.ir import dataset as R_DS
from repro.optim import adamw as R_ADAMW
from repro_torch import params as P
from repro_torch.configs.costmodel import COSTMODEL_SMALL as T_SMALL
from repro_torch.core import trainer as TT
from repro_torch.core.models import DEFAULT_HEADS
from repro_torch.ir import dataset as T_DS
from repro_torch.optim import adamw as T_ADAMW

# float32 on both sides through the same step; the two differ only in
# the order of their sums (oneDNN against XLA, each threaded). The first
# steps agree to rounding (measured <= 1.6e-7 relative). Later, a
# near-tie in the max-pool that one side's sums make exact and the
# other's do not routes a gradient to other positions; the rows and taps
# involved then take AdamW steps of their own, each at most about lr =
# 1e-3 (measured: losses within 2.5e-5 relative over 30-40 steps, one
# embedding row 4.0e-4 off and 0.2% of the params beyond 2e-5; int8
# compression, which takes the next code where a value lands near a
# rounding boundary: params within 1e-5).
EARLY_STEPS, EARLY_RTOL = 5, 1e-6
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-3
# A run that meets such a tie drifts after it whatever changes the order
# of its sums, the port's own thread count included (conv1d single-head,
# the port with 1 thread against 8: losses 2.4e-5, params 3.1e-3 apart).
# Past the limits above, the port must stay within SELF_FACTOR times its
# distance from itself with another thread count.
SELF_FACTOR = 3.0
DS_KW = dict(mode="ops", max_seq=96, vocab_size=512, augment_factor=2,
             seed=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    machine's cores, and torch's default of one thread a core in each
    oversubscribes them (these training runs took ~15x as long under
    six workers as alone); the shapes here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def splits():
    """The same train split from each package's dataset builder."""
    r_tr, _ = R_DS.build_dataset(300, **DS_KW).split(0.1)
    t_tr, _ = T_DS.build_dataset(300, **DS_KW).split(0.1)
    np.testing.assert_array_equal(r_tr.ids, t_tr.ids)
    return r_tr, t_tr


def configs(kind):
    """(reference, port) config: COSTMODEL_SMALL, with the transformer's
    position table as long as the dataset's 96 tokens."""
    if kind != "xformer":
        return R_SMALL, T_SMALL
    return (dataclasses.replace(R_SMALL, max_seq=DS_KW["max_seq"]),
            dataclasses.replace(T_SMALL, max_seq=DS_KW["max_seq"]))


def ref_init(kind, heads):
    init = RM.get_model(kind)[0]
    h = None if isinstance(heads, str) else tuple(heads)
    key = jax.random.PRNGKey(0)
    cfg = configs(kind)[0]
    return jax.tree.map(np.asarray, init(key, cfg, heads=h) if h
                        else init(key, cfg))


def ref_engine(kind, heads, p0, **kw):
    eng = RT.TrainEngine(kind, configs(kind)[0], heads, **kw)
    eng.init_fn = lambda key, cfg, heads=None: jax.tree.map(
        jax.numpy.asarray, p0)
    return eng


def port_engine(kind, heads, p0, **kw):
    eng = TT.TrainEngine(kind, configs(kind)[1], heads, device="cpu",
                         **kw)
    eng.init_fn = lambda cfg, heads=None, *, generator: P.from_numpy(
        p0, "cpu")
    return eng


def max_param_diff(ref, got) -> float:
    r = jax.tree.leaves(ref)
    g = P.tree_flatten(got)
    assert len(r) == len(g)
    assert all(tuple(a.shape) == tuple(b.shape) for a, b in zip(r, g))
    return max(float(np.abs(b.numpy() - np.asarray(a)).max())
               for a, b in zip(r, g))


def losses(result):
    return np.array([loss for _, loss in result.history])


def max_loss_rel(a, b) -> float:
    return float(np.max(np.abs(losses(a) - losses(b)) / losses(b)))


def port_self_distance(run):
    """``run()`` (a port run) again with another CPU thread count: the
    order of its sums changes, nothing else."""
    n = torch.get_num_threads()
    torch.set_num_threads(1 if n > 1 else 2)
    try:
        other = run()
    finally:
        torch.set_num_threads(n)
    return other


def assert_parity(ref, got, rerun):
    """``got`` (the port) within the limits of ``ref`` (the reference),
    or, past them, within SELF_FACTOR times the port's distance from
    ``rerun()``, itself with another thread count."""
    n = min(EARLY_STEPS, len(ref.history))
    np.testing.assert_allclose(losses(got)[:n], losses(ref)[:n],
                               rtol=EARLY_RTOL)
    loss_d, param_d = max_loss_rel(got, ref), max_param_diff(ref.params,
                                                             got.params)
    if loss_d <= LOSS_RTOL and param_d <= PARAM_ATOL:
        return
    other = port_self_distance(rerun)
    self_loss = max_loss_rel(got, other)
    self_param = max_param_diff(P.to_numpy(other.params), got.params)
    assert loss_d <= max(LOSS_RTOL, SELF_FACTOR * self_loss), \
        (loss_d, self_loss)
    assert param_d <= max(PARAM_ATOL, SELF_FACTOR * self_param), \
        (param_d, self_param)


CASES = [("conv1d", "latency_us", False),
         ("conv1d", DEFAULT_HEADS, False),
         ("lstm", "latency_us", False),
         ("lstm", DEFAULT_HEADS, False),
         ("conv1d", DEFAULT_HEADS, True),
         ("fc", "latency_us", False),
         ("fc", DEFAULT_HEADS, False),
         ("xformer", "latency_us", False),
         ("xformer", DEFAULT_HEADS, False)]


@pytest.mark.parametrize(
    "kind,heads,compress", CASES,
    ids=["conv1d-single", "conv1d-multi", "lstm-single", "lstm-multi",
         "conv1d-multi-compressed", "fc-single", "fc-multi",
         "xformer-single", "xformer-multi"])
def test_training_matches_reference(kind, heads, compress, splits):
    r_tr, t_tr = splits
    p0 = ref_init(kind, heads)
    kw = dict(steps=30, batch_size=32, seed=0, log_every=1,
              compress_grads=compress)
    ref = ref_engine(kind, heads, p0, **kw).fit(r_tr)

    def run():
        return port_engine(kind, heads, p0, **kw).fit(t_tr)
    got = run()
    assert [s for s, _ in got.history] == list(range(1, 31))
    assert_parity(ref, got, run)
    assert got.norm_stats == ref.norm_stats
    assert got.heads == ref.heads
    assert got.stats["steps"] == 30.0


class Kill(Exception):
    pass


def kill_at(step_no):
    def on_step(step, dt):
        if step == step_no:
            raise Kill()
    return on_step


CKPT_KW = dict(steps=40, batch_size=32, seed=3, save_every=20,
               log_every=1)


@pytest.fixture(scope="module")
def uninterrupted(splits):
    """The reference's 40-step multi-head conv1d run, never stopped."""
    p0 = ref_init("conv1d", DEFAULT_HEADS)
    return p0, ref_engine("conv1d", DEFAULT_HEADS, p0, **CKPT_KW).fit(
        splits[0])


def test_reference_checkpoint_resumes_in_port(splits, uninterrupted,
                                              tmp_path):
    """The reference trains 20 of 40 steps (killed at 21, after the
    step-20 checkpoint); the port resumes from it and finishes."""
    r_tr, t_tr = splits
    p0, full = uninterrupted
    d = str(tmp_path / "ck")
    with pytest.raises(Kill):
        ref_engine("conv1d", DEFAULT_HEADS, p0, ckpt_dir=d,
                   **CKPT_KW).fit(r_tr, on_step=kill_at(21))
    resumed = TT.TrainEngine("conv1d", T_SMALL, DEFAULT_HEADS,
                             device="cpu", ckpt_dir=d, **CKPT_KW).fit(t_tr)
    assert resumed.stats["steps"] == 20.0
    np.testing.assert_allclose(losses(resumed), losses(full)[20:],
                               rtol=LOSS_RTOL)
    assert max_param_diff(full.params, resumed.params) <= PARAM_ATOL


def test_port_checkpoint_resumes_in_reference(splits, uninterrupted,
                                              tmp_path):
    """The port trains 20 of 40 steps; the reference resumes from its
    checkpoint with ``check_treedef=True`` and finishes."""
    r_tr, t_tr = splits
    p0, full = uninterrupted
    d = str(tmp_path / "ck")
    with pytest.raises(Kill):
        port_engine("conv1d", DEFAULT_HEADS, p0, ckpt_dir=d,
                    **CKPT_KW).fit(t_tr, on_step=kill_at(21))
    resumed = RT.TrainEngine("conv1d", R_SMALL, DEFAULT_HEADS, ckpt_dir=d,
                             check_treedef=True, **CKPT_KW).fit(r_tr)
    assert resumed.stats["steps"] == 20.0
    assert resumed.norm_stats == full.norm_stats
    np.testing.assert_allclose(losses(resumed), losses(full)[20:],
                               rtol=LOSS_RTOL)
    assert max_param_diff(full.params, P.from_numpy(
        jax.tree.map(np.asarray, resumed.params), "cpu")) <= PARAM_ATOL


def test_multihead_checkpoint_into_single_head_engine_raises(splits,
                                                             tmp_path):
    _, t_tr = splits
    d = str(tmp_path / "ck")
    TT.TrainEngine("conv1d", T_SMALL, DEFAULT_HEADS, device="cpu",
                   steps=2, batch_size=32, ckpt_dir=d).fit(t_tr)
    with pytest.raises(ValueError, match="leaves"):
        TT.TrainEngine("conv1d", T_SMALL, "latency_us", device="cpu",
                       steps=4, batch_size=32, ckpt_dir=d).fit(t_tr)


def test_make_sgd_step_matches_reference(splits):
    """The minimal public step builder: three steps on one batch from
    the same params; losses at rounding level, as the engines' first
    steps, params within PARAM_ATOL (measured 1.8e-6)."""
    r_tr, t_tr = splits
    p0 = ref_init("conv1d", DEFAULT_HEADS)
    y, _ = R_DS.stacked_normalized_targets(r_tr.targets, DEFAULT_HEADS)
    ids, y = r_tr.ids[:32], y[:32]
    r_cfg = R_ADAMW.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    t_cfg = T_ADAMW.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    r_step = jax.jit(RT.make_sgd_step(RM.conv_apply, r_cfg,
                                      heads=DEFAULT_HEADS))
    t_step = TT.make_sgd_step(TT.CM.conv_apply, t_cfg, heads=DEFAULT_HEADS)
    rp = jax.tree.map(jax.numpy.asarray, p0)
    tp = P.from_numpy(p0, "cpu")
    rs, ts = R_ADAMW.init_state(rp), T_ADAMW.init_state(tp)
    for _ in range(3):
        rp, rs, r_loss = r_step(rp, rs, jax.numpy.asarray(ids),
                                jax.numpy.asarray(y))
        tp, ts, t_loss = t_step(tp, ts, torch.from_numpy(ids),
                                torch.from_numpy(y))
        np.testing.assert_allclose(float(t_loss), float(r_loss),
                                   rtol=EARLY_RTOL)
    assert max_param_diff(rp, tp) <= PARAM_ATOL
