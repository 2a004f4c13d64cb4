"""The port's TrainEngine on its own, case by case as the reference's
``tests/test_train_engine.py``, with the reference's FC family and the
LSTM (and, for the full substrate and the stats, the transformer) where
the reference runs FC: bucketed (batch_max) training reaches the eval metrics of
max_seq padding; the id storage layout does not change training;
kill-and-resume reproduces the uninterrupted run; the full substrate
(multi-head, int8 compression, checkpoints) runs through the one loop;
the stats are populated. On the CPU (``device="cpu"``); the card's
deterministic resume is checked by ``chip_smoke.py``.

The embedding gather's backward accumulates rows from several threads,
so two runs of one step differ in the last bits of the embedding's
gradient (~1e-9), which AdamW amplifies over 40 steps (~2e-5). The
checks that two runs are equal therefore run under
``torch.use_deterministic_algorithms(True)``, as the card's does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import params as P
from repro_torch.configs.costmodel import COSTMODEL_SMALL
from repro_torch.core import trainer as TR
from repro_torch.core.models import DEFAULT_HEADS
from repro_torch.core.service import CostModelService, pad_slack
from repro_torch.data import pipeline as PIPE
from repro_torch.ir import dataset as DS

CPU = dict(device="cpu")


def cfg_for(kind):
    """COSTMODEL_SMALL, with the transformer's position table as long as
    the dataset's 96 tokens."""
    if kind == "xformer":
        return dataclasses.replace(COSTMODEL_SMALL, max_seq=96)
    return COSTMODEL_SMALL


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
def small_dataset():
    return DS.build_dataset(300, mode="ops", max_seq=96, vocab_size=512,
                            augment_factor=2, seed=1)


@pytest.fixture(scope="module")
def split(small_dataset):
    return small_dataset.split(0.1)


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _param_diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(P.tree_flatten(a), P.tree_flatten(b)))


# -------------------------------------------------------------- bucketing
@pytest.mark.parametrize("kind", ["conv1d", "lstm", "fc"])
def test_bucketed_training_parity(kind, split):
    """batch_max bucketing reaches eval metrics within tolerance of
    max_seq padding on the same seed, for conv1d (bucket widths include
    the pad-slack rule) and the LSTM (a masking family). As in the
    reference: per-step gradients agree to rounding, which AdamW
    amplifies into small param drift, so eval metrics are compared."""
    tr, te = split
    steps = 60 if kind == "lstm" else 120
    res_b = TR.TrainEngine(kind, COSTMODEL_SMALL, "register_pressure",
                           steps=steps, batch_size=64, seed=0,
                           bucketed=True, **CPU).fit(tr)
    res_p = TR.TrainEngine(kind, COSTMODEL_SMALL, "register_pressure",
                           steps=steps, batch_size=64, seed=0,
                           bucketed=False, **CPU).fit(tr)
    mb = TR.evaluate(kind, COSTMODEL_SMALL, res_b, te, "register_pressure")
    mp = TR.evaluate(kind, COSTMODEL_SMALL, res_p, te, "register_pressure")
    assert abs(mb["rmse_norm"] - mp["rmse_norm"]) <= \
        0.10 * mp["rmse_norm"] + 0.02, (mb["rmse_norm"], mp["rmse_norm"])


def test_batch_max_width_contract(split):
    """batch_max mode: identical batch composition to unbucketed loading,
    with each batch's ids at exactly the largest member's bucket."""
    tr, _ = split
    eng = TR.TrainEngine("conv1d", COSTMODEL_SMALL, "register_pressure",
                         batch_size=32, seed=0, **CPU)
    bucket_by = eng.bucket_assignments(tr)
    assert len(np.unique(bucket_by)) > 1, "corpus has one bucket only"
    y, _ = DS.normalize_targets(tr.targets["register_pressure"])
    loader = eng.make_loader(tr, y.astype(np.float32))
    plain = PIPE.Loader(PIPE.ArraySource(ids=tr.ids, y=y,
                                         row=np.arange(tr.n)), 32, seed=0)
    it, it_ref = iter(loader), iter(plain)
    for _ in range(loader.steps_per_epoch()):
        b, ref = next(it), next(it_ref)
        np.testing.assert_array_equal(b["y"], ref["y"])  # same composition
        want = int(bucket_by[ref["row"]].max())
        assert b["ids"].shape[1] == want, (b["ids"].shape, want)
        np.testing.assert_array_equal(
            b["ids"], ref["ids"][:, :b["ids"].shape[1]])


def test_homogeneous_mode_single_bucket_batches(split):
    tr, _ = split
    slack = pad_slack("conv1d", COSTMODEL_SMALL)
    buckets = DS.default_buckets(tr.max_seq)
    bucket_by = DS.bucket_lengths(tr.get_seq_lens(), buckets, slack)
    src = PIPE.ArraySource(ids=tr.ids, y=np.arange(tr.n, dtype=np.int64))
    ld = PIPE.Loader(src, 32, seed=0, bucket_by=bucket_by,
                     bucket_mode="homogeneous", drop_remainder=False)
    it = iter(ld)
    seen = []
    for _ in range(ld.steps_per_epoch()):
        b = next(it)
        rows = b["y"]
        width = b["ids"].shape[1]
        assert width in set(bucket_by.tolist())
        assert bucket_by[rows].max() <= width
        seen.extend(rows.tolist())
    assert sorted(seen) == list(range(tr.n))   # full coverage, no dupes


def test_dataset_layout_does_not_change_training(split, deterministic):
    """Bucket-grouped id storage is an exact drop-in for dense storage."""
    tr, _ = split
    dsb = DS.build_dataset(300, mode="ops", max_seq=96, vocab_size=512,
                           augment_factor=2, seed=1, layout="bucketed")
    trb, _ = dsb.split(0.1)
    np.testing.assert_array_equal(tr.ids, trb.dense_ids())
    a = TR.TrainEngine("conv1d", COSTMODEL_SMALL, "register_pressure",
                       steps=40, batch_size=64, seed=0, **CPU).fit(tr)
    b = TR.TrainEngine("conv1d", COSTMODEL_SMALL, "register_pressure",
                       steps=40, batch_size=64, seed=0, **CPU).fit(trb)
    assert _param_diff(a.params, b.params) == 0.0


# ---------------------------------------------------------- fault tolerance
@pytest.mark.parametrize("kind", ["conv1d", "lstm"])
def test_engine_kill_and_resume_reproduces_run(kind, split, tmp_path,
                                               deterministic):
    """Kill mid-run; a fresh engine restores the last committed checkpoint
    (params + optimizer + loader cursor) and must land on the
    uninterrupted run's final params."""
    tr, _ = split
    kw = dict(steps=40, batch_size=32, seed=3, **CPU)
    full = TR.TrainEngine(kind, COSTMODEL_SMALL, "valu_utilization",
                          **kw).fit(tr)

    class Kill(Exception):
        pass

    def killer(step, dt):
        if step == 17:
            raise Kill()

    d = str(tmp_path / "ck")
    with pytest.raises(Kill):
        TR.TrainEngine(kind, COSTMODEL_SMALL, "valu_utilization",
                       ckpt_dir=d, save_every=10, **kw).fit(
                           tr, on_step=killer)
    resumed = TR.TrainEngine(kind, COSTMODEL_SMALL, "valu_utilization",
                             ckpt_dir=d, save_every=10, **kw).fit(tr)
    assert resumed.stats["steps"] == 30.0   # resumed from step 10
    for a, b in zip(P.tree_flatten(full.params),
                    P.tree_flatten(resumed.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   rtol=1e-6, atol=1e-7)


def _multihead_with_compression_and_ckpt(kind, split, tmp_path):
    tr, te = split
    heads = ("register_pressure", "latency_us")
    d = tmp_path / "ck"
    res = TR.TrainEngine(kind, cfg_for(kind), heads, steps=60,
                         batch_size=64, seed=0, compress_grads=True,
                         ckpt_dir=str(d), **CPU).fit(tr)
    assert res.heads == heads
    m = TR.evaluate(kind, cfg_for(kind), res, te)
    assert set(m) == set(heads)
    for t in heads:
        assert np.isfinite(m[t]["rmse_norm"])
    # the final checkpoint holds params, count, m, v and the error state
    step_dir = d / "step_000000060"
    assert (step_dir / "_COMMITTED").exists()
    n_params = len(P.tree_flatten(res.params))
    assert len(list(step_dir.glob("leaf_*.npy"))) == 4 * n_params + 1


def test_engine_multihead_with_compression_and_ckpt(split, tmp_path):
    """The full substrate in one run: multi-head joint training, int8
    error-feedback grad compression, checkpointing — through the one
    engine loop."""
    _multihead_with_compression_and_ckpt("lstm", split, tmp_path)


@pytest.mark.parametrize("kind", ["fc", "xformer"])
def test_engine_multihead_with_compression_and_ckpt_families(
        kind, split, tmp_path):
    """The same run for the reference's FC family (the reference's own
    case) and the transformer."""
    _multihead_with_compression_and_ckpt(kind, split, tmp_path)


# ----------------------------------------------------------------- results
def _stats_populated(kind, split):
    tr, _ = split
    res = TR.train_model(kind, cfg_for(kind), tr, "latency_us",
                         steps=30, batch_size=64, log_every=10, **CPU)
    for k in ["final_loss", "steps", "wall_time_s", "steps_per_s"]:
        assert k in res.stats, res.stats
    assert res.stats["steps"] == 30.0
    assert res.stats["steps_per_s"] > 0
    assert np.isfinite(res.stats["final_loss"])
    assert res.history and res.history[-1][0] == 30
    assert [s for s, _ in res.history] == [10, 20, 30]


def test_train_result_stats_populated(split):
    _stats_populated("lstm", split)


@pytest.mark.parametrize("kind", ["fc", "xformer"])
def test_train_result_stats_populated_families(kind, split):
    _stats_populated(kind, split)


# ------------------------------------------------------------ the port's
def test_trained_params_serve_as_they_are(split):
    """TrainResult.params go straight into CostModelService and give the
    rows of a direct forward of the same ids."""
    tr, te = split
    heads = DEFAULT_HEADS
    res = TR.TrainEngine("conv1d", COSTMODEL_SMALL, heads, steps=10,
                         batch_size=32, **CPU).fit(tr)
    svc = CostModelService("conv1d", COSTMODEL_SMALL, res.params, te.vocab,
                           res.norm_stats, max_seq=96, device="cpu")
    ids = te.ids[:8]
    rows = svc._forward(ids)
    _, apply_fn = TR.CM.get_model("conv1d")
    with torch.inference_mode():
        want = apply_fn(res.params, torch.from_numpy(ids))
    np.testing.assert_allclose(
        rows, np.stack([want[t].numpy() for t in svc.heads], 1),
        rtol=1e-5, atol=1e-6)


def test_engine_defaults_to_the_card_and_refuses_a_mesh():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.TrainEngine("conv1d", COSTMODEL_SMALL, "latency_us")
    with pytest.raises(RuntimeError):
        TR.TrainEngine("conv1d", COSTMODEL_SMALL, "latency_us",
                       device="cuda")
    # a mesh runs only inside a process group of its size (none here)
    with pytest.raises(ValueError, match="2 x 1 mesh has 2 places"):
        TR.TrainEngine("conv1d", COSTMODEL_SMALL, "latency_us",
                       mesh_data=2, **CPU)
    with pytest.raises(ValueError, match="2 x 2 mesh has 4 places"):
        TR.TrainEngine("conv1d", COSTMODEL_SMALL, "latency_us",
                       mesh_data=2, mesh_model=2, **CPU)
    # every family trains; an unknown kind names the four
    for kind in ("fc", "xformer"):
        eng = TR.TrainEngine(kind, COSTMODEL_SMALL, "latency_us", **CPU)
        assert eng.apply_fn is TR.CM.get_model(kind)[1]
    with pytest.raises(KeyError, match="xformer"):
        TR.TrainEngine("bogus", COSTMODEL_SMALL, "latency_us", **CPU)


def test_warmup_and_schedule_follow_the_steps(split):
    """AdamW's config as the reference builds it: warmup min(50,
    steps // 10), cosine to 0.1x, the engine's lr and weight decay."""
    tr, _ = split
    seen = {}
    real = TR.adamw.apply_updates

    def spy(params, grads, state, cfg):
        seen["cfg"] = cfg
        return real(params, grads, state, cfg)
    TR.adamw.apply_updates = spy
    try:
        TR.TrainEngine("conv1d", COSTMODEL_SMALL, "latency_us", steps=30,
                       batch_size=32, lr=2e-3, weight_decay=0.05,
                       **CPU).fit(tr)
    finally:
        TR.adamw.apply_updates = real
    cfg = seen["cfg"]
    assert (cfg.warmup_steps, cfg.total_steps, cfg.lr, cfg.weight_decay,
            cfg.b2, cfg.schedule, cfg.min_lr_ratio, cfg.clip_norm) == \
        (3, 30, 2e-3, 0.05, 0.95, "cosine", 0.1, 1.0)
