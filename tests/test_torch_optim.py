"""The port's optimizer pieces and data loader against the reference's:
AdamW with its schedules and clipping, int8 error-feedback compression,
and the deterministic, resumable Loader. Inputs are seeded with numpy;
each test states its tolerance."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as R_PIPE
from repro.optim import adamw as R_ADAMW
from repro.optim import compress as R_COMP
from repro_torch import params as P
from repro_torch.data import pipeline as T_PIPE
from repro_torch.optim import adamw as T_ADAMW
from repro_torch.optim import compress as T_COMP

# float32 through the same formulas: the two sides may round a product
# or a pow differently by an ulp, which 5 steps of AdamW keep well under
# this (measured ~1e-8)
ADAMW_TOL = 1e-6
# the error state is g - dequantize(quantize(g)) in float32 on both sides
COMP_TOL = 1e-7


def mixed_tree(rng, scale=1.0):
    """A param-like tree with leaves of ndim 0-3 (decay applies to
    ndim >= 2 only) in dicts and a list, keys out of sorted order."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w2": a(6, 4), "b": a(4), "convs": [{"w": a(2, 3, 4),
                                                 "b": a(4)}],
            "heads": {"z": {"w": a(4, 1), "b": a(1)},
                      "a": {"w": a(4, 1), "b": a(1)}},
            "s": a()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_trees_close(ref, got, tol):
    r = jax.tree.leaves(ref)
    g = P.tree_flatten(got)
    assert len(r) == len(g)
    for x, y in zip(r, g):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_matches_reference(schedule, clip):
    """Five steps through warmup (2 steps) into decay (total 6), with the
    global norm far above clip_norm (active) or below it (inactive)."""
    rng = np.random.default_rng(0)
    params = mixed_tree(rng)
    scale = 5.0 if clip == "active" else 0.01
    grads = [mixed_tree(rng, scale) for _ in range(5)]
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2,
                  total_steps=6, schedule=schedule, clip_norm=1.0)
    rcfg, tcfg = R_ADAMW.AdamWConfig(**cfg_kw), T_ADAMW.AdamWConfig(**cfg_kw)
    rp, tp = to_jax(params), P.from_numpy(params, "cpu")
    rs, ts = R_ADAMW.init_state(rp), T_ADAMW.init_state(tp)
    for g in grads:
        rp, rs, rm = R_ADAMW.apply_updates(rp, to_jax(g), rs, rcfg)
        tp, ts, tm = T_ADAMW.apply_updates(tp, P.from_numpy(g, "cpu"), ts,
                                           tcfg)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=ADAMW_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=ADAMW_TOL)
        if clip == "active":
            assert float(tm["grad_norm"]) > tcfg.clip_norm
        else:
            assert float(tm["grad_norm"]) < tcfg.clip_norm
    assert int(ts["count"]) == int(rs["count"]) == 5
    assert ts["count"].dtype == torch.int32 and ts["count"].ndim == 0
    assert_trees_close(rp, tp, ADAMW_TOL)
    assert_trees_close(rs["m"], ts["m"], ADAMW_TOL)
    assert_trees_close(rs["v"], ts["v"], ADAMW_TOL)
    # the input tree is not modified, and dict order survives
    assert list(tp) == list(params)
    assert list(tp["heads"]) == ["z", "a"]


@pytest.mark.parametrize("limit", [4, 40, 1 << 30])
def test_adamw_grouped_update_same_bits(limit):
    """Updated a bounded group of leaves at a time (a leaf a group, a
    few, all), AdamW gives the bits of the whole-tree update, three steps
    with clipping active."""
    rng = np.random.default_rng(1)
    params = P.from_numpy(mixed_tree(rng), "cpu")
    grads = [P.from_numpy(mixed_tree(rng, 5.0), "cpu") for _ in range(3)]
    cfg = T_ADAMW.AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=2,
                              total_steps=6)
    out = {}
    for lim in (1 << 30, limit):
        with mock.patch.object(T_ADAMW, "GROUP_BYTES", lim):
            p, s = params, T_ADAMW.init_state(params)
            for g in grads:
                p, s, _ = T_ADAMW.apply_updates(p, g, s, cfg)
        out[lim] = P.tree_flatten(p) + P.tree_flatten(s["m"]) + \
            P.tree_flatten(s["v"])
    assert len(T_ADAMW._groups(P.tree_flatten(params), limit)) == \
        {4: 9, 40: 5, 1 << 30: 1}[limit]
    for a, b in zip(out[1 << 30], out[limit]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    cfg_kw = dict(lr=3e-3, warmup_steps=7, total_steps=50,
                  schedule=schedule)
    rcfg, tcfg = R_ADAMW.AdamWConfig(**cfg_kw), T_ADAMW.AdamWConfig(**cfg_kw)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(R_ADAMW.schedule_lr(rcfg, jnp.asarray(steps)))
    got = T_ADAMW.schedule_lr(tcfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=ADAMW_TOL, atol=0)
    # min_lr_ratio 0.1 at the end of any decay
    if schedule != "constant":
        assert abs(got[-1] - 3e-4) < 1e-9


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    tree = mixed_tree(rng, 3.0)
    rn = R_ADAMW.global_norm(to_jax(tree))
    tn = T_ADAMW.global_norm(P.from_numpy(tree, "cpu"))
    np.testing.assert_allclose(float(tn), float(rn), rtol=ADAMW_TOL)
    rc, _ = R_ADAMW.clip_by_global_norm(to_jax(tree), 1.0)
    tc, _ = T_ADAMW.clip_by_global_norm(P.from_numpy(tree, "cpu"), 1.0)
    assert_trees_close(rc, tc, ADAMW_TOL)
    np.testing.assert_allclose(float(T_ADAMW.global_norm(tc)), 1.0,
                               rtol=1e-6)


def test_compress_grads_matches_reference():
    """Three rounds of error feedback: the same int8 codes every round
    (round half to even on both sides) and error states within 1e-7."""
    rng = np.random.default_rng(2)
    params = mixed_tree(rng)
    r_err = R_COMP.init_error_state(to_jax(params))
    t_err = T_COMP.init_error_state(P.from_numpy(params, "cpu"))
    for k in range(3):
        g = mixed_tree(rng, 0.1 * (k + 1))
        rg, r_err = R_COMP.compress_grads(to_jax(g), r_err)
        tg, t_err = T_COMP.compress_grads(P.from_numpy(g, "cpu"), t_err)
        assert_trees_close(rg, tg, COMP_TOL)
        assert_trees_close(r_err, t_err, COMP_TOL)
    # the codes themselves, including exact halves
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.49, 127.0, -127.0],
                 np.float32)
    rq, rs = R_COMP.quantize(jnp.asarray(x))
    tq, ts = T_COMP.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(ts), float(rs), rtol=COMP_TOL)
    np.testing.assert_array_equal(
        T_COMP.dequantize(tq, ts).numpy(),
        np.asarray(R_COMP.dequantize(rq, rs)))
    # round half to even, as the reference does
    half = torch.tensor([0.5, 1.5, 2.5, -2.5])
    assert torch.round(half).tolist() == [0.0, 2.0, 2.0, -2.0]


# ---------------------------------------------------------------- Loader
def _source(mod, n=203, width=40):
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 50, (n, width)).astype(np.int32)
    lens = rng.integers(1, width + 1, n)
    ids[np.arange(width)[None, :] >= lens[:, None]] = 0
    bucket_by = np.where(lens + 2 <= 16, 16, np.where(lens + 2 <= 32, 32,
                                                       width))
    return mod.ArraySource(ids=ids, row=np.arange(n)), bucket_by


LOADER_CASES = {
    "unbucketed": dict(),
    "batch_max": dict(bucketed=True),
    "homogeneous": dict(bucketed=True, bucket_mode="homogeneous",
                        drop_remainder=False),
    "sharded": dict(bucketed=True, shard_index=1, num_shards=2),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
@pytest.mark.parametrize("resume_at", [None, 5])
def test_loader_matches_reference(case, resume_at):
    """Equal batches, in order, across two epochs; with ``resume_at``, a
    fresh loader of each side restarts from the other's mid-epoch
    ``LoaderState`` (as the trainer does from a checkpoint) and goes on
    with the same batches."""
    kw = dict(LOADER_CASES[case])
    bucketed = kw.pop("bucketed", False)
    loaders = []
    for mod in (R_PIPE, T_PIPE):
        src, bucket_by = _source(mod)
        loaders.append(mod.Loader(src, 16, seed=7, **kw,
                                  bucket_by=bucket_by if bucketed else None))
    r_ld, t_ld = loaders
    steps = r_ld.steps_per_epoch()
    assert steps == t_ld.steps_per_epoch() and steps > 5
    r_it, t_it = iter(r_ld), iter(t_ld)
    n = resume_at if resume_at is not None else 2 * steps + 1
    for _ in range(n):
        rb, tb = next(r_it), next(t_it)
        assert set(rb) == set(tb)
        for k in rb:
            np.testing.assert_array_equal(tb[k], rb[k])
    if resume_at is None:
        return
    assert t_ld.state.as_dict() == r_ld.state.as_dict() == {
        "epoch": 0, "step_in_epoch": resume_at}
    # cross over: the port resumes from the reference's cursor and the
    # reference from the port's
    src_t, bucket_by = _source(T_PIPE)
    src_r, _ = _source(R_PIPE)
    t2 = T_PIPE.Loader(src_t, 16, seed=7, **kw,
                       bucket_by=bucket_by if bucketed else None,
                       state=T_PIPE.LoaderState(**r_ld.state.as_dict()))
    r2 = R_PIPE.Loader(src_r, 16, seed=7, **kw,
                       bucket_by=bucket_by if bucketed else None,
                       state=R_PIPE.LoaderState(**t_ld.state.as_dict()))
    t2_it, r2_it = iter(t2), iter(r2)
    for _ in range(steps + 2):           # past the epoch boundary
        want = next(r_it)
        for got in (next(t2_it), next(r2_it)):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
