"""The port's checkpoints and supervisor: leaves in the reference's
flatten order, files either side restores, structure drift caught, and
the reference's atomic-save and resume contract."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as R_CKPT
from repro.configs import COSTMODEL_SMALL as R_SMALL
from repro.core import models as RM
from repro.optim import adamw as R_ADAMW
from repro.optim import compress as R_COMP
from repro_torch import params as P
from repro_torch.checkpoint import ckpt as T_CKPT
from repro_torch.configs.costmodel import COSTMODEL_SMALL as T_SMALL
from repro_torch.core.models import DEFAULT_HEADS, get_model
from repro_torch.optim import adamw as T_ADAMW
from repro_torch.optim import compress as T_COMP
from repro_torch.runtime import fault as T_FAULT


def ref_params(kind, heads):
    init = RM.get_model(kind)[0]
    p = init(jax.random.PRNGKey(0), R_SMALL, heads=heads) if heads \
        else init(jax.random.PRNGKey(0), R_SMALL)
    return jax.tree.map(np.asarray, p)


def states(kind, heads, compress):
    """The trainer's (params, opt_state, err) on both sides, from the
    same numpy params."""
    p = ref_params(kind, heads)
    rp = jax.tree.map(jnp.asarray, p)
    tp = P.from_numpy(p, "cpu")
    r = (rp, R_ADAMW.init_state(rp),
         R_COMP.init_error_state(rp) if compress else None)
    t = (tp, T_ADAMW.init_state(tp),
         T_COMP.init_error_state(tp) if compress else None)
    return r, t


def ref_paths(tree):
    return list(R_CKPT._tree_paths(tree))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("heads", [None, DEFAULT_HEADS])
@pytest.mark.parametrize("kind", ["conv1d", "lstm", "fc", "xformer"])
def test_flatten_order_is_the_references(kind, heads, compress):
    """Paths and leaf shapes in the reference's flatten order: params
    sorted, then count, m, v, then err with compression."""
    r, t = states(kind, heads, compress)
    got = P.tree_flatten_with_paths(t)
    assert [p for p, _ in got] == ref_paths(r)
    assert [tuple(x.shape) for _, x in got] == \
        [tuple(x.shape) for x in jax.tree.leaves(r)]
    # the port's own init inserts emb first; the files sort the keys,
    # as the reference's flatten does: emb after convs (conv1d), b
    # (lstm) and blocks (xformer), still first in fc
    init = get_model(kind)[0]
    native = init(T_SMALL, heads,
                  generator=torch.Generator().manual_seed(0))
    assert list(native)[0] == "emb"
    assert [p for p, _ in P.tree_flatten_with_paths(native)] == \
        ref_paths(r[0])
    if kind == "conv1d" and heads and not compress:
        assert len(got) == 70
        assert got[0][0] == "0/convs/0/b"
        names = [p for p, _ in got]
        assert names.index("0/heads/latency_us/b") < \
            names.index("0/heads/register_pressure/b")
        assert names[23] == "1/count"


def test_unflatten_keeps_the_tree_and_its_key_order():
    tp = P.conv_init(T_SMALL, DEFAULT_HEADS,
                     generator=torch.Generator().manual_seed(0))
    flat = P.tree_flatten(tp)
    back = P.tree_unflatten(tp, flat)
    assert list(back) == list(tp) and list(back["heads"]) == \
        list(DEFAULT_HEADS)
    assert all(a is b for a, b in zip(P.tree_flatten(back), flat))
    with pytest.raises(ValueError):
        P.tree_unflatten(tp, flat[:-1])


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("kind", ["conv1d", "lstm", "fc", "xformer"])
def test_port_checkpoint_restores_in_reference(kind, compress, tmp_path):
    r, t = states(kind, DEFAULT_HEADS, compress)
    rng = np.random.default_rng(0)
    # make every leaf distinct so a permutation could not pass
    t = P.tree_unflatten(t, [
        torch.from_numpy(rng.standard_normal(tuple(x.shape))
                         .astype(np.float32)) if x.is_floating_point()
        else torch.tensor(11, dtype=torch.int32)
        for x in P.tree_flatten(t)])
    extra = {"loader": {"epoch": 1, "step_in_epoch": 3},
             "heads": list(DEFAULT_HEADS)}
    T_CKPT.save(str(tmp_path), 9, t, extra=extra)
    got, step, got_extra = R_CKPT.restore(str(tmp_path), r, verify=True,
                                          check_treedef=True)
    assert step == 9 and got_extra == extra
    for a, b in zip(jax.tree.leaves(got), P.tree_flatten(t)):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(got[1]["count"]) == 11


@pytest.mark.parametrize("kind", ["conv1d", "lstm", "fc", "xformer"])
def test_reference_checkpoint_restores_in_port(kind, tmp_path):
    r, t = states(kind, DEFAULT_HEADS, False)
    rng = np.random.default_rng(1)
    r = jax.tree.unflatten(jax.tree.structure(r), [
        jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
        if x.dtype == jnp.float32 else jnp.int32(5)
        for x in jax.tree.leaves(r)])
    R_CKPT.save(str(tmp_path), 4, r, extra={"note": "ref"})
    got, step, extra = T_CKPT.restore(str(tmp_path), t, verify=True)
    assert step == 4 and extra == {"note": "ref"}
    assert list(got[0]["heads"]) == list(t[0]["heads"])   # like's order
    for a, b in zip(jax.tree.leaves(r), P.tree_flatten(got)):
        assert torch.is_tensor(b) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got[1]["count"].dtype == torch.int32
    assert int(got[1]["count"]) == 5


def test_restore_rejects_structure_drift(tmp_path):
    _, (multi, _, _) = states("conv1d", DEFAULT_HEADS, False)
    _, (single, _, _) = states("conv1d", None, False)
    T_CKPT.save(str(tmp_path / "m"), 1, multi)
    with pytest.raises(ValueError, match="leaves"):
        T_CKPT.restore(str(tmp_path / "m"), single)
    # same count and shapes, other names: caught by the recorded paths
    renamed = dict(multi, heads={f"x_{k}": v
                                 for k, v in multi["heads"].items()})
    with pytest.raises(ValueError, match="structure"):
        T_CKPT.restore(str(tmp_path / "m"), renamed)
    T_CKPT.restore(str(tmp_path / "m"), renamed, check_treedef=False)
    # a shape that differs
    bad = dict(multi, emb=torch.zeros(7, 16))
    with pytest.raises(ValueError, match="leaf"):
        T_CKPT.restore(str(tmp_path / "m"), bad)
    # ... also for a reference checkpoint, which records no paths
    R_CKPT.save(str(tmp_path / "r"), 1, jax.tree.map(
        jnp.asarray, ref_params("conv1d", DEFAULT_HEADS)))
    with pytest.raises(ValueError, match="leaves"):
        T_CKPT.restore(str(tmp_path / "r"), single)


def test_atomic_save_newest_commit_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "nested": {"b": torch.ones(5), "count": torch.tensor(
                 7, dtype=torch.int32)}}
    for s in [1, 2, 3, 4, 5]:
        T_CKPT.save(d, s, state, keep=3)
    assert T_CKPT.latest_steps(d) == [3, 4, 5]
    os.makedirs(os.path.join(d, "step_000000009"))    # crash mid-save
    restored, step, _ = T_CKPT.restore(d, state)
    assert step == 5
    _, step, _ = T_CKPT.restore(d, state, step=4)
    assert step == 4
    assert torch.equal(restored["w"], state["w"])
    with pytest.raises(FileNotFoundError):
        T_CKPT.restore(str(tmp_path / "none"), state)


def test_supervisor_resumes_after_crash(tmp_path):
    """The reference's supervisor test on the port's checkpoint."""
    d = str(tmp_path / "ck")
    sup = T_FAULT.TrainSupervisor(d, save_every=5, max_step_retries=0)
    calls = {"n": 0}

    def crashing_step(state, step):
        calls["n"] += 1
        if step == 7 and calls["n"] <= 8:
            raise RuntimeError("injected node failure")
        return {"w": state["w"] + 1}

    with pytest.raises(RuntimeError):
        sup.run({"w": torch.zeros(())}, crashing_step, 10)
    state2, start, _ = sup.try_restore({"w": torch.zeros(())})
    assert start == 7  # crash-save at step 7
    final = sup.run(state2, crashing_step, 10, start_step=start)
    assert float(final["w"]) == 10.0
    # no directory: persistence off, nothing restored
    none = T_FAULT.TrainSupervisor(None)
    s, start, extra = none.try_restore({"w": torch.zeros(())})
    assert start == 0 and extra == {}


def test_straggler_detection_and_rebalance():
    mon = T_FAULT.HeartbeatMonitor(4, straggler_factor=2.0, timeout_s=10)
    now = 100.0
    for w in range(4):
        for _ in range(5):
            mon.beat(w, step_duration=1.0 if w != 2 else 5.0, now=now)
    assert mon.stragglers(now=now) == [2]
    new = mon.rebalance_shards({0: 4, 1: 4, 2: 4, 3: 4}, now=now)
    assert new[2] == 3 and sum(new.values()) == 16
    mon.beat(3, now=now)
    assert 1 not in mon.stragglers(now=now + 5)
    assert set(mon.stragglers(now=now + 50)) == {0, 1, 2, 3}
