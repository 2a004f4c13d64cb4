"""The port's mesh paths as spawned gloo ranks on the CPU, against one
device: the cost-model ``TrainEngine`` on (2, 1), (1, 2) and (2, 2)
meshes (with the restore and re-shard of a checkpoint on the first), the
LM steps with ``rules`` on a (2, 2) mesh (four reduced archs, padded
heads), ``make_compressed_psum`` on four ranks against the
reference's under ``jax.vmap``, and the table lookup of a table split
on its rows (float64: exact, its gradient within 1e-12).

Each child takes one torch thread and its group's store is a file in
``tmp_path`` (no TCP port: several test workers share the machine);
rank 0 writes what it found to ``tmp_path`` for the parent to check.

Limits:

* the engine's params after one step within 1e-5 of one device's
  (measured <= 1.5e-11); its first 10 losses within 1e-3 relative, the
  card's ``train`` phase limit for its reason: AdamW's first steps move
  rounding-noise components by +-lr, and an int8 quantum flips where
  two sums differ in their last bits (measured <= 3e-4 on (2, 2));
* the LM step with rules within 1e-5 of the tree's largest value of
  ``rules=None``'s (measured <= 3e-8); prefill logits within 1e-5 of
  their largest value (measured <= 1e-6); decode tokens equal over 8
  steps, caches within 1e-5 of their largest value.
"""
import functools
import pickle
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import params as P

PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-3
LM_RTOL = 1e-5
LM_ARCHS = ("qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
            "xlstm-125m")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _child(rank, n, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(n, tmp_path, fn, *args):
    mp.spawn(_child, args=(n, str(tmp_path / "store"), fn, args), nprocs=n,
             join=True)


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# ------------------------------------------------------- the cost model
def _dataset():
    from repro_torch.ir import dataset as DS
    return DS.build_dataset(300, mode="ops", max_seq=96, vocab_size=512,
                            augment_factor=2, seed=1)


def _fits(mesh, ds):
    """(params after 1 step, first 10 losses, first 10 losses with int8
    compression) of conv1d on ``mesh``."""
    from repro_torch.configs.costmodel import COSTMODEL_SMALL
    from repro_torch.core import trainer as TR
    from repro_torch.core.models import DEFAULT_HEADS

    def fit(steps, compressed):
        return TR.TrainEngine(
            "conv1d", COSTMODEL_SMALL, DEFAULT_HEADS, device="cpu",
            steps=steps, batch_size=32, log_every=1, mesh_data=mesh[0],
            mesh_model=mesh[1], compress_grads=compressed).fit(ds)
    one = fit(1, False)
    return (P.to_numpy(one.params),
            [loss for _, loss in fit(10, False).history],
            [loss for _, loss in fit(10, True).history])


def _engine_rank(rank, mesh, out, ckpt_dir):
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.costmodel import COSTMODEL_SMALL
    from repro_torch.core import models as CM
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import fault
    from repro_torch.runtime import sharding as SH
    res = {"fits": _fits(mesh, _dataset())}
    if ckpt_dir is not None:
        # a checkpoint saved by one process, restored onto this mesh, then
        # re-sharded onto the transposed mesh
        saved, _, _ = ckpt.restore(ckpt_dir, _LIKE())
        rules = SH.ShardingRules(make_debug_mesh(*mesh))
        axes = CM.get_axes("conv1d")(COSTMODEL_SMALL,
                                      heads=CM.DEFAULT_HEADS)
        like = P.tree_map(torch.zeros_like, saved)
        placed, step, _ = fault.TrainSupervisor(ckpt_dir).try_restore(
            like, shardings=SH.tree_shardings(rules, axes, like))
        res["restored_step"] = step
        res["restored_placements"] = sorted(
            {str(t.placements) for t in P.tree_flatten(placed)})
        res["restored"] = P.to_numpy(P.tree_map(
            lambda t: t.full_tensor(), placed))
        other = SH.ShardingRules(make_debug_mesh(mesh[1], mesh[0]))
        moved = fault.elastic_reshard(placed, mesh, other, axes)
        res["resharded_placements"] = sorted(
            {str(t.placements) for t in P.tree_flatten(moved)})
        res["resharded"] = P.to_numpy(P.tree_map(
            lambda t: t.full_tensor(), moved))
    if rank == 0:
        _dump(out, res)


def _LIKE():
    from repro_torch.configs.costmodel import COSTMODEL_SMALL
    from repro_torch.core import models as CM
    return P.from_numpy(CM.get_model("conv1d")[0](
        COSTMODEL_SMALL, heads=CM.DEFAULT_HEADS,
        generator=torch.Generator().manual_seed(5)), "cpu")


def _max_diff(a, b) -> float:
    return max(float(np.abs(x - y).max())
               for x, y in zip(P.tree_flatten(a), P.tree_flatten(b)))


@pytest.fixture(scope="module")
def one_device():
    return _fits((1, 1), _dataset())


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_cost_model_engine_on_a_mesh(mesh, tmp_path, one_device):
    """conv1d on a data x model mesh of gloo ranks holds one device's run
    (the same seed, the same global batches); on (2, 1) a checkpoint
    that one process saved is restored onto the mesh by ``shardings``
    and re-sharded onto (1, 2) with the same values."""
    from repro_torch.checkpoint import ckpt
    ckpt_dir = None
    if mesh == (2, 1):
        ckpt_dir = str(tmp_path / "ck")
        ckpt.save(ckpt_dir, 7, _LIKE())
    out = str(tmp_path / "res.pkl")
    spawn(mesh[0] * mesh[1], tmp_path, _engine_rank, mesh, out, ckpt_dir)
    got = _load(out)
    want = one_device
    assert _max_diff(got["fits"][0], want[0]) <= PARAM_ATOL
    for g, w in ((got["fits"][1], want[1]), (got["fits"][2], want[2])):
        assert len(g) == len(w) == 10
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL)
    if ckpt_dir is not None:
        like = P.to_numpy(_LIKE())
        assert got["restored_step"] == 7
        assert "Shard" in "".join(got["restored_placements"])
        assert _max_diff(got["restored"], like) == 0.0
        assert _max_diff(got["resharded"], like) == 0.0
        assert got["resharded_placements"] != got["restored_placements"]


# --------------------------------------------------- the LM steps, psum
def _float32(M):
    return (mock.patch.object(M, "forward", functools.partial(
        M.forward, cdt=torch.float32)),
        mock.patch.object(M, "decode_forward", functools.partial(
            M.decode_forward, cdt=torch.float32)))


def _lm_case(cfg, rules, B=4, S=16, steps=8):
    """(params rel diff after one step, loss diff, decode tokens equal,
    caches rel diff, prefill logits rel diff) of rules against
    rules=None."""
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(1, cfg.vocab, (B, S), dtype=torch.int32, generator=g)
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn(
            B, cfg.vision_patches, cfg.d_model, generator=g) * 0.02
    if cfg.frontend == "audio":
        batch["frame_embeds"] = torch.randn(
            B, cfg.encoder_seq, cfg.d_model, generator=g) * 0.02
    # eps 1e-5: at 1e-8 noise-level gradients step +-lr either way
    opt_cfg = adamw.AdamWConfig(eps=1e-5)
    a, b = _float32(M)
    with a, b:
        p0, _, m0 = ST.make_train_step(cfg, opt_cfg)(
            params, adamw.init_state(params), batch)
        dp = SH.place_tree(params, SH.tree_shardings(
            rules, M.param_axes(cfg), params))
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        l0 = ST.make_prefill_step(cfg)(params, prompt)
        l1 = ST.make_prefill_step(cfg, rules=rules)(dp, prompt)
        lrel = float((l1.full_tensor() - l0).abs().max() / l0.abs().max())
        p1, _, m1 = ST.make_train_step(cfg, opt_cfg, rules=rules)(
            dp, adamw.init_state(dp), batch)
        top = max(float(t.abs().max()) for t in P.tree_flatten(p0))
        prel = max(float((x.full_tensor() - y).abs().max())
                   for x, y in zip(P.tree_flatten(p1),
                                   P.tree_flatten(p0))) / top
        c0 = M.init_cache(cfg, B, steps, kv_dtype=torch.float32)
        c1 = SH.place_tree(M.init_cache(cfg, B, steps,
                                        kv_dtype=torch.float32),
                           SH.tree_shardings(rules, M.cache_axes(cfg), c0))
        d0 = ST.make_decode_step(cfg)
        d1 = ST.make_decode_step(cfg, rules=rules)
        t0 = t1 = tok[:, :1]
        same = True
        for i in range(steps):
            t0, c0 = d0(params, c0, t0, i)
            t1, c1 = d1(dp, c1, t1, i)
            same &= bool(torch.equal(t1.full_tensor(), t0))
        ctop = max(float(t.abs().max()) for t in P.tree_flatten(c0))
        crel = max(float((x.full_tensor() - y).abs().max())
                   for x, y in zip(P.tree_flatten(c1),
                                   P.tree_flatten(c0))) / ctop
    return (prel, abs(float(m1["total_loss"]) - float(m0["total_loss"])),
            same, crel, lrel)


def _gather_rows_case(mesh):
    """Whether ``sharding.gather_rows`` gives ``table[ids]`` exactly and
    its table gradient within 1e-12 (float64: the ranks' partial sums
    add in another order) for every split of the table's rows and width
    and of the ids over the mesh, in ids' placements."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.runtime import sharding as SH
    g = torch.Generator().manual_seed(2)
    table = torch.randn(64, 16, generator=g, dtype=torch.float64)
    ids = torch.randint(0, 64, (8, 5), generator=g)
    w = torch.randn(8, 5, 16, generator=g, dtype=torch.float64)
    want = table.clone().requires_grad_()
    (want[ids] * w).sum().backward()
    ok = True
    r, s0, s1 = Replicate(), Shard(0), Shard(1)
    for tpl in ((s1, s0), (r, s0), (s0, r), (s1, r), (r, r)):
        for ipl in ((s0, s0), (s0, r), (r, r)):
            dt = SH.place(table, (mesh, tpl)).requires_grad_()
            di = SH.place(ids, (mesh, ipl))
            out = SH.gather_rows(dt, di)
            grad, = torch.autograd.grad(
                (out * SH.place(w, (mesh, ipl))).sum(), dt)
            ok &= tuple(out.placements) == ipl
            ok &= torch.equal(out.full_tensor(), table[ids])
            ok &= torch.allclose(grad.redistribute(mesh, tpl).full_tensor(),
                                 want.grad, rtol=1e-12, atol=1e-12)
    return ok


def _lm_rank(rank, out):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import compress
    from repro_torch.runtime import sharding as SH
    rules = SH.ShardingRules(make_debug_mesh(2, 2))
    res = {name: _lm_case(get_arch(name).reduced(), rules)
           for name in LM_ARCHS}
    # a batch of 2 leaves the model axis to the sequence (context
    # parallelism: the residual stream split on it)
    res["seq_split"] = _lm_case(get_arch("qwen3-0.6b").reduced(), rules,
                                B=2)
    # 3 heads do not divide the 2-way model axis: padded to 4
    padded = SH.ShardingRules(rules.mesh)
    padded.pad_attention_heads = True
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), n_heads=3,
                              n_kv_heads=1)
    assert not padded.divisible(cfg.n_heads, "model")
    res["padded"] = _lm_case(cfg, padded)
    res["gather_rows"] = _gather_rows_case(rules.mesh)
    # the int8 all-reduce over the four ranks
    grad = torch.from_numpy(np.random.default_rng(rank).normal(
        size=(33, 7)).astype(np.float32) * (rank + 1))
    res["psum"] = compress.make_compressed_psum()(grad).numpy()
    if rank == 0:
        _dump(out, res)


def test_lm_steps_with_rules_and_compressed_psum(tmp_path):
    """Four reduced archs (dense, MoE, hybrid mamba, xlstm), a padded
    head count and a batch of 2 (the sequence split over ``model``) on a
    (2, 2) mesh: a train step, a prefill and 8 decode steps with rules
    as without; make_compressed_psum bit-equal to the reference's under
    ``jax.vmap`` on the four ranks' gradients; the table lookup with its
    rows split exact in values, its table gradient within 1e-12."""
    import jax
    import jax.numpy as jnp

    from repro.optim import compress as R_COMPRESS
    out = str(tmp_path / "res.pkl")
    spawn(4, tmp_path, _lm_rank, out)
    got = _load(out)
    for name in (*LM_ARCHS, "padded", "seq_split"):
        prel, dloss, same, crel, lrel = got[name]
        assert prel <= LM_RTOL, (name, prel)
        assert dloss <= LM_RTOL, (name, dloss)
        assert same, name
        assert crel <= LM_RTOL, (name, crel)
        assert lrel <= LM_RTOL, (name, lrel)
    grads = np.stack([np.random.default_rng(r).normal(
        size=(33, 7)).astype(np.float32) * (r + 1) for r in range(4)])
    want = jax.vmap(R_COMPRESS.make_compressed_psum("i"),
                    axis_name="i")(jnp.asarray(grads))
    np.testing.assert_array_equal(got["psum"], np.asarray(want)[0])
    assert got["gather_rows"]
