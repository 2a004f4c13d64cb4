"""The port's sharding resolver (``repro_torch.runtime.sharding``) against
the reference's: ``spec()`` on every leaf of the ten registered archs'
param, cache and batch axes, on the production meshes (16x16, 2x16x16)
and a debug 2x4, with and without the inference ``embed`` override; the
cost model's four axes trees; twins of the reference's resolver tests;
and the port's own DTensor placements and ``constrain``.

The specs need no devices: both packages' rules are built on a
duck-typed mesh (the reference's ``FakeMesh`` as
``tests/test_sharding.py`` builds it). ``constrain`` runs on a one-rank
gloo group and on a fake group of four ranks, each taken down after."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as r_arch
from repro.core import models as R_CM
from repro.models import model as RMODEL
from repro.models import steps as RSTEPS
from repro.runtime import sharding as R_SH
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs import get_arch as t_arch
from repro_torch.configs.costmodel import COSTMODEL_SMALL
from repro_torch.core import models as T_CM
from repro_torch.models import model as TMODEL
from repro_torch.models import steps as TSTEPS
from repro_torch.params import tree_flatten_with_paths
from repro_torch.runtime import sharding as SH

NAMES = sorted(ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


class FakeMesh:
    """Duck-typed mesh for both packages' resolvers (no devices): the
    reference reads ``axis_names`` and ``devices.shape``, the port
    ``mesh_dim_names`` and ``shape``."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = names
        self.devices = np.empty(shape)
        self.shape = shape


def both_rules(mesh, overrides=None):
    m = FakeMesh(*MESHES[mesh]) if isinstance(mesh, str) else mesh
    ref = R_SH.ShardingRules.__new__(R_SH.ShardingRules)
    ref.mesh = m
    ref.rules = dict(R_SH.DEFAULT_RULES)
    for k, v in (overrides or {}).items():
        ref.rules[k] = () if v is None else \
            ((v,) if isinstance(v, str) else tuple(v))
    ref.axis_sizes = dict(zip(m.axis_names, m.devices.shape))
    return ref, SH.ShardingRules(m, overrides=overrides)


def _is_axes(x):
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def axes_leaves(tree, prefix=""):
    """{path: axes tuple} of a logical-axes tree (dict keys sorted)."""
    if _is_axes(tree):
        return {prefix: tree}
    out = {}
    items = sorted(tree.items()) if isinstance(tree, dict) \
        else enumerate(tree)
    for k, v in items:
        out.update(axes_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.fixture(scope="module")
def trees():
    """Per arch: the reference's abstract params (eval_shape) and cache
    shapes, and the port's meta ones."""
    cache = {}

    def get(name):
        if name not in cache:
            rcfg, tcfg = r_arch(name), t_arch(name)
            dec = SHAPES["decode_32k"]
            rp = jax.tree.map(lambda x: tuple(x.shape),
                              RSTEPS.abstract_params(rcfg))
            rc = jax.tree.map(lambda x: tuple(x.shape), RSTEPS.abstract_cache(
                rcfg, dec.global_batch, dec.seq_len))
            tp = {k: tuple(v.shape) for k, v in
                  tree_flatten_with_paths(TSTEPS.abstract_params(tcfg))}
            tc = {k: tuple(v.shape) for k, v in tree_flatten_with_paths(
                TSTEPS.abstract_cache(tcfg, dec.global_batch, dec.seq_len))}
            cache[name] = (rcfg, tcfg, rp, rc, tp, tc)
        return cache[name]
    return get


def _shape_at(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


@pytest.mark.parametrize("embed_override", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_spec_equals_reference(name, mesh, embed_override, trees):
    """Every leaf of param_axes, cache_axes and each shape's batch: the
    port's tuple is the reference's PartitionSpec entry for entry."""
    rcfg, tcfg, rp, rc, tp, tc = trees(name)
    ref, port = both_rules(mesh, {"embed": None} if embed_override
                           else None)
    checked = 0
    for raxes, taxes, rshapes, tshapes in (
            (RMODEL.param_axes(rcfg), TMODEL.param_axes(tcfg), rp, tp),
            (RMODEL.cache_axes(rcfg), TMODEL.cache_axes(tcfg), rc, tc)):
        ra, ta = axes_leaves(raxes), axes_leaves(taxes)
        assert ra == ta
        assert sorted(ta) == sorted(tshapes)
        for path, axes in ta.items():
            shape = tshapes[path]
            assert tuple(_shape_at(rshapes, path)) == shape
            want = tuple(ref.spec(axes, shape))
            assert port.spec(axes, shape) == want, (path, axes, shape)
            checked += 1
    for shp in SHAPES.values():
        for k, v in TSTEPS.input_specs(tcfg, shp).items():
            axes = SH.batch_axes(v)
            assert port.spec(axes, v.shape) == \
                tuple(ref.spec(axes, v.shape)), (shp.name, k)
            checked += 1
    assert checked > 10


@pytest.mark.parametrize("kind", ["fc", "lstm", "conv1d", "xformer"])
def test_costmodel_axes_trees_equal_reference(kind):
    """The four families' axes trees, single-head and multi-head."""
    raxes = R_CM.get_model(kind)[2]
    taxes = T_CM.get_axes(kind)
    assert taxes(COSTMODEL_SMALL) == raxes(COSTMODEL_SMALL)
    heads = R_CM.DEFAULT_HEADS
    assert taxes(COSTMODEL_SMALL, heads=heads) == \
        raxes(COSTMODEL_SMALL, heads=heads)


# ------------------------------ twins of the reference's resolver tests
def test_divisible_dims_shard():
    _, r = both_rules("16x16")
    spec = r.spec(("batch", None, "heads", None), (256, 4096, 32, 128))
    assert spec == tuple(JP(("data", "model"), None, None, None))
    spec2 = r.spec(("batch", None, "heads", None), (32, 4096, 32, 128))
    assert spec2 == ("data", None, "model", None)


def test_indivisible_dims_fall_back_to_replication():
    _, r = both_rules("16x16")
    spec = r.spec(("batch", "qseq", "heads", None), (32, 4096, 40, 128))
    assert spec[2] is None
    assert spec[1] == "model"


def test_axis_never_used_twice():
    _, r = both_rules("16x16")
    assert r.spec(("heads", "ffn"), (32, 1024)) == ("model", None)


def test_batch_composes_pod_and_data():
    _, r = both_rules("2x16x16")
    assert r.spec(("batch", None), (256, 8)) == (("pod", "data"), None)


def test_batch_of_one_replicates():
    _, r = both_rules("2x16x16")
    spec = r.spec(("batch", "cache_seq"), (1, 524288))
    assert spec[0] is None
    assert spec[1] == "model"


def test_overrides():
    _, r = both_rules("16x16", {"batch": ("data", "model")})
    assert r.spec(("batch", None), (256, 8)) == (("data", "model"), None)


def test_real_constrain_on_single_device(tmp_path):
    """A one-rank gloo mesh: a plain tensor passes unchanged, a DTensor
    comes back with every placement Replicate and its values."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        r = SH.ShardingRules(make_debug_mesh(1, 1))
        x = torch.ones((4, 8)) * 2
        assert r.constrain(x, "batch", "embed") is x
        d = SH.place(x, r.sharding(("batch", "embed"), x.shape))
        y = r.constrain(d, "batch", "embed")
        assert tuple(y.placements) == (SH.Replicate(), SH.Replicate())
        assert torch.equal(y.full_tensor(), x)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ the port's placements
def test_placements_follow_the_spec():
    _, r = both_rules("2x16x16")
    S, R = SH.Shard, SH.Replicate
    # a dim split over two axes is Shard on each, in mesh order
    assert r.placements(("batch", None), (256, 8)) == (S(0), S(0), R())
    assert r.placements(("embed", "ffn"), (1024, 4096)) == (R(), S(0), S(1))
    assert r.placements((None, None), (3, 5)) == (R(), R(), R())


def test_placements_refuse_an_order_dtensor_cannot_split():
    """JAX splits a dim in the order its spec lists the axes, DTensor in
    mesh order: an override listing them out of mesh order raises rather
    than placing the tensor another way."""
    _, r = both_rules("16x16", {"batch": ("model", "data")})
    assert r.spec(("batch", None), (256, 8)) == (("model", "data"), None)
    with pytest.raises(ValueError, match="mesh-dim order"):
        r.placements(("batch", None), (256, 8))


def test_tree_shardings_and_leaves_pair_with_flatten_order():
    _, r = both_rules("2x4")
    axes = T_CM.get_axes("conv1d")(COSTMODEL_SMALL)
    params = T_CM.conv_init(COSTMODEL_SMALL,
                            generator=torch.Generator().manual_seed(0))
    sh = SH.tree_shardings(r, axes, params)
    leaves = SH.sharding_leaves(sh)
    flat = tree_flatten_with_paths(params)
    assert len(leaves) == len(flat)
    for (path, leaf), (_, pl) in zip(flat, leaves):
        want = r.placements(_shape_at(axes, path), leaf.shape)
        assert pl == want, path


def test_constrain_refuses_a_plain_tensor_on_a_larger_mesh():
    """On four (fake) ranks a plain tensor's layout is unknown: raise."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_debug_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        r = SH.ShardingRules(make_debug_mesh(2, 2))
        with pytest.raises(TypeError, match="plain tensor"):
            r.constrain(torch.ones((4, 8)), "batch", None)
        with pytest.raises(ValueError, match="has 8 places but the "
                                             "process group has 4 ranks"):
            make_debug_mesh(2, 4)
    finally:
        dist.destroy_process_group()


def test_mesh_module_touches_no_group_on_import():
    import importlib

    import torch.distributed as dist
    import repro_torch.launch.mesh as M
    importlib.reload(M)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none is initialised"):
        M.make_production_mesh()
