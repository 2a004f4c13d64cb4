"""The port's dry run (``repro_torch.launch.dryrun.run_cell``) on a fake
(2, 4) debug mesh, in a child process (its fake group of 8 ranks is the
child's default group): the full configs of qwen3-0.6b at ``train_4k``
and ``decode_32k`` and of phi3.5-moe-42b-a6.6b at ``decode_32k`` (its
``train_4k`` cell alone traces for ~20 s, so the MoE arch runs its
decode cell only).

Each cell is held to:

* status ``ok`` and the reference's record keys, ``compile_s`` null;
* the argument bytes a rank equal to the sum over leaves of the shard
  bytes that the reference's specs on the same mesh shape imply;
* the collectives that FSDP and data parallelism imply: all-gathers of
  the FSDP-sharded weights, and in training reduce-scatters of their
  gradients and all-reduces of the replicated ones;
* for qwen3-0.6b's cells, the argument and temporary bytes a rank
  within an H100's 80 GB;
* for ``train_4k`` a flops ratio (flops a rank over model flops a rank)
  in [1.0, 2.0]. ``model_flops_for`` counts causal attention at half of
  its S^2 products and the forward once; the step recomputes each
  layer's forward (remat, x4/3 of the train flops) and its flash
  attention computes every key block under a mask, as the reference's
  does, so attention costs twice the model's count: 1.96 for
  qwen3-0.6b at 4k (the [1.0, 1.5] a causal-skipping attention would
  give does not apply to this algorithm; the reference's own compiled
  step is as far above it, tests/test_torch_hlo_cost.py)."""
import multiprocessing
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_arch as r_arch
from repro.launch import roofline as R_RL
from repro.models import model as RMODEL
from repro.models import steps as RSTEPS
from repro.runtime import sharding as R_SH

CELLS = (("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "decode_32k"),
         ("phi3.5-moe-42b-a6.6b", "decode_32k"))
# an H100 80GB's memory: qwen3-0.6b's cells fit it a rank on the (2, 4)
# mesh (measured 49.9 GB at train_4k, 62.9 GB at decode_32k); phi3.5-moe's
# arguments alone take 110.6 GB a rank on 8 ranks
CARD_BYTES = 80e9
FITS_A_CARD = CELLS[:2]
MESH = ((2, 4), ("data", "model"))
RATIO = (1.0, 2.0)


def _cells(out):
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    torch.set_num_threads(1)
    D.init_fake_group(8)
    mesh = make_debug_mesh(*MESH[0])
    recs = [D.run_cell(a, s, mesh=mesh, verbose=False) for a, s in CELLS]
    with open(out, "wb") as f:
        pickle.dump(recs, f)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "recs.pkl")
    p = multiprocessing.get_context("spawn").Process(target=_cells,
                                                     args=(out,))
    p.start()
    p.join(600)
    assert p.exitcode == 0
    with open(out, "rb") as f:
        return dict(zip(CELLS, pickle.load(f)))


class _FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _reference_rules(overrides):
    r = R_SH.ShardingRules.__new__(R_SH.ShardingRules)
    r.mesh = _FakeMesh(*MESH)
    r.rules = dict(R_SH.DEFAULT_RULES)
    for k, v in overrides.items():
        r.rules[k] = () if v is None else (v,) if isinstance(v, str) \
            else tuple(v)
    r.axis_sizes = dict(zip(MESH[1], MESH[0]))
    return r


def _shard_bytes(rules, axes_tree, abstract):
    """Sum over leaves of numel / (mesh axes the reference's spec uses)
    x itemsize."""
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    total = []

    def one(axes, leaf):
        n = int(np.prod(leaf.shape, dtype=np.int64)) * \
            np.dtype(leaf.dtype).itemsize
        for part in rules.spec(axes, leaf.shape):
            for a in ((part,) if isinstance(part, str) else part or ()):
                n //= rules.axis_sizes[a]
        total.append(n)
    jax.tree.map(one, axes_tree, abstract, is_leaf=is_axes)
    return sum(total)


def _reference_argument_bytes(arch, shape_name):
    cfg, shape = r_arch(arch), R_SHAPES[shape_name]
    rules = _reference_rules({} if shape.kind == "train" else
                             {"embed": None})
    paxes = RMODEL.param_axes(cfg)
    params = RSTEPS.abstract_params(cfg)
    n = _shard_bytes(rules, paxes, params)
    specs = RSTEPS.input_specs(cfg, shape)
    if shape.kind == "train":
        n += _shard_bytes(rules, RSTEPS.opt_state_axes(paxes),
                          RSTEPS.abstract_opt_state(params))
    else:
        specs = {"tokens": specs["tokens"]}
        n += _shard_bytes(rules, RMODEL.cache_axes(cfg), RSTEPS.abstract_cache(
            cfg, shape.global_batch, shape.seq_len))
    for v in specs.values():
        n += _shard_bytes(rules, ("batch",) + (None,) * (len(v.shape) - 1),
                          v)
    return n


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c) for c in CELLS])
def test_cell_record(cell, records):
    rec = records[cell]
    arch, shape = cell
    assert rec["status"] == "ok", rec
    for key in ("lower_s", "compile_s", "memory", "cost", "roofline"):
        assert key in rec
    assert rec["compile_s"] is None and rec["chips"] == 8
    assert rec["memory"]["argument_size_in_bytes"] == \
        _reference_argument_bytes(arch, shape)
    assert rec["memory"]["temp_size_in_bytes"] > 0
    if cell in FITS_A_CARD:
        # a tensor left whole on every rank (the global batch, say)
        # would not fit
        assert sum(rec["memory"].values()) <= CARD_BYTES, rec["memory"]
    rl = rec["roofline"]
    assert rl["model_flops"] == R_RL.model_flops_for(r_arch(arch),
                                                     R_SHAPES[shape])
    coll = rl["coll_breakdown"]
    assert coll["all-gather"] > 0
    if R_SHAPES[shape].kind == "train":
        assert coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
        ratio = rl["flops_per_chip"] / (rl["model_flops"] / rl["chips"])
        assert RATIO[0] <= ratio <= RATIO[1], ratio
    for t in ("t_compute", "t_memory", "t_collective"):
        assert rl[t] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
