"""The port's cost walker and roofline (``repro_torch.launch.hlo_cost``,
``repro_torch.launch.roofline``) against the reference's.

* ``analyze_traced`` (aten ops of a PyTorch function on ``meta``
  tensors) against the reference's ``analyze_hlo`` (XLA's compiled text
  of the same program), on ``tests/test_hlo_cost.py``'s programs: flops
  within 1%, HBM bytes within that test's 20% (measured: equal on all
  five);
* the copied ``analyze_hlo`` and ``collective_bytes`` on JAX-compiled
  text give the reference's totals exactly;
* the roofline's model flops and report equal the reference's, with the
  H100 constants in place of the reference's;
* ``analyze_traced`` through DTensors on a fake process group counts
  each rank's own ops and DTensor's collectives, and none of the
  sharding propagator's; its peak of live bytes counts no view, and a
  train step's does not grow by a layer's whole gradient a layer;
* a reduced LM train step traced by the port against the reference's
  compiled step."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as r_arch
from repro.launch import hlo_cost as R_HC
from repro.launch import roofline as R_RL
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs import get_arch as t_arch
from repro_torch.launch import hlo_cost as T_HC
from repro_torch.launch import roofline as T_RL

FLOPS_RTOL = 0.01
HBM_RTOL = 0.2


def _text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _scan(a, ws):
    return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), a, ws)[0]


def _scan_t(a, ws):
    for w in ws.unbind(0):
        a = torch.tanh(a @ w)
    return a


def _nested(a, ws):
    def outer(h, wg):
        return jax.lax.scan(lambda hh, w: (hh @ w, None), h, wg)[0], None
    return jax.lax.scan(outer, a, ws)[0]


def _nested_t(a, ws):
    for wg in ws.unbind(0):
        for w in wg.unbind(0):
            a = a @ w
    return a


def _conv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


# (name, reference fn, its inputs, port fn, its meta input shapes)
PROGRAMS = [
    ("matmul", lambda a, b: a @ b, ((128, 256), (256, 64)),
     lambda a, b: a @ b, ((128, 256), (256, 64))),
    ("scan8", _scan, ((64, 64), (8, 64, 64)), _scan_t,
     ((64, 64), (8, 64, 64))),
    ("nested_scan", _nested, ((32, 32), (4, 3, 32, 32)), _nested_t,
     ((32, 32), (4, 3, 32, 32))),
    ("elementwise", lambda x: jnp.tanh(x) * 2 + 1, ((1024, 1024),),
     lambda x: torch.tanh(x) * 2 + 1, ((1024, 1024),)),
    ("conv", _conv, ((1, 16, 16, 8), (3, 3, 8, 4)),
     lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
     ((1, 8, 16, 16), (4, 8, 3, 3))),
]


@pytest.mark.parametrize("prog", PROGRAMS, ids=[p[0] for p in PROGRAMS])
def test_traced_totals_match_the_walker(prog):
    name, rfn, rshapes, tfn, tshapes = prog
    text = _text(rfn, *[jnp.ones(s) for s in rshapes])
    ref = R_HC.analyze_hlo(text)
    got = T_HC.analyze_traced(tfn, *[_meta(*s) for s in tshapes])
    assert got.flops == pytest.approx(ref.flops, rel=FLOPS_RTOL)
    assert got.contraction_flops == pytest.approx(ref.contraction_flops,
                                                  rel=FLOPS_RTOL)
    assert got.hbm_bytes == pytest.approx(ref.hbm_bytes, rel=HBM_RTOL,
                                          abs=1.0)
    # the copied walker reads the same text to the same totals
    assert dataclasses.asdict(T_HC.analyze_hlo(text)) == \
        dataclasses.asdict(ref)


def test_copied_collective_parsers_equal_reference():
    hlo = """
ENTRY %main (p0: f32[64,64]) -> f32[64,64] {
  %p0 = f32[64,64]{1,0} parameter(0)
  %ar = f32[64,64]{1,0} all-reduce(%p0), replica_groups={}, to_apply=%add
  %rs = f32[16,64]{1,0} reduce-scatter(%ar), dimensions={0}
  ROOT %ag = f32[128,64]{1,0} all-gather(%ar), dimensions={0}
}
"""
    assert T_RL.collective_bytes(hlo) == R_RL.collective_bytes(hlo)
    assert T_RL.collective_bytes(hlo)["all-reduce"] == 2 * 64 * 64 * 4
    assert dataclasses.asdict(T_HC.analyze_hlo(hlo)) == \
        dataclasses.asdict(R_HC.analyze_hlo(hlo))


def test_roofline_holds_h100_constants():
    """Data-sheet figures of an H100 SXM5 80GB at 700 W, each named so
    in its comment; none of the reference's."""
    assert (T_RL.PEAK_FLOPS, T_RL.HBM_BW, T_RL.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    import inspect
    src = inspect.getsource(T_RL)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        line = next(ln for ln in src.splitlines()
                    if ln.startswith(name + " ="))
        assert "H100" in line and "700 W" in line, line
    assert "197e12" not in src and "819e9" not in src


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_model_flops_and_report_equal_reference(name):
    for shape in SHAPES.values():
        got = T_RL.model_flops_for(t_arch(name), shape)
        want = R_RL.model_flops_for(r_arch(name), shape)
        assert got == want
    kw = dict(arch=name, shape="train_4k", mesh="pod16x16", chips=256,
              flops_per_chip=3.1e13, bytes_per_chip=2.0e11,
              coll_bytes_per_chip=7.0e9, coll_breakdown={"all-gather": 7e9},
              peak_memory_per_chip=1e10, model_flops=4.0e15)
    t, r = T_RL.RooflineReport(**kw), R_RL.RooflineReport(**kw)
    assert set(t.to_dict()) == set(r.to_dict())
    assert t.t_compute == pytest.approx(3.1e13 / 989e12)
    assert t.t_memory == pytest.approx(2.0e11 / 3.35e12)
    assert t.t_collective == pytest.approx(7.0e9 / 450e9)
    assert t.useful_flops_ratio == r.useful_flops_ratio


def test_traced_dtensor_counts_each_ranks_ops_and_collectives():
    """A (64, 32) @ (32, 16) product on a fake (2, 2) mesh, the left
    operand sharded on rows over both axes, the right whole: each rank
    multiplies its 16 rows (1/4 of the flops), and gathering the result
    to every rank is one all-gather of the whole (64, 16) a mesh dim."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import sharding as SH
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        rules = SH.ShardingRules(make_debug_mesh(2, 2))
        a = SH.place(_meta(64, 32), rules.sharding(("batch", None), (64, 32)))
        b = SH.place(_meta(32, 16), rules.sharding((None, None), (32, 16)))
        assert a.to_local().shape == (16, 32)

        def f(a, b):
            return (a @ b).full_tensor()
        got = T_HC.analyze_traced(f, a, b)
        assert got.flops == 2 * 16 * 32 * 16
        assert got.op_counts["mm"] == 1
        assert got.coll["all-gather"] == (32 * 16 + 64 * 16) * 4
        assert got.coll["all-reduce"] == 0
    finally:
        dist.destroy_process_group()


def test_traced_peak_counts_new_buffers_only():
    """The peak of live bytes counts each op result that owns a new
    buffer: of a product and six views of it, the product's alone."""
    def f(x):
        y = x * 2
        y.view(-1)[::2].unsqueeze(0).permute(1, 0)
        y.unbind(0)
        return y.t()
    got = T_HC.analyze_traced(f, _meta(16, 32))
    assert got.op_counts["unbind"] == 1
    assert got.peak_live_bytes == 16 * 32 * 4


def test_traced_dtensor_leaves_out_the_sharding_propagator():
    """softplus and its gradient on a (64, 32) DTensor split four ways
    on a fake (2, 2) mesh total as the same function on one rank's
    (16, 32) shard. (torch 2.13's DTensor finds softplus_backward's
    placement by running its decomposition on meta tensors of the
    global shape; no rank runs those ops.)"""
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import sharding as SH

    def f(x):
        x = x.detach().requires_grad_()
        y = F.softplus(x)
        return torch.autograd.grad(y, x, torch.ones_like(y))[0]
    one = T_HC.analyze_traced(f, _meta(16, 32))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        rules = SH.ShardingRules(make_debug_mesh(2, 2))
        x = SH.place(_meta(64, 32), rules.sharding(("batch", None), (64, 32)))
        got = T_HC.analyze_traced(f, x)
    finally:
        dist.destroy_process_group()
    assert got.op_counts == one.op_counts
    assert got.flops == one.flops > 0
    assert got.peak_live_bytes == one.peak_live_bytes


def test_traced_backward_reduces_each_layers_gradient():
    """A reduced qwen3's loss and gradients with rules on a fake (2, 2)
    mesh, at 2 and at 4 layers of a wide FFN: the peak of live bytes a
    rank grows by less than one layer's whole float32 FFN gradient over
    the two layers added (each layer's gradient is reduced to its
    shards as its backward gives it, not held whole to the end)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as TMODEL
    from repro_torch.models import steps as TSTEPS
    from repro_torch.params import tree_flatten, tree_unflatten
    from repro_torch.runtime import sharding as SH

    def peak(rules, n_layers):
        cfg = dataclasses.replace(t_arch("qwen3-0.6b").reduced(),
                                  n_layers=n_layers, d_ff=4096)
        params = TSTEPS.abstract_params(cfg)
        params = SH.place_tree(params, SH.tree_shardings(
            rules, TMODEL.param_axes(cfg), params))
        batch = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
        loss_fn = TSTEPS.make_loss_fn(cfg, rules=rules)

        def grads(params, batch):
            with SH.step_scope(rules):
                live = [p.detach().requires_grad_()
                        for p in tree_flatten(params)]
                loss, _ = loss_fn(tree_unflatten(params, live),
                                  SH.place_batch(rules, batch))
                return torch.autograd.grad(loss, live)
        return T_HC.analyze_traced(grads, params, batch).peak_live_bytes
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        rules = SH.ShardingRules(make_debug_mesh(2, 2))
        grown = peak(rules, 4) - peak(rules, 2)
    finally:
        dist.destroy_process_group()
    layer_grad = 3 * 64 * 4096 * 4          # the FFN's three matrices
    assert grown < layer_grad, grown


def test_traced_lm_train_step_matches_the_compiled_reference():
    """qwen3-0.6b reduced, one train step at B=2, S=512: the port's
    traced totals against the reference's compiled step walked by
    ``analyze_hlo``, flops and contraction flops within 5% (measured
    +1.5% and +1.9%: the port also recomputes each loss chunk's logits
    in the backward), HBM bytes within 20% (+2.0%). Over
    ``model_flops_for`` both give ~2.5: the reference's own step (remat,
    a masked attention over every key block) is as far above a
    causal-half count as the port's, which is why the dry run's train
    ratio is bounded by 2.0 and not 1.5 (tests/test_torch_dryrun.py)."""
    from repro.models import steps as RSTEPS
    from repro.optim import adamw as R_ADAMW
    from repro_torch.models import steps as TSTEPS
    from repro_torch.optim import adamw as T_ADAMW
    B, S = 2, 512
    rcfg, tcfg = r_arch("qwen3-0.6b").reduced(), \
        t_arch("qwen3-0.6b").reduced()
    rparams = RSTEPS.abstract_params(rcfg)
    rbatch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
              for k in ("tokens", "labels")}
    step = RSTEPS.make_train_step(rcfg, R_ADAMW.AdamWConfig())
    ref = R_HC.analyze_hlo(_text(step, rparams,
                                 RSTEPS.abstract_opt_state(rparams), rbatch))
    tparams = TSTEPS.abstract_params(tcfg)
    tbatch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
              for k in ("tokens", "labels")}
    got = T_HC.analyze_traced(
        TSTEPS.make_train_step(tcfg, T_ADAMW.AdamWConfig()), tparams,
        TSTEPS.abstract_opt_state(tparams), tbatch)
    assert got.flops == pytest.approx(ref.flops, rel=0.05)
    assert got.contraction_flops == pytest.approx(ref.contraction_flops,
                                                  rel=0.05)
    assert got.hbm_bytes == pytest.approx(ref.hbm_bytes, rel=HBM_RTOL)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S,
                                global_batch=B)
    model = R_RL.model_flops_for(rcfg, shape)
    assert model == T_RL.model_flops_for(tcfg, shape)
    assert ref.flops / model > 1.5 and got.flops / model > 1.5
