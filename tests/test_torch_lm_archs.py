"""The ten registered architectures, reduced, through the port's models
against the reference's on the same numpy params: forward logits and
aux loss, 4 greedy decode steps and their caches (one train step:
``test_torch_lm_train.py``, on another test worker); the
port's own init (shapes, dtypes, scales), its meta-device shape helpers
and axes, the analytic param counts (F2: the xlstm config's count needs
``models/xlstm``), LM checkpoints across the two packages, and mirrors
of the reference's ``tests/test_archs.py`` and
``tests/test_consistency.py`` on the port alone.

The parity checks run both packages at ``cdt=float32``: the step
builders take no compute dtype, so ``forward`` and ``decode_forward``
are bound to float32 in each package's module for their duration."""
import contextlib
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import ckpt as R_CKPT
from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_arch as r_arch
from repro.models import model as RMODEL
from repro.models import steps as RSTEPS
from repro_torch import params as P
from repro_torch.checkpoint import ckpt as T_CKPT
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs import get_arch as t_arch
from repro_torch.models import model as TMODEL
from repro_torch.models import moe as TMOE
from repro_torch.models import steps as TSTEPS
from repro_torch.optim import adamw as T_ADAMW

B, S = 2, 16
NAMES = sorted(ARCHS)
# float32 in two packages: logits and aux relative to their largest
# value (measured <= 1.2e-6); params after one step and decode caches
# relative to the tree's largest value (measured <= 1.8e-6 / 1.4e-6)
LOGITS_RTOL = 1e-4
STATE_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: beside the other test workers a pool as wide
    as the machine oversubscribes its cores (this file took 2-5x longer
    under the six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_np(cfg, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.frontend == "vision":
        b["patch_embeds"] = (rng.normal(
            size=(B, cfg.vision_patches, cfg.d_model)) * 0.02
        ).astype(np.float32)
    if cfg.frontend == "audio":
        b["frame_embeds"] = (rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)) * 0.02
        ).astype(np.float32)
    return b


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b, dtype=None):
    out = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    if dtype is not None:
        out = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in out.items()}
    return out


def tree_rel(ref, got) -> float:
    """Largest leaf difference over the tree's largest reference value."""
    ref = dict(P.tree_flatten_with_paths(jax.tree.map(np.asarray, ref)))
    got = dict(P.tree_flatten_with_paths(P.to_numpy(got)))
    assert sorted(ref) == sorted(got)
    top = max(np.abs(a.astype(np.float32)).max() for a in ref.values())
    return max(float(np.abs(ref[k].astype(np.float32) - got[k]).max())
               for k in ref) / top


@pytest.fixture(scope="module")
def world():
    """(reference config, port config, reference params as numpy) of a
    reduced arch, each made once."""
    cache = {}

    def get(name):
        if name not in cache:
            rcfg = r_arch(name).reduced()
            tree = jax.tree.map(np.asarray, RMODEL.init_params(
                jax.random.PRNGKey(0), rcfg))
            cache[name] = (rcfg, t_arch(name).reduced(), tree)
        return cache[name]
    return get


@contextlib.contextmanager
def float32_steps():
    """forward and decode_forward at cdt=float32 in both packages, for
    the step builders, which call them through their modules."""
    with contextlib.ExitStack() as stack:
        for mod, dt in ((RMODEL, jnp.float32), (TMODEL, torch.float32)):
            for fn in ("forward", "decode_forward"):
                stack.enter_context(mock.patch.object(
                    mod, fn, functools.partial(getattr(mod, fn), cdt=dt)))
        yield


# ------------------------------------------------- parity with the reference
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name, world):
    rcfg, tcfg, tree = world(name)
    b = batch_np(rcfg)
    ref, raux = jax.jit(lambda p, bb: RMODEL.forward(
        p, rcfg, bb, cdt=jnp.float32))(tree, jbatch(b))
    got, taux = TMODEL.forward(P.lm_from_numpy(tree, tcfg, "cpu"), tcfg,
                               tbatch(b), cdt=torch.float32)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= LOGITS_RTOL * np.abs(ref).max()
    np.testing.assert_allclose(float(taux), float(raux), rtol=LOGITS_RTOL,
                               atol=1e-7)


def fill_encoder(cfg, params, cache, b, mod, dt, batch):
    """whisper: the decode cache holds the encoder's output."""
    if cfg.family == "audio":
        enc = mod._run_encoder(params, cfg, batch(b)["frame_embeds"], None,
                               dt)
        cache["enc_out"] = enc.astype(cache["enc_out"].dtype) \
            if mod is RMODEL else enc.to(cache["enc_out"].dtype)
    return cache


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_reference(name, world):
    """4 greedy steps through each package's make_decode_step at float32
    (KV caches float32): the same tokens at every step, and the caches
    after the last within STATE_RTOL."""
    rcfg, tcfg, tree = world(name)
    b = batch_np(rcfg, labels=False)
    tp = P.lm_from_numpy(tree, tcfg, "cpu")
    rc = fill_encoder(rcfg, tree, RMODEL.init_cache(
        rcfg, B, 8, kv_dtype=jnp.float32), b, RMODEL, jnp.float32, jbatch)
    tc = fill_encoder(tcfg, tp, TMODEL.init_cache(
        tcfg, B, 8, kv_dtype=torch.float32), b, TMODEL, torch.float32, tbatch)
    rtok = jnp.asarray(b["tokens"][:, :1])
    ttok = torch.from_numpy(b["tokens"][:, :1].copy())
    with float32_steps():
        rstep = jax.jit(RSTEPS.make_decode_step(rcfg))
        tstep = TSTEPS.make_decode_step(tcfg)
        for i in range(4):
            rtok, rc = rstep(tree, rc, rtok, jnp.int32(i))
            ttok, tc = tstep(tp, tc, ttok, i)
            assert ttok.dtype == torch.int32 and ttok.shape == (B, 1)
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(rtok))
    assert tree_rel(rc, tc) <= STATE_RTOL


# ----------------------------------------------------- F2: the param counts
@pytest.mark.parametrize("name", NAMES)
def test_param_counts_equal_reference(name):
    """Every full config's analytic counts; the xlstm one builds its
    blocks' shapes on the meta device (it raised ModuleNotFoundError
    before models/xlstm.py was ported)."""
    assert t_arch(name).param_count() == r_arch(name).param_count()
    assert t_arch(name).active_param_count() == \
        r_arch(name).active_param_count()


# --------------------------------------- init, shapes and axes, checkpoints
def leaf_shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in P.tree_flatten_with_paths(tree)}


@pytest.mark.parametrize("name", NAMES)
def test_port_init_shapes_dtypes_and_scales(name, world):
    """The port's own init draws other bits than the reference's, so it
    is held to the reference's tree, shapes, dtypes and constants, and to
    each random leaf's scale (its standard deviation within 20%)."""
    rcfg, tcfg, tree = world(name)
    got = TMODEL.init_params(torch.Generator().manual_seed(0), tcfg)
    assert leaf_shapes(got) == leaf_shapes(tree)
    ref = dict(P.tree_flatten_with_paths(tree))
    for path, leaf in P.tree_flatten_with_paths(got):
        r, g = ref[path], leaf.numpy()
        if r.std() == 0:
            np.testing.assert_array_equal(g, r, err_msg=path)
        elif r.size >= 64 and not path.endswith("dt_bias"):
            assert 0.8 <= g.std() / r.std() <= 1.25, path
            assert abs(g.mean() - r.mean()) <= 0.2 * r.std(), path
        elif path.endswith("dt_bias"):   # log(expm1(U(1e-3, 1e-1)))
            assert -7.0 < g.min() and g.max() < -2.2, path


@pytest.mark.parametrize("name", NAMES)
def test_abstract_shapes_and_axes_equal_reference(name):
    """On the full config: the meta-device params, optimizer state, cache
    and input stand-ins have the reference's shapes and dtypes, and the
    logical axes are the reference's (M9b's sharding reads them)."""
    rcfg, tcfg = r_arch(name), t_arch(name)
    abs_p = TSTEPS.abstract_params(tcfg)
    assert all(t.device.type == "meta" for t in P.tree_flatten(abs_p))
    assert leaf_shapes(abs_p) == leaf_shapes(RSTEPS.abstract_params(rcfg))
    assert TMODEL.param_axes(tcfg) == RMODEL.param_axes(rcfg)
    assert TMODEL.cache_axes(tcfg) == RMODEL.cache_axes(rcfg)
    assert TSTEPS.opt_state_axes(TMODEL.param_axes(tcfg)) == \
        RSTEPS.opt_state_axes(RMODEL.param_axes(rcfg))
    cache = TSTEPS.abstract_cache(tcfg, 4, 64)
    assert leaf_shapes(cache) == leaf_shapes(RSTEPS.abstract_cache(
        rcfg, 4, 64))
    opt = TSTEPS.abstract_opt_state(abs_p)
    assert leaf_shapes(opt["m"]) == leaf_shapes(abs_p)
    for shape in SHAPES.values():
        assert leaf_shapes(TSTEPS.input_specs(tcfg, shape)) == \
            leaf_shapes(RSTEPS.input_specs(rcfg, shape))


@pytest.mark.parametrize("name", ["qwen3-0.6b", "jamba-v0.1-52b",
                                  "whisper-small"])
def test_lm_checkpoint_restores_across_packages(name, world, tmp_path):
    """A port LM checkpoint restores in the reference and the other way
    round, leaf for leaf, through either package's ckpt."""
    rcfg, tcfg, tree = world(name)
    tp = TMODEL.init_params(torch.Generator().manual_seed(1), tcfg)
    T_CKPT.save(str(tmp_path / "t"), 3, tp)
    back, step, _ = R_CKPT.restore(str(tmp_path / "t"), tree)
    assert step == 3 and tree_rel(back, tp) == 0.0
    R_CKPT.save(str(tmp_path / "r"), 5, tree)
    like = P.lm_from_numpy(P.to_numpy(tp), tcfg, "cpu")
    got, step, _ = T_CKPT.restore(str(tmp_path / "r"), like)
    assert step == 5 and tree_rel(tree, got) == 0.0


def test_lm_from_numpy_refuses_another_tree(world):
    _, tcfg, tree = world("qwen3-0.6b")
    _, _, other = world("qwen1.5-32b")        # qkv biases, untied
    with pytest.raises(ValueError, match="missing.*unexpected"):
        P.lm_from_numpy(other, tcfg, "cpu")
    short = jax.tree.map(lambda a: a, tree)
    short["final_norm"] = short["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        P.lm_from_numpy(short, tcfg, "cpu")
    p = P.lm_from_numpy(tree, tcfg, "cpu", torch.bfloat16)
    assert p["embed"]["table"].dtype == torch.bfloat16


# ------------------------------------ tests/test_archs.py on the port alone
@pytest.fixture(scope="module")
def port_state():
    cache = {}

    def get(name):
        if name not in cache:
            cfg = t_arch(name).reduced()
            cache[name] = (cfg, TMODEL.init_params(
                torch.Generator().manual_seed(0), cfg))
        return cache[name]
    return get


def port_batch(cfg, labels=True):
    return tbatch(batch_np(cfg, labels=labels), torch.bfloat16)


@pytest.mark.parametrize("name", NAMES)
def test_port_forward_shapes_and_finite(name, port_state):
    cfg, params = port_state(name)
    logits, aux = TMODEL.forward(params, cfg, port_batch(cfg))
    assert logits.shape == (B, S, TMODEL.padded_vocab(cfg))
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(aux))


@pytest.mark.parametrize("name", NAMES)
def test_port_train_step_decreases_loss_and_finite(name, port_state):
    cfg, params = port_state(name)
    opt_cfg = T_ADAMW.AdamWConfig(lr=1e-3, total_steps=5, warmup_steps=0)
    step = TSTEPS.make_train_step(cfg, opt_cfg)
    state = T_ADAMW.init_state(params)
    batch = port_batch(cfg)
    p, state, m1 = step(params, state, batch)
    p, state, m2 = step(p, state, batch)
    p, state, m3 = step(p, state, batch)
    assert np.isfinite(float(m1["loss"]))
    assert float(m3["loss"]) < float(m1["loss"])  # same batch: must improve
    for leaf in P.tree_flatten(p):
        assert bool(torch.isfinite(leaf.float()).all())


@pytest.mark.parametrize("name", NAMES)
def test_port_decode_step_runs_and_is_finite(name, port_state):
    cfg, params = port_state(name)
    cache = TMODEL.init_cache(cfg, B, 32)
    step = TSTEPS.make_decode_step(cfg)
    tok = torch.ones((B, 1), dtype=torch.int32)
    for i in range(3):
        tok, cache = step(params, cache, tok, i)
    assert tok.shape == (B, 1)
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab
    for leaf in P.tree_flatten(cache):
        assert bool(torch.isfinite(leaf.float()).all())


def dropless(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


@pytest.mark.parametrize("name", ["qwen3-0.6b", "starcoder2-3b",
                                  "granite-moe-1b-a400m"])
def test_port_prefill_decode_consistency(name, world):
    """Greedy next token from prefill logits == decode path next token
    (MoE: dropless, as capacity dropping depends on the chunk size), in
    bf16, on the reference test's own params: the two paths round in
    other places, so a near-tie can go either way (the port's own init
    gives starcoder2 two logits 2 bf16 ulps apart, which the paths
    order differently). The card's full-width check compares float32
    logits and counts the ties."""
    _, cfg, tree = world(name)
    cfg = dropless(cfg)
    params = P.lm_from_numpy(tree, cfg, "cpu")
    batch = port_batch(cfg, labels=False)
    want = TSTEPS.next_token(TSTEPS.make_prefill_step(cfg)(params, batch),
                             cfg.vocab)
    cache = TMODEL.init_cache(cfg, B, S + 4, kv_dtype=torch.float32)
    step = TSTEPS.make_decode_step(cfg)
    toks = batch["tokens"]
    for i in range(S):
        tok, cache = step(params, cache, toks[:, i:i + 1], i)
    np.testing.assert_array_equal(tok.numpy(), want.numpy())


def test_port_param_counts_match_init():
    """Analytic param_count ~= actual init sizes (within vocab padding)."""
    for name in ["qwen3-0.6b", "qwen3-1.7b", "starcoder2-3b"]:
        cfg = t_arch(name)
        actual = sum(t.numel() for t in P.tree_flatten(
            TSTEPS.abstract_params(cfg)))
        expected = cfg.param_count()
        assert abs(actual - expected) / expected < 0.02, \
            f"{name}: init {actual} vs analytic {expected}"


def test_port_full_configs_are_exact():
    assert sorted(ARCHS) == sorted(R_ARCHS)
    q = t_arch("qwen1.5-32b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.d_ff,
            q.vocab) == (64, 5120, 40, 40, 27392, 152064)
    assert q.qkv_bias
    assert t_arch("phi3.5-moe-42b-a6.6b").moe.n_experts == 16
    assert t_arch("granite-moe-1b-a400m").moe.top_k == 8
    j = t_arch("jamba-v0.1-52b")
    assert j.hybrid.period == 8 and j.moe.moe_every == 2
    assert t_arch("qwen3-0.6b").param_count() == 596_042_752


# ------------------------------ tests/test_consistency.py on the port alone
def test_port_fused_loss_equals_naive(port_state):
    cfg, params = port_state("qwen3-0.6b")
    rng = np.random.default_rng(0)
    batch = port_batch(cfg, labels=False)
    labels = torch.from_numpy(rng.integers(-1, cfg.vocab, (B, S)))
    logits, _ = TMODEL.forward(params, cfg, batch, cdt=torch.float32)
    naive = TSTEPS.cross_entropy_loss(logits, labels, cfg.vocab)
    h, _ = TMODEL.forward(params, cfg, batch, cdt=torch.float32,
                          unembed=False)
    fused = TSTEPS.fused_unembed_loss(
        h, TMODEL.unembed_table(params, cfg), labels, cfg.vocab, chunk=5)
    np.testing.assert_allclose(float(fused), float(naive), rtol=1e-5)


def decode_all(params, cfg, batch, cache):
    outs = []
    toks = batch["tokens"]
    for i in range(S):
        lg, cache = TMODEL.decode_forward(params, cfg, toks[:, i:i + 1],
                                          cache, i, cdt=torch.float32)
        outs.append(lg)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("name", ["xlstm-125m", "jamba-v0.1-52b"])
def test_port_recurrent_decode_matches_parallel(name):
    """Chunkwise/scan training formulations vs O(1) decode (dropless)."""
    cfg = dropless(t_arch(name).reduced())
    params = TMODEL.init_params(torch.Generator().manual_seed(1), cfg)
    batch = tbatch(batch_np(cfg, 1, labels=False))
    par, _ = TMODEL.forward(params, cfg, batch, cdt=torch.float32,
                            remat=False)
    dec = decode_all(params, cfg, batch, TMODEL.init_cache(
        cfg, B, S, kv_dtype=torch.float32))
    np.testing.assert_allclose(dec.numpy(), par.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_port_whisper_decode_matches_forward():
    cfg = t_arch("whisper-small").reduced()
    params = TMODEL.init_params(torch.Generator().manual_seed(2), cfg)
    batch = tbatch(batch_np(cfg, 2, labels=False))
    par, _ = TMODEL.forward(params, cfg, batch, cdt=torch.float32,
                            remat=False)
    cache = TMODEL.init_cache(cfg, B, S, kv_dtype=torch.float32)
    cache["enc_out"] = TMODEL._run_encoder(
        params, cfg, batch["frame_embeds"], None, torch.float32)
    dec = decode_all(params, cfg, batch, cache)
    np.testing.assert_allclose(dec.numpy(), par.numpy(), rtol=5e-2,
                               atol=5e-2)


def moe_chunk_outputs(cfg, chunk_sizes, monkeypatch):
    params = TMODEL.init_params(torch.Generator().manual_seed(3), cfg)
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.from_numpy((np.random.default_rng(3).normal(
        size=(2, 12, cfg.d_model)) * 0.1).astype(np.float32))
    outs = []
    for c in chunk_sizes:
        monkeypatch.setattr(TMOE, "MOE_CHUNK", c)
        out, _ = TMOE.moe_apply(p, x, cfg, cdt=torch.float32)
        outs.append(out.numpy())
    return outs


def test_port_moe_chunking_invariance_dropless(monkeypatch):
    cfg = t_arch("granite-moe-1b-a400m").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    full, chunked = moe_chunk_outputs(cfg, [12, 4], monkeypatch)
    np.testing.assert_allclose(chunked, full, rtol=1e-5, atol=1e-6)


def test_port_moe_chunking_bounded_drop_disagreement(monkeypatch):
    cfg = t_arch("granite-moe-1b-a400m").reduced()
    full, chunked = moe_chunk_outputs(cfg, [12, 4], monkeypatch)
    tok_diff = np.abs(chunked - full).max(axis=-1)      # (B, S)
    assert (tok_diff > 1e-4).mean() <= 0.25
    assert float(tok_diff.max()) < 1.0
