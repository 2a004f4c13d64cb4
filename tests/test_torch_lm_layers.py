"""The port's LLM layers (``repro_torch.models.{layers,moe,mamba,xlstm,
steps}``) against the reference's on the same numpy inputs and params,
one function at a time: at ``cdt=float32`` within atol 1e-5, and at
bf16 within the limits stated below. Also the small helpers the
substrate brought along: the synthetic LM token stream (bit for bit)
and the grouped decode attention oracle."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_arch as r_arch
from repro.data import pipeline as R_PIPE
from repro.kernels import ref as R_REF
from repro.models import layers as RL
from repro.models import mamba as RMB
from repro.models import moe as RM
from repro.models import steps as RS
from repro.models import xlstm as RX
from repro_torch.configs import get_arch as t_arch
from repro_torch.data import pipeline as T_PIPE
from repro_torch.kernels import ref as T_REF
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB
from repro_torch.models import moe as TM
from repro_torch.models import steps as TS
from repro_torch.models import xlstm as TX
from repro_torch.params import from_numpy, tree_flatten

F32_ATOL = 1e-5
# bf16 limits, as the largest error over the largest reference value:
# one bf16 rounding is 2^-9 relative, and a layer chains several (the
# residual stream, each product's output, the norms), each rounded by
# both packages in their own order (measured 0 - 1.1e-2)
BF16_LAYER = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: beside the other test workers a pool as wide
    as the machine oversubscribes its cores (this file took 2-5x longer
    under the six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(a):
    """One numpy array as (jax array, torch tensor)."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def jit(fn, *args, **kw):
    """The reference's function compiled whole (eager JAX compiles op by
    op, several times slower here): arrays and dicts of them are traced,
    the config, the floats and ``kw`` are bound."""
    dyn = [i for i, a in enumerate(args) if isinstance(a, (jax.Array, dict))]

    def call(*traced):
        full = list(args)
        for i, a in zip(dyn, traced):
            full[i] = a
        return fn(*full, **kw)
    return jax.jit(call)(*[args[i] for i in dyn])


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


def assert_close(ref, got, dtype: str, limit: float = BF16_LAYER):
    if dtype == "float32":
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(ref, np.float32),
                                   rtol=0, atol=F32_ATOL)
    else:
        assert rel_err(ref, got) <= limit


def params_pair(init_fn, cfg, seed, noisy=()):
    """The reference's init as numpy, with the named leaves (zeros or
    ones at init: biases, norms) drawn from the seed so a dropped term
    shows; returns (jax tree, torch tree)."""
    tree = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for k in noisy:
        tree[k] = tree[k] + rng.normal(size=tree[k].shape) * 0.3
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return jax.tree.map(jnp.asarray, tree), from_numpy(tree, "cpu")


# ------------------------------------------------------------------ basics
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rms_norm(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x, g = rng.normal(size=(2, 5, 16)) * 3, rng.normal(size=(16,))
    (xj, xt), (gj, gt) = both(x), both(g)
    ref = jit(RL.rms_norm, xj.astype(jdt), gj, 1e-6)
    got = TL.rms_norm(xt.to(tdt), gt, 1e-6)
    assert got.dtype == tdt
    assert_close(ref, got.float(), dtype, 2 ** -7)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rope(dtype, theta):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16))
    pos = rng.integers(0, 5000, (2, 7))
    xj, xt = both(x)
    ref = jit(RL.rope, xj.astype(jdt), jnp.asarray(pos), theta)
    got = TL.rope(xt.to(tdt), torch.from_numpy(pos), theta)
    assert_close(ref, got.float(), dtype, 2 ** -7)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal,sq,q_offset", [
    (True, 37, 0), (True, 10, 27), (False, 37, 0), (False, 10, 0)])
def test_flash_attention(causal, sq, q_offset, dtype):
    """kblk 16 over 37 keys: two full blocks and a ragged one of 5; a
    prefill chunk of 10 queries at offset 27 sees every key up to its
    own position."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, sq, 4, 16)) * 2
    k, v = rng.normal(size=(2, 2, 37, 4, 16))
    (qj, qt), (kj, kt), (vj, vt) = both(q), both(k), both(v)
    ref = jit(RL.flash_attention, qj.astype(jdt), kj.astype(jdt),
              vj.astype(jdt), causal=causal, q_offset=q_offset, kblk=16)
    got = TL.flash_attention(qt.to(tdt), kt.to(tdt), vt.to(tdt),
                             causal=causal, q_offset=q_offset, kblk=16)
    assert got.dtype == tdt
    assert_close(ref, got.float(), dtype)
    if dtype == "float32":
        # PyTorch's own attention as an oracle (tests only)
        mask = None
        if causal:
            mask = (torch.arange(37)[None, :]
                    <= q_offset + torch.arange(sq)[:, None])
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
            attn_mask=mask).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), sdpa.numpy(), atol=F32_ATOL)


def attn_cfg(qk_norm, qkv_bias):
    base = dict(qk_norm=qk_norm, qkv_bias=qkv_bias)
    return (dataclasses.replace(r_arch("llava-next-34b").reduced(), **base),
            dataclasses.replace(t_arch("llava-next-34b").reduced(), **base))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("qk_norm,qkv_bias", [
    (False, False), (True, False), (False, True), (True, True)])
def test_attention_apply_train_and_decode(qk_norm, qkv_bias, dtype):
    """GQA (4 query heads on 2 KV heads): the full-sequence path, and one
    cache decode step at index 9 of a cache of 16 filled with noise
    (positions past the index must not count)."""
    jdt, tdt = DTYPES[dtype]
    rcfg, tcfg = attn_cfg(qk_norm, qkv_bias)
    noisy = [k for k in ("bq", "bk", "bv", "q_norm", "k_norm")
             if k in RL.attention_init(jax.random.PRNGKey(0), rcfg)]
    pj, pt = params_pair(RL.attention_init, rcfg, 3, noisy)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 64))
    xj, xt = both(x)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    ref, _ = jit(RL.attention_apply, pj, xj, rcfg,
                 positions=jnp.asarray(pos), cdt=jdt)
    got, _ = TL.attention_apply(pt, xt, tcfg, positions=torch.from_numpy(
        pos.copy()), cdt=tdt)
    assert_close(ref, got.float(), dtype)

    kv = rng.normal(size=(2, 2, 2, 16, 16))
    (kj, kt), (vj, vt) = both(kv[0]), both(kv[1])
    x1j, x1t = both(rng.normal(size=(2, 1, 64)))
    ref, rc = jit(
        RL.attention_apply, pj, x1j, rcfg, positions=jnp.full((2, 1), 9),
        cdt=jdt, cache={"k": kj, "v": vj}, cache_index=jnp.int32(9))
    got, tc = TL.attention_apply(
        pt, x1t, tcfg, positions=torch.full((2, 1), 9), cdt=tdt,
        cache={"k": kt, "v": vt}, cache_index=9)
    assert_close(ref, got.float(), dtype)
    for key in ("k", "v"):
        assert_close(rc[key], tc[key], dtype)


def test_decode_attention_ref_matches_reference():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 2, 3, 16))
    k, v = rng.normal(size=(2, 2, 2, 20, 16))
    (qj, qt), (kj, kt), (vj, vt) = both(q), both(k), both(v)
    for index in (0, 7, 19):
        np.testing.assert_allclose(
            T_REF.decode_attention_ref(qt, kt, vt, index).numpy(),
            np.asarray(R_REF.decode_attention_ref(qj, kj, vj, index)),
            atol=F32_ATOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("gated", [True, False])
def test_ffn_apply(gated, dtype):
    """Gated (SiLU) and non-gated (whisper's tanh GELU: erf would move
    the output by ~2e-4, far past the float32 limit)."""
    jdt, tdt = DTYPES[dtype]
    tree = jax.tree.map(np.asarray, RL.ffn_init(jax.random.PRNGKey(5), 64,
                                                128, gated=gated))
    pj, pt = jax.tree.map(jnp.asarray, tree), from_numpy(tree, "cpu")
    xj, xt = both(np.random.default_rng(5).normal(size=(2, 9, 64)) * 2)
    ref = jit(RL.ffn_apply, pj, xj, cdt=jdt, gated=gated)
    got = TL.ffn_apply(pt, xt, cdt=tdt, gated=gated)
    assert_close(ref, got.float(), dtype)


def test_unset_rules_only():
    """Rules on a mesh of one (a one-rank gloo group, taken down after)
    run, and give what ``rules=None`` gives bit for bit: every placement
    there is ``Replicate``. The FFN takes DTensor params and a plain
    input; a train step takes DTensor params and state and a plain
    batch. (Meshes of several ranks: tests/test_torch_mesh_train.py.)"""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.models import model as TMODEL
    from repro_torch.optim import adamw as T_ADAMW
    from repro_torch.runtime import sharding as SH
    from repro_torch.params import tree_map
    assert not dist.is_initialized()
    try:
        rules = SH.ShardingRules(make_single_device_mesh(device="cpu"))
        tree = jax.tree.map(np.asarray, RL.ffn_init(jax.random.PRNGKey(5),
                                                    64, 128))
        pt = from_numpy(tree, "cpu")
        dp = SH.place_tree(pt, SH.tree_shardings(rules, TL.ffn_axes(), pt))
        x = torch.from_numpy(np.random.default_rng(5).normal(
            size=(2, 9, 64)).astype(np.float32))
        want = TL.ffn_apply(pt, x, cdt=torch.float32)
        with SH.step_scope(rules):
            got = TL.ffn_apply(dp, x, rules=rules, cdt=torch.float32)
        assert isinstance(got, SH.DTensor)
        assert torch.equal(got.full_tensor(), want)

        cfg = t_arch("qwen3-0.6b").reduced()
        params = TMODEL.init_params(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(
            1, cfg.vocab, (2, 16)).astype(np.int32))
            for k in ("tokens", "labels")}
        opt_cfg = T_ADAMW.AdamWConfig()
        p0, _, m0 = TS.make_train_step(cfg, opt_cfg)(
            params, T_ADAMW.init_state(params), batch)
        sh = SH.tree_shardings(rules, TMODEL.param_axes(cfg), params)
        dparams = SH.place_tree(params, sh)
        p1, _, m1 = TS.make_train_step(cfg, opt_cfg, rules=rules)(
            dparams, T_ADAMW.init_state(dparams), batch)
        assert torch.equal(m1["total_loss"], m0["total_loss"])
        full = tree_map(lambda t: t.full_tensor(), p1)
        for a, b in zip(tree_flatten(full), tree_flatten(p0)):
            assert torch.equal(a, b)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------------- MoE
def moe_cfgs(cf=None):
    r, t = (f("granite-moe-1b-a400m").reduced() for f in (r_arch, t_arch))
    if cf is not None:
        r, t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf)) for c in (r, t))
    return r, t


def reference_route(p, x, cfg, chunk, cdt):
    """The reference's routing of one chunk (src/repro/models/moe.py:67-78:
    the router in ``cdt``, top-k, slots by a token-major cumsum, the
    capacity): (expert indices (B,c,K), kept mask (B,c,K))."""
    m = cfg.moe
    cap = RM._capacity(chunk, cfg)
    h = x.astype(cdt)
    logits = (h @ p["router"].astype(cdt)).astype(jnp.float32)
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    onehot = jax.nn.one_hot(topi, m.n_experts, dtype=jnp.float32)
    B = x.shape[0]
    flat = onehot.reshape(B, chunk * m.top_k, m.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    return np.asarray(topi), np.asarray((pos * onehot).sum(-1) < cap)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cf", [8.0, None])
def test_moe_apply(cf, dtype, monkeypatch):
    """Dropless (capacity factor 8) and the default 1.25, where tokens
    are dropped. Chunks of 8 over S=20 (the last one padded), so slots
    restart per chunk. In float32 the experts and the kept mask equal
    the reference's exactly and the outputs and aux loss agree. In bf16
    the router sees inputs rounded in each package's own order, and a
    near-tie between two experts can go either way: the bf16 limit holds
    for every token that both route to the same kept experts, and at
    least 3/4 of the tokens must be such."""
    jdt, tdt = DTYPES[dtype]
    rcfg, tcfg = moe_cfgs(cf)
    monkeypatch.setattr(RM, "MOE_CHUNK", 8)
    monkeypatch.setattr(TM, "MOE_CHUNK", 8)
    pj, pt = params_pair(RM.moe_init, rcfg, 6)
    # the reference's own MoE tests' input scale
    x = np.random.default_rng(6).normal(size=(2, 20, 64)) * 0.1
    xj, xt = both(x)
    ref, raux = jit(RM.moe_apply, pj, xj, rcfg, cdt=jdt)
    got, taux = TM.moe_apply(pt, xt, tcfg, cdt=tdt)
    xp = np.pad(x, ((0, 0), (0, 4), (0, 0))).astype(np.float32)
    alike, kept = [], []
    for s in range(0, 24, 8):
        xc = xp[:, s:s + 8]
        r_topi, r_keep = reference_route(pj, jnp.asarray(xc), rcfg, 8, jdt)
        _, _, onehot, t_keep, _ = TM.moe_route(
            pt, torch.from_numpy(xc).to(tdt), tcfg, TM._capacity(8, tcfg))
        t_topi = onehot.argmax(-1).numpy()
        if dtype == "float32":
            np.testing.assert_array_equal(t_topi, r_topi)
            np.testing.assert_array_equal(t_keep.numpy(), r_keep)
        alike.append(((t_topi == r_topi) & (t_keep.numpy() == r_keep))
                     .all(-1))
        kept.append(r_keep.all())
    alike = np.concatenate(alike, axis=1)[:, :20]
    assert all(kept) == (cf == 8.0)      # the default drops tokens
    if dtype == "float32":
        assert_close(ref, got, dtype)
        np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5)
    else:
        ref, got = np.asarray(ref.astype(jnp.float32)), got.float().numpy()
        tok = np.abs(ref - got).max(-1) / np.abs(ref).max()
        assert alike.mean() >= 0.75
        assert (tok[alike] <= BF16_LAYER).all()


# ----------------------------------------------------------------- Mamba
def jamba_cfgs():
    return r_arch("jamba-v0.1-52b").reduced(), \
        t_arch("jamba-v0.1-52b").reduced()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mamba_apply_scan_and_step(dtype, monkeypatch):
    """The chunked scan (chunks of 8 over S=20, the last one short) and
    the O(1) step from a random state."""
    jdt, tdt = DTYPES[dtype]
    rcfg, tcfg = jamba_cfgs()
    monkeypatch.setattr(RMB, "MAMBA_CHUNK", 8)
    monkeypatch.setattr(TMB, "MAMBA_CHUNK", 8)
    pj, pt = params_pair(RMB.mamba_init, rcfg, 7, ("conv_b", "D"))
    rng = np.random.default_rng(7)
    xj, xt = both(rng.normal(size=(2, 20, 64)))
    ref, _ = jit(RMB.mamba_apply, pj, xj, rcfg, cdt=jdt)
    got, _ = TMB.mamba_apply(pt, xt, tcfg, cdt=tdt)
    assert_close(ref, got.float(), dtype)

    di = rcfg.hybrid.expand * 64
    st = {"conv": rng.normal(size=(2, rcfg.hybrid.d_conv - 1, di)),
          "ssm": rng.normal(size=(2, di, rcfg.hybrid.d_state))}
    sj = {k: both(v)[0] for k, v in st.items()}
    stt = {k: both(v)[1] for k, v in st.items()}
    x1j, x1t = both(rng.normal(size=(2, 1, 64)))
    ref, rs = jit(RMB.mamba_apply, pj, x1j, rcfg, cdt=jdt, state=sj)
    got, ts = TMB.mamba_apply(pt, x1t, tcfg, cdt=tdt, state=stt)
    assert_close(ref, got.float(), dtype)
    for k in ("conv", "ssm"):
        assert_close(rs[k], ts[k].float(), dtype)


# ----------------------------------------------------------------- xLSTM
def xlstm_cfgs():
    return r_arch("xlstm-125m").reduced(), t_arch("xlstm-125m").reduced()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlstm_block_chunkwise_and_step(dtype, monkeypatch):
    """The chunkwise cell (chunks of 8 over S=20, the last one padded
    with an input gate of -1e30) and the step from a random state."""
    jdt, tdt = DTYPES[dtype]
    rcfg, tcfg = xlstm_cfgs()
    monkeypatch.setattr(RX, "MLSTM_CHUNK", 8)
    monkeypatch.setattr(TX, "MLSTM_CHUNK", 8)
    pj, pt = params_pair(RX.mlstm_init, rcfg, 8,
                         ("norm", "conv_b", "b_i", "b_f", "out_norm", "skip"))
    rng = np.random.default_rng(8)
    xj, xt = both(rng.normal(size=(2, 20, 64)))
    ref, _ = jit(RX.mlstm_block_apply, pj, xj, rcfg, cdt=jdt)
    got, _ = TX.mlstm_block_apply(pt, xt, tcfg, cdt=tdt)
    assert_close(ref, got.float(), dtype)

    st = jax.tree.map(np.asarray, RX.mlstm_init_state(rcfg, 2))
    st["conv"] = rng.normal(size=st["conv"].shape).astype(np.float32)
    st["cell"] = {"C": rng.normal(size=st["cell"]["C"].shape),
                  "n": rng.normal(size=st["cell"]["n"].shape),
                  "m": rng.normal(size=st["cell"]["m"].shape)}
    st = jax.tree.map(lambda a: np.asarray(a, np.float32), st)
    x1j, x1t = both(rng.normal(size=(2, 1, 64)))
    ref, rs = jit(RX.mlstm_block_apply, pj, x1j, rcfg, cdt=jdt,
                  state=jax.tree.map(jnp.asarray, st))
    got, ts = TX.mlstm_block_apply(pt, x1t, tcfg, cdt=tdt,
                                   state=from_numpy(st, "cpu"))
    assert_close(ref, got.float(), dtype)
    for a, b in zip(jax.tree.leaves(rs), tree_flatten(ts), strict=True):
        assert_close(a, b.float(), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_slstm_block_scan_and_step(dtype):
    jdt, tdt = DTYPES[dtype]
    rcfg, tcfg = xlstm_cfgs()
    pj, pt = params_pair(RX.slstm_init, rcfg, 9, ("norm", "b_gates", "gn"))
    rng = np.random.default_rng(9)
    xj, xt = both(rng.normal(size=(2, 12, 64)))
    ref, _ = jit(RX.slstm_block_apply, pj, xj, rcfg, cdt=jdt)
    got, _ = TX.slstm_block_apply(pt, xt, tcfg, cdt=tdt)
    assert_close(ref, got.float(), dtype)

    st = {"c": rng.normal(size=(2, 64)), "n": rng.random((2, 64)) + 0.5,
          "h": rng.normal(size=(2, 64)), "m": rng.normal(size=(2, 64))}
    st = {k: np.asarray(v, np.float32) for k, v in st.items()}
    x1j, x1t = both(rng.normal(size=(2, 1, 64)))
    ref, rs = jit(RX.slstm_block_apply, pj, x1j, rcfg, cdt=jdt,
                  state={k: jnp.asarray(v) for k, v in st.items()})
    got, ts = TX.slstm_block_apply(pt, x1t, tcfg, cdt=tdt,
                                   state=from_numpy(st, "cpu"))
    assert_close(ref, got.float(), dtype)
    for k in st:
        assert_close(rs[k], ts[k], dtype)


# ----------------------------------------------------------------- losses
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_entropy_and_fused_unembed_loss(dtype):
    """vocab 200 of a padded 256, labels with -1 (masked), S=13 in chunks
    of 5 (the last one short); the fused loss equals both the naive one
    and the reference's."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(10)
    h = rng.normal(size=(2, 13, 32))
    table = rng.normal(size=(256, 32)) * 0.3
    labels = rng.integers(-1, 200, (2, 13)).astype(np.int32)
    (hj, ht), (tj, tt) = both(h), both(table)
    lj, lt = jnp.asarray(labels), torch.from_numpy(labels)
    logits_j = jnp.einsum("bsd,vd->bsv", hj.astype(jdt), tj.astype(jdt))
    logits_t = torch.einsum("bsd,vd->bsv", ht.to(tdt), tt.to(tdt))
    ref_ce = float(RS.cross_entropy_loss(logits_j, lj, 200))
    got_ce = float(TS.cross_entropy_loss(logits_t, lt, 200))
    ref_fused = float(RS.fused_unembed_loss(hj.astype(jdt), tj, lj, 200,
                                            chunk=5))
    got_fused = float(TS.fused_unembed_loss(ht.to(tdt), tt, lt, 200,
                                            chunk=5))
    rtol = 1e-6 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(got_ce, ref_ce, rtol=rtol)
    np.testing.assert_allclose(got_fused, ref_fused, rtol=rtol)
    np.testing.assert_allclose(got_fused, got_ce, rtol=rtol)


def test_fused_unembed_loss_gradient():
    """The checkpointed chunks give the naive loss's gradients."""
    rng = np.random.default_rng(11)
    h = torch.tensor(rng.normal(size=(2, 13, 32)), dtype=torch.float32,
                     requires_grad=True)
    table = torch.tensor(rng.normal(size=(256, 32)) * 0.3,
                         dtype=torch.float32, requires_grad=True)
    labels = torch.from_numpy(rng.integers(-1, 200, (2, 13)))
    fused = torch.autograd.grad(
        TS.fused_unembed_loss(h, table, labels, 200, chunk=5), [h, table])
    naive = torch.autograd.grad(TS.cross_entropy_loss(
        torch.einsum("bsd,vd->bsv", h, table), labels, 200), [h, table])
    for a, b in zip(fused, naive):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ------------------------------------------------------------ small helpers
@pytest.mark.parametrize("vocab,batch,seq,seed", [(256, 8, 64, 0),
                                                  (151936, 2, 33, 3)])
def test_synthetic_lm_batches_bit_for_bit(vocab, batch, seq, seed):
    ref = R_PIPE.synthetic_lm_batches(vocab, batch, seq, seed=seed)
    got = T_PIPE.synthetic_lm_batches(vocab, batch, seq, seed=seed)
    for _ in range(3):
        r, g = next(ref), next(got)
        assert sorted(r) == sorted(g)
        for k in r:
            assert g[k].dtype == r[k].dtype
            np.testing.assert_array_equal(g[k], r[k])

