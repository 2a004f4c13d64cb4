"""The port's FC (bag-of-tokens) and transformer families against the
reference's, on the same numpy params carried across by the weight
bridge; and, over all four families, the reference's own family-wide
checks: bucketed serving equals max_seq padding, and bf16 params run a
bf16 network."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.costmodel import COSTMODEL_SMALL, CostModelConfig
from repro.core import models as RM
from repro.ir import dataset as R_DS
from repro.opt.evaluate import spearman
from repro_torch import params as P
from repro_torch.configs.costmodel import COSTMODEL_SMALL as T_SMALL
from repro_torch.core import models as TM
from repro_torch.core.service import CostModelService
from repro_torch.ir import samplers

# float32 in another order of sums than XLA's
TOL = 2e-4
# bf16 params run a bf16 network in both packages, which round at other
# places (the conv test's limit, tests/test_torch_models.py)
BF16_TOL = 5e-2
KINDS = ("fc", "xformer")


def ragged_ids(rng, B, S, vocab):
    """Ragged valid prefixes and row 0 all PAD."""
    ids = rng.integers(1, vocab, (B, S))
    lens = rng.integers(1, S + 1, (B,))
    ids[np.arange(S)[None, :] >= lens[:, None]] = 0
    ids[0] = 0
    return ids.astype(np.int32)


def ref_params(kind, heads, cfg=COSTMODEL_SMALL, seed=1):
    """The reference's init as numpy, with every bias drawn nonzero, the
    LayerNorm gains moved off 1 and the embedding scaled x20 (the inits
    leave biases 0, gains 1 and outputs small), so a dropped bias, gain
    or position shows."""
    init = RM.get_model(kind)[0]
    key = jax.random.PRNGKey(seed)
    p = jax.tree.map(np.asarray, init(key, cfg, heads=heads) if heads
                     else init(key, cfg))
    rng = np.random.default_rng(seed)

    def draw(a, scale, mean=0.0):
        return (mean + rng.normal(size=a.shape) * scale).astype(np.float32)
    p["emb"] = p["emb"] * np.float32(20.0)
    lyrs = list(p.get("heads", {}).values()) + (
        [p["head"]] if "head" in p else []) + p.get("fc", [])
    for lyr in lyrs:
        lyr["b"] = draw(lyr["b"], 0.1)
    for blk in p.get("blocks", []):
        blk["ln1"], blk["ln2"] = draw(blk["ln1"], 0.1, 1.0), \
            draw(blk["ln2"], 0.1, 1.0)
    return p


def outputs(out, heads):
    """{name: numpy float32} of either layout."""
    if heads:
        return {t: np.asarray(out[t].float() if torch.is_tensor(out[t])
                              else out[t], np.float32) for t in heads}
    return {None: np.asarray(out.float() if torch.is_tensor(out) else out,
                             np.float32)}


@pytest.mark.parametrize("S", [COSTMODEL_SMALL.max_seq, 24])
@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_matches_reference(kind, heads, S):
    """f32 within 2e-4: ragged ids, an all-PAD row, both head layouts,
    and S below max_seq (the transformer reads pos[:S])."""
    pn = ref_params(kind, heads)
    ids = ragged_ids(np.random.default_rng(S), 6, S,
                     COSTMODEL_SMALL.vocab_size)
    want = outputs(RM.get_model(kind)[1](pn, jnp.asarray(ids)), heads)
    got = outputs(TM.get_model(kind)[1](P.from_numpy(pn, "cpu"),
                                        torch.from_numpy(ids)), heads)
    for t in want:
        assert np.isfinite(got[t]).all()
        np.testing.assert_allclose(got[t], want[t], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_matches_reference_and_stays_bf16(kind, heads):
    pn = ref_params(kind, heads)
    ids = ragged_ids(np.random.default_rng(3), 6, COSTMODEL_SMALL.max_seq,
                     COSTMODEL_SMALL.vocab_size)
    r16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pn)
    want = RM.get_model(kind)[1](r16, jnp.asarray(ids))
    got = TM.get_model(kind)[1](P.from_numpy(pn, "cpu", torch.bfloat16),
                                torch.from_numpy(ids))
    for t in heads or [None]:
        assert (got[t] if t else got).dtype == torch.bfloat16
    w, g = outputs(want, heads), outputs(got, heads)
    for t in w:
        np.testing.assert_allclose(g[t], w[t], rtol=BF16_TOL,
                                   atol=BF16_TOL)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_all_pad_row_is_finite_and_pools_to_zero(kind, dtype):
    """A row of PAD only pools to zero (the count is floored at 1; the
    transformer's additive key mask makes its attention uniform, not
    NaN): the FC model then gives the FC stack of zeros, and the
    transformer exactly each head's bias, as the reference does."""
    pn = ref_params(kind, RM.DEFAULT_HEADS)
    ids = np.zeros((3, 16), np.int32)
    ids[1, :5] = 7
    pt = P.from_numpy(pn, "cpu", dtype)
    got = TM.get_model(kind)[1](pt, torch.from_numpy(ids))
    if kind == "fc":
        want = TM.fc_finish(pt, torch.zeros((1, pt["emb"].shape[1]),
                                            dtype=pt["emb"].dtype))
    else:
        feats = TM.xformer_encode(pt, torch.from_numpy(ids))
        assert torch.isfinite(feats.float()).all()
        assert not feats[0].any() and not feats[2].any()
        assert feats[1].any()
        want = {t: h["b"] for t, h in pt["heads"].items()}
    for t in RM.DEFAULT_HEADS:
        assert torch.isfinite(got[t].float()).all()
        # the FC stack of one zero row against three rows' batch: BLAS
        # may sum in another order by batch size
        for r in (0, 2):
            torch.testing.assert_close(got[t][r], want[t][0],
                                       rtol=1e-6, atol=1e-7)
        if kind == "xformer":
            assert got[t][0] == want[t][0] and got[t][2] == want[t][0]
    ref = RM.get_model(kind)[1](pn, jnp.asarray(ids))
    for t in RM.DEFAULT_HEADS:
        assert np.isfinite(np.asarray(ref[t])).all()
        if dtype is None:
            np.testing.assert_allclose(got[t][0].item(), float(ref[t][0]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", KINDS)
def test_encoders_match_reference(kind):
    pn = ref_params(kind, RM.DEFAULT_HEADS)
    ids = ragged_ids(np.random.default_rng(5), 4, 32,
                     COSTMODEL_SMALL.vocab_size)
    want = RM.get_encoder(kind)(pn, jnp.asarray(ids))
    got = TM.get_encoder(kind)(P.from_numpy(pn, "cpu"),
                               torch.from_numpy(ids))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_xformer_parity_can_fail():
    """The parity check above can fail: the reference's forward with the
    positions dropped or the LayerNorm gains left at 1 misses the port's
    by more than 10x the limit. The erf GELU in place of the tanh one
    moves these outputs by ~2.2e-4 only (the two GELUs differ by < 5e-4
    anywhere), so it is held to 100x the port's own distance."""
    pn = ref_params("xformer", RM.DEFAULT_HEADS)
    ids = ragged_ids(np.random.default_rng(6), 6, 32,
                     COSTMODEL_SMALL.vocab_size)
    got = outputs(TM.xformer_apply(P.from_numpy(pn, "cpu"),
                                   torch.from_numpy(ids)), RM.DEFAULT_HEADS)

    def miss(p):
        want = outputs(RM.xformer_apply(p, jnp.asarray(ids)),
                       RM.DEFAULT_HEADS)
        return max(float(np.abs(got[t] - want[t]).max()) for t in want)
    ours = miss(pn)
    assert ours <= TOL
    assert miss({**pn, "pos": np.zeros_like(pn["pos"])}) > 10 * TOL
    unit = [{**b, "ln1": np.ones_like(b["ln1"]),
             "ln2": np.ones_like(b["ln2"])} for b in pn["blocks"]]
    assert miss({**pn, "blocks": unit}) > 10 * TOL
    gelu = jax.nn.gelu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "gelu", lambda x: gelu(x, approximate=False))
        assert miss(pn) > max(100 * ours, TOL / 2)


def test_xformer_trailing_pad_changes_nothing():
    """PAD keys are masked and the pool is masked: rows padded from 24 to
    64 positions give the same outputs."""
    pt = P.from_numpy(ref_params("xformer", RM.DEFAULT_HEADS), "cpu")
    ids = ragged_ids(np.random.default_rng(7), 5, 24,
                     COSTMODEL_SMALL.vocab_size)
    wide = np.zeros((5, COSTMODEL_SMALL.max_seq), np.int32)
    wide[:, :24] = ids
    a = TM.xformer_encode(pt, torch.from_numpy(ids))
    b = TM.xformer_encode(pt, torch.from_numpy(wide))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
@pytest.mark.parametrize("kind", KINDS)
def test_init_shapes_and_scales(kind, heads):
    """The port's init has the reference's tree, shapes, dtypes and
    scales; zero biases, unit LayerNorm gains."""
    cfg = COSTMODEL_SMALL
    init = RM.get_model(kind)[0]
    key = jax.random.PRNGKey(0)
    want = jax.tree.map(np.asarray, init(key, cfg, heads=heads) if heads
                        else init(key, cfg))
    got = P.to_numpy(TM.get_model(kind)[0](
        T_SMALL, heads, generator=torch.Generator().manual_seed(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert abs(got["emb"].std() / 0.02 - 1.0) < 0.1
    if kind == "fc":
        assert got["fc"][0]["w"].shape == (cfg.embed_dim, cfg.fc_dims[0])
        assert not any(lyr["b"].any() for lyr in got["fc"])
        assert abs(got["fc"][0]["w"].std() * np.sqrt(cfg.embed_dim)
                   - 1.0) < 0.1
    else:
        d = cfg.embed_dim
        assert got["pos"].shape == (cfg.max_seq, d)
        assert abs(got["pos"].std() / 0.02 - 1.0) < 0.1
        assert len(got["blocks"]) == 2
        for blk in got["blocks"]:
            assert (blk["ln1"] == 1).all() and (blk["ln2"] == 1).all()
            assert abs(blk["w2"].std() * np.sqrt(4 * d) - 1.0) < 0.15
    for h in (got["heads"].values() if heads else
              [got["head"] if "head" in got else got["fc"][-1]]):
        assert h["w"].shape[1] == 1 and not h["b"].any()


def test_get_model_and_encoder_cover_every_family():
    assert set(TM.MODELS) == set(TM.ENCODERS) == set(RM.MODELS)
    for kind in RM.MODELS:
        assert TM.get_encoder(kind) is TM.ENCODERS[kind]
    with pytest.raises(KeyError):
        TM.get_encoder("bogus")


# ------------------------------------------ the reference's family checks
@pytest.fixture(scope="module")
def vocab():
    return R_DS.build_dataset(200, mode="ops", max_seq=64, vocab_size=512,
                              augment_factor=2, seed=0).vocab


@pytest.mark.parametrize("kind", sorted(RM.MODELS))
def test_bucketed_matches_unbucketed(kind, vocab):
    """The reference's ``tests/test_multihead.py`` check for every
    family: padding to the bucket instead of max_seq does not change a
    prediction (every family masks padding; conv1d keeps pad slack)."""
    rng = np.random.default_rng(9)
    gs = [samplers.sample_graph(rng) for _ in range(8)]
    heads = RM.DEFAULT_HEADS
    params = TM.get_model(kind)[0](T_SMALL, heads,
                                   generator=torch.Generator().manual_seed(2))
    stats = {t: {"mu": 0.0, "sigma": 1.0} for t in heads}

    def mk(buckets):
        return CostModelService(kind, T_SMALL, params, vocab, stats,
                                mode="ops", max_seq=T_SMALL.max_seq,
                                buckets=buckets, device="cpu")
    bucketed, unbucketed = mk(None), mk((T_SMALL.max_seq,))
    assert len(bucketed.buckets) > 1
    pb, pu = bucketed.predict_all(gs), unbucketed.predict_all(gs)
    for t in heads:
        np.testing.assert_allclose(pb[t], pu[t], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{kind}/{t}")


@pytest.mark.parametrize("kind", sorted(RM.MODELS))
def test_bf16_stays_quantized(kind):
    """The reference's ``tests/test_fastpath.py`` check for every
    family: bf16 params run a bf16 network, every head's output bf16 and
    finite."""
    cfg = CostModelConfig(name="bf16-kinds", vocab_size=128, max_seq=32,
                          embed_dim=8, conv_filters=(2, 2),
                          conv_channels=(8, 8), fc_dims=(16, 8),
                          lstm_hidden=8)
    ids = np.zeros((2, 32), np.int32)
    ids[:, :6] = 3
    init, apply = TM.get_model(kind)
    params = init(cfg, RM.DEFAULT_HEADS,
                  generator=torch.Generator().manual_seed(0))
    out = apply(P.from_numpy(params, "cpu", torch.bfloat16),
                torch.from_numpy(ids))
    for t, v in out.items():
        assert v.dtype == torch.bfloat16, (kind, t, v.dtype)
        assert torch.isfinite(v.float()).all(), (kind, t)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_service_keeps_each_heads_ranking(kind, vocab):
    """A bf16 plain service against the f32 one: Spearman >= 0.99 for
    each head, the reference's bf16 drift gate."""
    rng = np.random.default_rng(4)
    gs = [samplers.sample_graph(rng) for _ in range(48)]
    heads = RM.DEFAULT_HEADS
    params = P.from_numpy(ref_params(kind, heads), "cpu")
    stats = {t: {"mu": 0.0, "sigma": 1.0} for t in heads}
    preds = {dt: CostModelService(kind, T_SMALL, params, vocab, stats,
                                  max_seq=T_SMALL.max_seq, dtype=dt,
                                  device="cpu").predict_all(gs)
             for dt in ("f32", "bf16")}
    for t in heads:
        assert spearman(preds["bf16"][t], preds["f32"][t]) >= 0.99, t
