"""The port's Conv1D model against the reference's, on the same params
carried across by the weight bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.costmodel import COSTMODEL_SMALL, CostModelConfig
from repro.core import models as RM
from repro.kernels import ref as R_REF
from repro_torch import params as P
from repro_torch.core import models as TM

FILTERS = [(2, 2, 2), (16, 16, 8, 8, 2, 1), (3, 5), (1,)]
# float32 with another accumulation order than XLA's convolution
TOL = 2e-4


def conv_cfg(fs_list):
    return CostModelConfig(
        name="port-test", vocab_size=128, max_seq=32, embed_dim=8,
        conv_filters=tuple(fs_list), conv_channels=(8,) * len(fs_list),
        fc_dims=(16, 8), lstm_hidden=8)


def ragged_ids(rng, B, S, vocab, all_pad_row=True):
    ids = rng.integers(1, vocab, (B, S))
    lens = rng.integers(1, S + 1, (B,))
    ids[np.arange(S)[None, :] >= lens[:, None]] = 0
    if all_pad_row:
        ids[0] = 0
    return ids.astype(np.int32)


def ref_params(cfg, heads, seed=1, emb_scale=1.0, bias_std=0.1):
    """Reference params as numpy (keys sorted, as jax.tree.map leaves
    them), with the embedding optionally scaled so outputs are O(1) and
    every bias drawn nonzero (conv_init zeroes them) so a dropped bias
    or a nonzero pad shows."""
    p = jax.tree.map(np.asarray, RM.conv_init(jax.random.PRNGKey(seed),
                                              cfg, heads=heads))
    p["emb"] = p["emb"] * np.float32(emb_scale)
    rng = np.random.default_rng(seed)
    for lyr in [*p["convs"], *p["fc"], *p.get("heads", {}).values()]:
        lyr["b"] = (rng.normal(size=lyr["b"].shape) * bias_std).astype(
            np.float32)
    return p


def assert_heads_close(got, want, heads, tol=TOL):
    if heads:
        assert set(got) == set(want) == set(heads)
        for t in heads:
            np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                       rtol=tol, atol=tol)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("emb_scale", [1.0, 50.0])
@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
@pytest.mark.parametrize("fs_list", FILTERS)
def test_conv_apply_matches_reference(fs_list, heads, emb_scale):
    """Every filter mix (even sizes pad right only), both head layouts,
    ragged ids and one all-PAD row."""
    cfg = conv_cfg(fs_list)
    pn = ref_params(cfg, heads, emb_scale=emb_scale)
    ids = ragged_ids(np.random.default_rng(len(fs_list)), 5, 32,
                     cfg.vocab_size)
    want = RM.conv_apply(pn, jnp.asarray(ids))
    got = TM.conv_apply(P.from_numpy(pn, "cpu"), torch.from_numpy(ids))
    assert_heads_close(got, want, heads)


@pytest.mark.parametrize("fs", [1, 2, 3, 4, 5, 8, 16])
def test_conv1d_same_padding_matches_reference(fs):
    """'Same' padding is (fs-1)//2 left, fs//2 right, cross-correlation,
    weights (fs, Cin, Cout): compare one layer against the reference."""
    rng = np.random.default_rng(fs)
    x = rng.normal(size=(3, 20, 4)).astype(np.float32)
    w = rng.normal(size=(fs, 4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = R_REF.conv1d_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = TM.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pooled_features_match_reference():
    """pooled_feats (the max-pool over every position, pads included)
    matches the reference's."""
    cfg = COSTMODEL_SMALL
    pn = ref_params(cfg, RM.DEFAULT_HEADS, seed=3, emb_scale=20.0)
    ids = ragged_ids(np.random.default_rng(4), 4, cfg.max_seq,
                     cfg.vocab_size)
    _, want_pool = RM.conv_apply(pn, jnp.asarray(ids), pooled_feats=True)
    _, got_pool = TM.conv_apply(P.from_numpy(pn, "cpu"),
                                torch.from_numpy(ids), pooled_feats=True)
    np.testing.assert_allclose(got_pool.numpy(), np.asarray(want_pool),
                               rtol=TOL, atol=TOL)
    assert got_pool.shape == (4, cfg.conv_channels[-1])


def test_bridge_round_trip_and_head_order():
    """from_numpy/to_numpy keep every leaf and every name; a tree whose
    head dict lists the targets in sorted order (what jax.tree.map
    returns) predicts the same per-target values by name."""
    raw = RM.conv_init(jax.random.PRNGKey(5), COSTMODEL_SMALL,
                       heads=RM.DEFAULT_HEADS)
    assert tuple(raw["heads"]) == RM.DEFAULT_HEADS      # insertion order
    pn = jax.tree.map(np.asarray, raw)
    assert tuple(pn["heads"]) == tuple(sorted(RM.DEFAULT_HEADS))
    pt = P.from_numpy(pn, "cpu")
    back = P.to_numpy(pt)
    assert jax.tree.structure(back) == jax.tree.structure(pn)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pn)):
        np.testing.assert_array_equal(a, b)
    assert TM.model_heads(pt) == tuple(pn["heads"])
    ids = ragged_ids(np.random.default_rng(6), 3, COSTMODEL_SMALL.max_seq,
                     COSTMODEL_SMALL.vocab_size)
    want = RM.conv_apply(raw, jnp.asarray(ids))
    got = TM.conv_apply(pt, torch.from_numpy(ids))
    assert_heads_close(got, want, RM.DEFAULT_HEADS)
    # bf16: floating leaves cast, names kept; to_numpy widens to f32
    p16 = P.from_numpy(pn, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in P.tree_leaves(p16))
    assert tuple(p16["heads"]) == tuple(pn["heads"])
    assert all(a.dtype == np.float32
               for a in jax.tree.leaves(P.to_numpy(p16)))


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
def test_conv_init_shapes_and_scales(heads):
    cfg = COSTMODEL_SMALL
    want = jax.tree.map(np.asarray, RM.conv_init(jax.random.PRNGKey(0),
                                                 cfg, heads=heads))
    got = P.to_numpy(P.conv_init(cfg, heads,
                                 generator=torch.Generator().manual_seed(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the embedding's scale is 0.02 in both (8192 draws: std within 10%)
    assert abs(got["emb"].std() / want["emb"].std() - 1.0) < 0.1
    assert not got["convs"][0]["b"].any()


def test_bf16_tower_runs_and_stays_close():
    """bf16 params run a bf16 tower in the plain model, as in the
    reference; predictions stay within bf16 rounding of float32."""
    pn = ref_params(COSTMODEL_SMALL, RM.DEFAULT_HEADS, seed=7,
                    emb_scale=20.0)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(8), 6, 64,
                                      COSTMODEL_SMALL.vocab_size))
    f32 = TM.conv_apply(P.from_numpy(pn, "cpu"), ids)
    b16 = TM.conv_apply(P.from_numpy(pn, "cpu", torch.bfloat16), ids)
    for t in RM.DEFAULT_HEADS:
        assert b16[t].dtype == torch.bfloat16
        np.testing.assert_allclose(b16[t].float().numpy(), f32[t].numpy(),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("kind", ["conv1d", "fc", "lstm", "xformer"])
def test_unported_families_say_so(kind):
    """Every family is ported now, so none says it is not: get_model
    returns each family's (init, apply) pair, and an unknown kind is
    still a KeyError naming the four."""
    want = {"conv1d": (P.conv_init, TM.conv_apply),
            "fc": (P.fc_init, TM.fc_apply),
            "lstm": (P.lstm_init, TM.lstm_apply),
            "xformer": (P.xformer_init, TM.xformer_apply)}
    assert TM.get_model(kind) == want[kind]
    assert not hasattr(TM, "NOT_PORTED")
    with pytest.raises(KeyError, match="xformer"):
        TM.get_model("bogus")


# ------------------------------------------------------------------ LSTM
def lstm_params(heads, seed=11, emb_scale=20.0, bias_std=0.1):
    """Reference LSTM params (numpy), embedding scaled so the gates reach
    unit size, and the gate bias and head biases drawn nonzero (lstm_init
    zeroes them) so a dropped bias shows."""
    p = jax.tree.map(np.asarray, RM.lstm_init(jax.random.PRNGKey(seed),
                                              COSTMODEL_SMALL, heads=heads))
    p["emb"] = p["emb"] * np.float32(emb_scale)
    rng = np.random.default_rng(seed)
    p["b"] = (rng.normal(size=p["b"].shape) * bias_std).astype(np.float32)
    for lyr in (p["heads"].values() if heads else [p["head"]]):
        lyr["b"] = (rng.normal(size=lyr["b"].shape) * bias_std).astype(
            np.float32)
    return p


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lstm_apply_matches_reference(heads, dtype):
    """Ragged ids and one all-PAD row, both head layouts. f32 within 1e-5;
    bf16 params run a bf16 scan in both packages, which round at other
    places, so they are held to the reference test's bf16 limits (1e-1
    and Spearman >= 0.9, tests/test_kernels.py)."""
    from repro.opt.evaluate import spearman
    pn = lstm_params(heads)
    ids = ragged_ids(np.random.default_rng(17), 7, COSTMODEL_SMALL.max_seq,
                     COSTMODEL_SMALL.vocab_size)
    if dtype == "f32":
        want = RM.lstm_apply(pn, jnp.asarray(ids))
        got = TM.lstm_apply(P.from_numpy(pn, "cpu"), torch.from_numpy(ids))
        assert_heads_close(got, want, heads, tol=1e-5)
        return
    r16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pn)
    want = RM.lstm_apply(r16, jnp.asarray(ids))
    got = TM.lstm_apply(P.from_numpy(pn, "cpu", torch.bfloat16),
                        torch.from_numpy(ids))
    for t in heads or [None]:
        g = (got[t] if t else got)
        assert g.dtype == torch.bfloat16
        g = g.float().numpy()
        w = np.asarray(want[t] if t else want, np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-1, atol=1e-1)
        assert spearman(w, g) >= 0.9


def test_lstm_masked_steps_carry_and_pad_row_is_zero():
    """A padded step carries (h, c) through: trailing pads leave the
    features as they were after the last token, and an all-PAD row's
    features are exactly 0, as in the reference."""
    pt = P.from_numpy(lstm_params(RM.DEFAULT_HEADS), "cpu")
    ids = ragged_ids(np.random.default_rng(3), 4, 32, 64)
    padded = np.concatenate([ids, np.zeros((4, 16), np.int32)], 1)
    a = TM.lstm_encode(pt, torch.from_numpy(ids))
    b = TM.lstm_encode(pt, torch.from_numpy(padded))
    assert torch.equal(a, b)
    assert not a[0].any()
    want = RM.lstm_encode(lstm_params(RM.DEFAULT_HEADS), jnp.asarray(ids))
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
def test_lstm_init_shapes_scales_and_bridge(heads):
    """lstm_init has the reference's tree, shapes, dtypes and scales; a
    JAX-made LSTM tree crosses the bridge and back unchanged."""
    cfg = COSTMODEL_SMALL
    raw = RM.lstm_init(jax.random.PRNGKey(0), cfg, heads=heads)
    want = jax.tree.map(np.asarray, raw)
    got = P.to_numpy(P.lstm_init(cfg, heads,
                                 generator=torch.Generator().manual_seed(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    h, e = cfg.lstm_hidden, cfg.embed_dim
    assert got["wx"].shape == (e, 4 * h) and got["wh"].shape == (h, 4 * h)
    assert abs(got["emb"].std() / 0.02 - 1.0) < 0.1
    assert abs(got["wh"].std() * np.sqrt(h) - 1.0) < 0.1
    assert not got["b"].any()
    back = P.to_numpy(P.from_numpy(want, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
