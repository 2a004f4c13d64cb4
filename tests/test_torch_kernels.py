"""The fused conv forward of the port: its wrapper's plain path on the
CPU against the reference kernel (Pallas, interpret mode) and the
reference oracle; the wrapper's checks; the build's failure mode and
directory. The CUDA kernel and its tile planner are tested on the card
by tests/test_torch_chip.py, which needs no JAX."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.costmodel import COSTMODEL_SMALL, CostModelConfig
from repro.core import models as RM
from repro.kernels import ops as R_OPS
from repro.kernels import ref as R_REF
from repro.kernels.conv1d_stack import conv1d_stack_fused as r_tower
from repro.kernels.lstm_scan import lstm_scan_fused as r_lstm_scan
from repro_torch import params as P
from repro_torch.configs import costmodel as T_CFG
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d_stack as K
from repro_torch.kernels import embed_grad as EG
from repro_torch.kernels import lstm_scan as K2
from repro_torch.kernels import ops as T_OPS
from repro_torch.kernels import ref as T_REF

FILTERS = [(2, 2, 2), (16, 16, 8, 8, 2, 1), (3, 5), (1,)]
# the reference's tower test shapes (B, S, C), tests/test_kernels.py
SHAPES = [(1, 16, 8), (4, 32, 16), (5, 64, 32), (8, 128, 64)]
# float32 with another accumulation order than the reference kernel's
TOL = 2e-4
# a bf16 output is the float32 result rounded to nearest: two float32
# results 2e-4 apart may round one bf16 step (2^-7 relative) apart
BF16_RTOL = 2.0 ** -7


def conv_cfg(fs_list):
    return CostModelConfig(
        name="kernel-test", vocab_size=128, max_seq=32, embed_dim=8,
        conv_filters=tuple(fs_list), conv_channels=(8,) * len(fs_list),
        fc_dims=(16, 8), lstm_hidden=8)


def ragged_ids(rng, B, S, vocab):
    ids = rng.integers(1, vocab, (B, S))
    lens = rng.integers(1, S + 1, (B,))
    ids[np.arange(S)[None, :] >= lens[:, None]] = 0
    ids[0] = 0                                   # one all-PAD row
    return ids.astype(np.int32)


def ref_params(cfg, heads, seed=1, emb_scale=20.0, bias_std=0.1):
    """Reference params (numpy), embedding scaled so outputs are O(1)
    and the absolute tolerance is a tight bound, and every bias drawn
    nonzero (conv_init zeroes them) so a dropped bias shows."""
    p = jax.tree.map(np.asarray, RM.conv_init(jax.random.PRNGKey(seed),
                                              cfg, heads=heads))
    p["emb"] = p["emb"] * np.float32(emb_scale)
    rng = np.random.default_rng(seed)
    for lyr in [*p["convs"], *p["fc"], *p.get("heads", {}).values()]:
        lyr["b"] = (rng.normal(size=lyr["b"].shape) * bias_std).astype(
            np.float32)
    return p


def as_np(out, heads):
    if heads:
        return np.stack([np.asarray(out[t], np.float32) for t in heads], 1)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
@pytest.mark.parametrize("fs_list", FILTERS)
def test_forward_apply_matches_reference_kernel(fs_list, heads):
    """Port conv_forward_apply (plain path on the CPU) vs the reference
    Pallas kernel in interpret mode and the reference oracle."""
    cfg = conv_cfg(fs_list)
    pn = ref_params(cfg, heads)
    ids = ragged_ids(np.random.default_rng(len(fs_list)), 5, 32,
                     cfg.vocab_size)
    got = T_OPS.conv_forward_apply(P.from_numpy(pn, "cpu"),
                                   torch.from_numpy(ids))
    names = tuple(pn["heads"]) if heads else None
    got = as_np({t: v.numpy() for t, v in got.items()} if heads
                else got.numpy(), names)
    kern = R_OPS.conv_forward_apply(pn, jnp.asarray(ids), interpret=True)
    oracle = R_REF.conv_forward_ref(pn, jnp.asarray(ids))
    np.testing.assert_allclose(got, as_np(kern, names), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, as_np(oracle, names), rtol=TOL,
                               atol=TOL)


def test_bf16_params_match_f32_cast_plain_and_reference():
    """bf16 params: float32 output equal (within f32 accumulation order)
    to the plain version on the same params widened to f32, and to the
    reference kernel on the same bf16 params."""
    pn = ref_params(COSTMODEL_SMALL, RM.DEFAULT_HEADS, seed=7)
    ids = ragged_ids(np.random.default_rng(9), 6, 64,
                     COSTMODEL_SMALL.vocab_size)
    p16 = P.from_numpy(pn, "cpu", torch.bfloat16)
    got = T_OPS.conv_forward_apply(p16, torch.from_numpy(ids))
    want = T_REF.conv_forward_ref(p16, torch.from_numpy(ids))
    r16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pn)
    kern = R_OPS.conv_forward_apply(r16, jnp.asarray(ids), interpret=True)
    for t in RM.DEFAULT_HEADS:
        assert got[t].dtype == torch.float32
        np.testing.assert_allclose(got[t].numpy(), want[t].numpy(),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[t].numpy(), np.asarray(kern[t]),
                                   rtol=TOL, atol=TOL)


def _args(heads=RM.DEFAULT_HEADS):
    pt = P.from_numpy(ref_params(COSTMODEL_SMALL, heads), "cpu")
    return list(T_OPS.fused_args(pt)[0])


def _ids(B=3, S=16):
    return torch.from_numpy(ragged_ids(np.random.default_rng(0), B, S,
                                       COSTMODEL_SMALL.vocab_size))


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
def test_conv_serving_params_give_the_same_rows(heads):
    """The service's precomputed stacked heads give the rows
    conv_forward_apply computes from the params alone, bit for bit, and
    serving_params leaves the conv params as they were."""
    pt = P.from_numpy(ref_params(COSTMODEL_SMALL, heads), "cpu")
    served = T_OPS.serving_params("conv1d", pt)
    assert all(served[k] is pt[k] for k in pt)
    ids = _ids(B=4, S=32)
    a = T_OPS.conv_forward_apply(pt, ids)
    b = T_OPS.conv_forward_apply(served, ids)
    for t in (heads or [None]):
        assert torch.equal(a[t] if t else a, b[t] if t else b)


@pytest.mark.parametrize("case", ["int64", "too_big", "negative",
                                  "noncontig", "mixed_dtype", "bad_chain",
                                  "one_dim", "bad_heads"])
def test_wrapper_rejects_bad_input(case):
    ids, args = _ids(), _args()
    V = args[0].shape[0]
    if case == "int64":
        ids = ids.long()
    elif case == "too_big":
        ids[1, 0] = V
    elif case == "negative":
        ids[1, 0] = -1
    elif case == "noncontig":
        ids = _ids(S=32)[:, ::2]
    elif case == "mixed_dtype":
        args[5] = args[5].to(torch.bfloat16)
    elif case == "bad_chain":
        args[1] = [args[1][0]] + [w[:, :4].contiguous()
                                  for w in args[1][1:]]
    elif case == "one_dim":
        ids = ids[0]
    elif case == "bad_heads":
        args[6] = torch.cat([args[6], args[6]], 0)
    with pytest.raises(ValueError):
        K.conv_forward_fused(ids, *args)


def test_wrapper_plain_path_on_cpu_counts_no_launch():
    before = K.conv_forward_fused.launches
    out = K.conv_forward_fused(_ids(), *_args())
    assert out.shape == (3, 3) and out.dtype == torch.float32
    assert K.conv_forward_fused.launches == before


def test_wrapper_check_ids_false_skips_the_range_check():
    """check_ids=False (the service's path: it checks on the host) does
    not run the wrapper's range check; the plain version then indexes
    the table itself and rejects the id in its own way."""
    ids, args = _ids(), _args()
    ids[1, 0] = args[0].shape[0]
    with pytest.raises(ValueError, match="token ids"):
        K.conv_forward_fused(ids, *args)
    with pytest.raises(IndexError):
        K.conv_forward_fused(ids, *args, check_ids=False)


def test_kernel_kinds_and_dispatch():
    """forward_apply sends conv1d to the fused conv forward and lstm to
    the LSTM forward; a kind without a kernel raises ValueError."""
    assert T_OPS.KERNEL_KINDS == R_OPS.KERNEL_KINDS
    pt = P.from_numpy(ref_params(COSTMODEL_SMALL, None), "cpu")
    with pytest.raises(ValueError, match="conv1d"):
        T_OPS.forward_apply("fc", pt, _ids())
    assert T_OPS.forward_apply("conv1d", pt, _ids()).shape == (3,)
    lt = P.from_numpy(lstm_ref_params(None), "cpu")
    before = K2.lstm_scan_fused.launches
    out = T_OPS.forward_apply("lstm", lt, _ids())
    assert out.shape == (3,) and out.dtype == torch.float32
    assert K2.lstm_scan_fused.launches == before        # plain on the CPU


def test_fused_forward_bytes_matches_reference():
    pn = ref_params(COSTMODEL_SMALL, RM.DEFAULT_HEADS)
    assert T_OPS.fused_forward_bytes(P.from_numpy(pn, "cpu"), 8, 64) == \
        R_OPS.fused_forward_bytes(pn, 8, 64)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc on PATH or under CUDA_HOME: the build raises, no fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("conv_forward")
    key = _build.library_path("conv_forward")
    assert key.parent == tmp_path / "build" and key.suffix == ".so"


def test_library_name_follows_the_shared_header(monkeypatch, tmp_path):
    """K1 and K3 include csrc/conv_tile.cuh: editing it rebuilds both."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in ("conv_forward",
                                                  "conv_tower")}
    for name in before:
        assert '#include "conv_tile.cuh"' in (csrc / f"{name}.cu").read_text()
    with open(csrc / "conv_tile.cuh", "a") as f:
        f.write("// edited\n")
    for name, path in before.items():
        assert _build.library_path(name) != path, name


def test_build_dir_is_the_checkout_or_named(monkeypatch, tmp_path):
    """Libraries build under the checkout's build/ (where src/ sits next
    to pyproject.toml), or where $REPRO_TORCH_BUILD_DIR says."""
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    root = Path(_build.__file__).resolve().parents[3]
    assert _build._build_dir() == root / "build" / "repro_torch_kernels"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build._build_dir() == tmp_path


# ------------------------------------------------------ LSTM recurrence
def lstm_ref_params(heads, seed=11):
    """Reference LSTM params (numpy), embedding x20 so the gates reach
    unit size, gate bias and head biases drawn nonzero."""
    p = jax.tree.map(np.asarray, RM.lstm_init(jax.random.PRNGKey(seed),
                                              COSTMODEL_SMALL, heads=heads))
    p["emb"] = p["emb"] * np.float32(20.0)
    rng = np.random.default_rng(seed)
    p["b"] = (rng.normal(size=p["b"].shape) * 0.1).astype(np.float32)
    for lyr in (p["heads"].values() if heads else [p["head"]]):
        lyr["b"] = (rng.normal(size=lyr["b"].shape) * 0.1).astype(
            np.float32)
    return p


def _scan_inputs(shape):
    """The reference test's inputs: random mask, one fully masked row."""
    B, S, H = shape
    rng = np.random.default_rng(B * 1000 + S + H)
    xw = (rng.normal(size=(B, S, 4 * H)) * 0.5).astype(np.float32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    mask[0] = 0.0
    wh = (rng.normal(size=(H, 4 * H)) * 0.3).astype(np.float32)
    return xw, mask, wh


@pytest.mark.parametrize("shape", [(1, 16, 8), (5, 32, 16), (8, 64, 16)])
def test_lstm_scan_matches_reference_kernel(shape):
    """Port lstm_scan_fused (plain path on the CPU) vs the reference
    Pallas kernel in interpret mode and the reference oracle, within the
    reference test's 1e-5; the fully masked row is exactly 0."""
    xw, mask, wh = _scan_inputs(shape)
    got = K2.lstm_scan_fused(torch.from_numpy(xw), torch.from_numpy(mask),
                             torch.from_numpy(wh))
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[2])
    kern = r_lstm_scan(jnp.asarray(xw), jnp.asarray(mask), jnp.asarray(wh),
                       bblk=4, interpret=True)
    oracle = R_REF.lstm_scan_ref(jnp.asarray(xw), jnp.asarray(mask),
                                 jnp.asarray(wh))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)
    assert not got[0].any()


def test_lstm_scan_heads_are_the_stacked_matmul():
    """With stacked heads the wrapper returns h @ head_w + head_b of the
    same recurrence (one launch on the card)."""
    xw, mask, wh = (torch.from_numpy(a) for a in _scan_inputs((5, 32, 16)))
    rng = np.random.default_rng(4)
    hw = torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32))
    hb = torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))
    h = K2.lstm_scan_fused(xw, mask, wh)
    got = K2.lstm_scan_fused(xw, mask, wh, hw, hb)
    torch.testing.assert_close(got, h @ hw + hb, rtol=1e-6, atol=1e-6)
    assert not (got[0] - hb).any()              # all-PAD row: h == 0


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lstm_forward_apply_matches_reference_kernel(heads, dtype):
    """Port lstm_forward_apply (plain path on the CPU) vs the reference's
    lstm_forward_apply with its Pallas kernel in interpret mode, ragged
    ids and one all-PAD row. Both compute the recurrence in float32 from
    the same projection, so bf16 params are held to 2e-4 as well."""
    pn = lstm_ref_params(heads)
    ids = ragged_ids(np.random.default_rng(17), 7, 64,
                     COSTMODEL_SMALL.vocab_size)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pn) \
        if dtype == "bf16" else pn
    tp = P.from_numpy(pn, "cpu",
                      torch.bfloat16 if dtype == "bf16" else None)
    got = T_OPS.lstm_forward_apply(tp, torch.from_numpy(ids))
    kern = R_OPS.lstm_forward_apply(rp, jnp.asarray(ids), interpret=True)
    names = tuple(pn["heads"]) if heads else None
    got = as_np({t: v.numpy() for t, v in got.items()} if heads
                else got.numpy(), names)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, as_np(kern, names), rtol=TOL, atol=TOL)


def test_lstm_forward_apply_gathers_a_precomputed_table():
    """params["xw_table"] (the service precomputes it) gives the same
    predictions as the table computed per call, which equals the
    per-position projection emb[ids] @ wx + b."""
    pt = P.from_numpy(lstm_ref_params(RM.DEFAULT_HEADS), "cpu")
    ids = _ids(B=4, S=32)
    table = T_OPS.lstm_xw_table(pt)
    torch.testing.assert_close(table[ids],
                               pt["emb"][ids] @ pt["wx"] + pt["b"])
    a = T_OPS.lstm_forward_apply(pt, ids)
    b = T_OPS.lstm_forward_apply(dict(pt, xw_table=table), ids)
    for t in RM.DEFAULT_HEADS:
        assert torch.equal(a[t], b[t])


def _scan_args():
    return [torch.from_numpy(a) for a in _scan_inputs((3, 8, 4))]


@pytest.mark.parametrize("case", ["wrong_dtype", "mixed_dtype", "bad_4h",
                                  "bad_wh", "noncontig", "two_devices",
                                  "mask_dtype", "mask_shape", "half_heads",
                                  "bad_heads", "mixed_heads"])
def test_lstm_wrapper_rejects_bad_input(case):
    xw, mask, wh = _scan_args()
    heads = ()
    if case == "wrong_dtype":
        xw, wh = xw.half(), wh.half()
    elif case == "mixed_dtype":
        wh = wh.to(torch.bfloat16)
    elif case == "bad_4h":
        xw = xw[..., :12].contiguous()
    elif case == "bad_wh":
        wh = wh[:3].contiguous()
    elif case == "noncontig":
        xw = xw.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "two_devices":
        wh = wh.to("meta")
    elif case == "mask_dtype":
        mask = mask.bool()
    elif case == "mask_shape":
        mask = mask[:, :4].contiguous()
    elif case == "half_heads":
        heads = (torch.zeros(4, 2),)
    elif case == "bad_heads":
        heads = (torch.zeros(5, 2), torch.zeros(2))
    elif case == "mixed_heads":
        heads = (torch.zeros(4, 2).to(torch.bfloat16), torch.zeros(2))
    with pytest.raises(ValueError):
        K2.lstm_scan_fused(xw, mask, wh, *heads)


def test_lstm_wrapper_plain_path_on_cpu_counts_no_launch():
    before = K2.lstm_scan_fused.launches
    out = K2.lstm_scan_fused(*_scan_args())
    assert out.shape == (3, 4) and out.dtype == torch.float32
    assert K2.lstm_scan_fused.launches == before


# ------------------------------------------- LSTM recurrence, ids entry
def _ids_entry_args(pt, ids):
    """lstm_scan_ids' arguments for a param tree: its projection table,
    the ids, wh and the stacked heads, and the head names."""
    head_w, head_b, names = T_OPS.lstm_serving_params(pt)["stacked_heads"]
    return (T_OPS.lstm_xw_table(pt), ids, pt["wh"], head_w, head_b), names


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lstm_scan_ids_matches_reference_forward(heads, dtype):
    """The ids entry (plain path on the CPU) on the projection table and
    the stacked heads vs the reference's lstm_forward_apply with its
    Pallas kernel in interpret mode: ragged ids, within the reference's
    limits; the all-PAD row's hidden state is exactly 0."""
    pn = lstm_ref_params(heads, seed=13)
    ids = ragged_ids(np.random.default_rng(19), 6, 48,
                     COSTMODEL_SMALL.vocab_size)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pn) \
        if dtype == "bf16" else pn
    tp = P.from_numpy(pn, "cpu",
                      torch.bfloat16 if dtype == "bf16" else None)
    args, names = _ids_entry_args(tp, torch.from_numpy(ids))
    got = K2.lstm_scan_ids(*args)
    assert got.dtype == torch.float32 and got.shape == (6, len(names or
                                                             (0,)))
    kern = R_OPS.lstm_forward_apply(rp, jnp.asarray(ids), interpret=True)
    np.testing.assert_allclose(got.numpy() if names else got[:, 0].numpy(),
                               as_np(kern, names), rtol=TOL, atol=TOL)
    h = K2.lstm_scan_ids(*args[:3])
    assert h.shape == (6, COSTMODEL_SMALL.lstm_hidden)
    assert not h[0].any()
    assert torch.equal(got[0], args[4].float())          # h = 0: bias only


@pytest.mark.parametrize("heads", [False, True])
def test_lstm_scan_ids_equals_fused_on_the_gathered_gates(heads):
    """lstm_scan_ids(table, ids, ...) == lstm_scan_fused(table[ids],
    (ids != 0).float(), ...) bit for bit for ids inside the table."""
    pt = P.from_numpy(lstm_ref_params(RM.DEFAULT_HEADS), "cpu")
    ids = _ids(B=5, S=32)
    (table, _, wh, hw, hb), _ = _ids_entry_args(pt, ids)
    extra = (hw, hb) if heads else ()
    got = K2.lstm_scan_ids(table, ids, wh, *extra)
    want = K2.lstm_scan_fused(table[ids], (ids != 0).float(), wh, *extra)
    assert torch.equal(got, want)


def test_lstm_scan_ids_reads_an_id_outside_the_table_as_pad():
    pt = P.from_numpy(lstm_ref_params(None), "cpu")
    ids = _ids(B=4, S=16)
    table, wh = T_OPS.lstm_xw_table(pt), pt["wh"]
    bad, pad = ids.clone(), ids.clone()
    for r, (pos, v) in enumerate(((0, -1), (3, table.shape[0]),
                                  (15, 1 << 30))):
        bad[r + 1, pos], pad[r + 1, pos] = v, 0
    assert torch.equal(K2.lstm_scan_ids(table, bad, wh),
                       K2.lstm_scan_ids(table, pad, wh))
    assert not torch.equal(K2.lstm_scan_ids(table, pad, wh),
                           K2.lstm_scan_ids(table, ids, wh))


def test_lstm_serving_params_give_the_same_rows():
    """The service's precomputed table and stacked heads give the rows
    lstm_forward_apply computes from the params alone, bit for bit."""
    pt = P.from_numpy(lstm_ref_params(RM.DEFAULT_HEADS), "cpu")
    ids = _ids(B=4, S=32)
    a = T_OPS.lstm_forward_apply(pt, ids)
    b = T_OPS.lstm_forward_apply(T_OPS.lstm_serving_params(pt), ids)
    for t in RM.DEFAULT_HEADS:
        assert torch.equal(a[t], b[t])


@pytest.mark.parametrize("case", ["ids_int64", "ids_1d", "bad_table_4h",
                                  "table_1d", "empty_table", "two_devices",
                                  "ids_noncontig", "table_noncontig",
                                  "mixed_dtype", "half_heads"])
def test_lstm_ids_wrapper_rejects_bad_input(case):
    pt = P.from_numpy(lstm_ref_params(None), "cpu")
    table, ids, wh = T_OPS.lstm_xw_table(pt), _ids(B=3, S=8), pt["wh"]
    heads = ()
    if case == "ids_int64":
        ids = ids.long()
    elif case == "ids_1d":
        ids = ids[0].contiguous()
    elif case == "bad_table_4h":
        table = table[:, :-4].contiguous()
    elif case == "table_1d":
        table = table[0].contiguous()
    elif case == "empty_table":
        table = table[:0]
    elif case == "two_devices":
        table = table.to("meta")
    elif case == "ids_noncontig":
        ids = ids.t().contiguous().t()
    elif case == "table_noncontig":
        table = table.t().contiguous().t()
    elif case == "mixed_dtype":
        wh = wh.to(torch.bfloat16)
    elif case == "half_heads":
        heads = (torch.zeros(wh.shape[0], 2), None)
    with pytest.raises(ValueError):
        K2.lstm_scan_ids(table, ids, wh, *heads)


def test_lstm_ids_wrapper_plain_path_on_cpu_counts_no_launch():
    pt = P.from_numpy(lstm_ref_params(None), "cpu")
    before = K2.lstm_scan_ids.launches
    out = K2.lstm_scan_ids(T_OPS.lstm_xw_table(pt), _ids(), pt["wh"])
    assert out.shape == (3, COSTMODEL_SMALL.lstm_hidden)
    assert K2.lstm_scan_ids.launches == before


# ------------------------------------------------------- tower (masked)
def _tower_inputs(rng, B, S, C, fs_list):
    """The reference test's inputs (random x at every position, random
    mask with position 0 valid), biases drawn nonzero, row 0 masked."""
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    mask = (rng.random((B, S)) < 0.85).astype(np.float32)
    mask[:, 0] = 1.0
    mask[0] = 0.0
    ws, bs, cin = [], [], C
    for fs in fs_list:
        ws.append((rng.normal(size=(fs, cin, C)) * 0.2).astype(np.float32))
        bs.append((rng.normal(size=(C,)) * 0.1).astype(np.float32))
    return x, ws, bs, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fs_list", FILTERS)
def test_conv1d_stack_matches_reference_kernel(fs_list, shape, dtype):
    """Port conv1d_stack_fused (plain path on the CPU) vs the reference
    Pallas tower kernel in interpret mode: the same float32 arithmetic,
    the output in x's dtype (bf16: within one bf16 step); the all-masked
    row pools to exactly 0."""
    rng = np.random.default_rng(shape[0] * 100 + len(fs_list))
    x, ws, bs, mask = _tower_inputs(rng, *shape, fs_list)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = r_tower(jnp.asarray(x, jdt), [jnp.asarray(w, jdt) for w in ws],
                   [jnp.asarray(b, jdt) for b in bs], jnp.asarray(mask),
                   bblk=4, interpret=True)
    got = K.conv1d_stack_fused(torch.from_numpy(x).to(tdt),
                               [torch.from_numpy(w).to(tdt) for w in ws],
                               [torch.from_numpy(b).to(tdt) for b in bs],
                               torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (shape[0], shape[2])
    rtol = TOL if dtype == "f32" else BF16_RTOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=TOL)
    assert not got[0].any()


def _tower_params(heads):
    return ref_params(conv_cfg((3, 5)), heads, emb_scale=20.0)


@pytest.mark.parametrize("heads", [None, RM.DEFAULT_HEADS])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_conv_tower_apply_matches_reference(heads, use_kernel):
    """Port conv_tower_apply vs the reference's (its Pallas tower in
    interpret mode, or its plain tower), with nonzero biases, ragged ids
    and one all-PAD row. Both pool over valid positions only, which is
    not conv_apply's pool: the test also asserts that with these biases
    an unmasked pool would give other features, so the check can fail."""
    pn = _tower_params(heads)
    ids = ragged_ids(np.random.default_rng(5), 6, 32, 128)
    pt = P.from_numpy(pn, "cpu")
    got = T_OPS.conv_tower_apply(pt, torch.from_numpy(ids),
                                 use_kernel=use_kernel)
    want = R_OPS.conv_tower_apply(pn, jnp.asarray(ids),
                                  use_kernel=use_kernel, interpret=True)
    names = tuple(pn["heads"]) if heads else None
    got = as_np({t: v.numpy() for t, v in got.items()} if heads
                else got.numpy(), names)
    np.testing.assert_allclose(got, as_np(want, names), rtol=TOL, atol=TOL)
    unmasked = RM.conv_apply(pn, jnp.asarray(ids))
    assert np.abs(got - as_np(unmasked, names)).max() > 10 * TOL


def _tower_args():
    rng = np.random.default_rng(0)
    x, ws, bs, mask = _tower_inputs(rng, 3, 16, 8, (2, 3))
    return (torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs], torch.from_numpy(mask))


@pytest.mark.parametrize("case", ["mixed_dtype", "wrong_dtype", "noncontig",
                                  "two_devices", "bad_chain", "no_layers",
                                  "mask_dtype", "two_dim"])
def test_tower_wrapper_rejects_bad_input(case):
    x, ws, bs, mask = _tower_args()
    if case == "mixed_dtype":
        ws = [ws[0].to(torch.bfloat16), ws[1]]
    elif case == "wrong_dtype":
        x, ws, bs = x.half(), [w.half() for w in ws], [b.half() for b in bs]
    elif case == "noncontig":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "two_devices":
        mask = mask.to("meta")
    elif case == "bad_chain":
        ws = [ws[0], ws[1][:, :4].contiguous()]
    elif case == "no_layers":
        ws, bs = [], []
    elif case == "mask_dtype":
        mask = mask.bool()
    elif case == "two_dim":
        x = x[0]
    with pytest.raises(ValueError):
        K.conv1d_stack_fused(x, ws, bs, mask)


def test_tower_wrapper_plain_path_on_cpu_counts_no_launch():
    before = K.conv1d_stack_fused.launches
    x, ws, bs, mask = _tower_args()
    for dt in (torch.float32, torch.bfloat16):
        out = K.conv1d_stack_fused(x.to(dt), [w.to(dt) for w in ws],
                                   [b.to(dt) for b in bs], mask)
        assert out.shape == (3, 8) and out.dtype == dt
    assert K.conv1d_stack_fused.launches == before


def test_every_kernel_source_ships_as_package_data():
    """An installed copy of the package builds its kernels from the
    files that ``pyproject.toml``'s package data lists: every file under
    ``kernels/csrc`` (the ``.cu`` sources and the ``.cuh`` header K1 and
    K3 include) matches one of its globs."""
    import fnmatch
    import tomllib
    root = Path(__file__).resolve().parents[1]
    cfg = tomllib.loads((root / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["repro_torch"]
    pkg = root / "src" / "repro_torch"
    files = [p.relative_to(pkg).as_posix()
             for p in (pkg / "kernels" / "csrc").rglob("*") if p.is_file()]
    assert any(f.endswith(".cuh") for f in files)
    for f in files:
        assert any(fnmatch.fnmatch(f, g) for g in globs), f
    # the build compiles csrc/<name>.cu and hashes csrc/*.cuh
    for p in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        assert p.relative_to(pkg).as_posix() in files


# ------------------------------------------- the launch seam (_build.py)
STREAM = 0x5EA1                  # the stubbed current stream's raw handle


def _seam_conv_forward(B):
    E, C, F = 4, 6, 5
    return K._launch(torch.ones((B, 8), dtype=torch.int32),
                     torch.zeros((16, E)), [torch.zeros((2, E, C))],
                     [torch.zeros(C)], [torch.zeros((C, F))],
                     [torch.zeros(F)], torch.zeros((F, 3)), torch.zeros(3))


def _seam_conv_tower(B):
    return K._launch_tower(torch.zeros((B, 8, 4)), [torch.zeros((2, 4, 6))],
                           [torch.zeros(6)], torch.ones((B, 8)))


def _seam_lstm_scan(B):
    return K2._launch(torch.zeros((B, 8, 16)), torch.ones((B, 8)),
                      torch.zeros((4, 16)))


def _seam_lstm_scan_ids(B):
    return K2._launch_ids(torch.zeros((16, 16)),
                          torch.ones((B, 8), dtype=torch.int32),
                          torch.zeros((4, 16)))


def _seam_embed_grad(B):
    return EG._launch(torch.zeros((B, 8, 4)),
                      torch.ones((B, 8), dtype=torch.int32), 16)


# wrapper -> (its launch on B rows, the counted op, its library, its entry)
SEAM = {
    "conv_forward": (_seam_conv_forward, K.conv_forward_fused, K.LIB,
                     "conv_forward_f32"),
    "conv_tower": (_seam_conv_tower, K.conv1d_stack_fused, K.TOWER_LIB,
                   "conv_tower_f32"),
    "lstm_scan": (_seam_lstm_scan, K2.lstm_scan_fused, K2.LIB,
                  "lstm_scan_f32"),
    "lstm_scan_ids": (_seam_lstm_scan_ids, K2.lstm_scan_ids, K2.LIB,
                      "lstm_scan_ids_f32"),
    "embed_grad": (_seam_embed_grad, EG.embed_grad, EG.LIB,
                   "embed_grad_f32"),
}


@pytest.fixture
def seam(monkeypatch):
    """The wrappers' launch functions on CPU tensors with the card
    stubbed: ``calls[name]`` records each call of an entry, which
    returns ``rc[name]`` (0 unless set); the plan entries are stubbed
    with what the launches need of them."""
    calls, rc = {}, {}

    def bind(lib, name, argtypes):
        def entry(*args):
            calls.setdefault(name, []).append(args)
            return rc.get(name, 0)
        return entry
    monkeypatch.setattr(_build, "load", lambda name: name)
    monkeypatch.setattr(_build, "bind", bind)
    monkeypatch.setattr(_build, "error_string",
                        lambda lib, code: f"stub error {code} of {lib}")
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: STREAM, raising=False)
    # a CPU tensor's device has index None: the stub makes it the
    # current device, so no device guard is entered
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(K, "_forward_plan", lambda *a: (1, 1, 1, 0, 64))
    monkeypatch.setattr(K, "_tower_plan", lambda *a: (1, 1, 1, 0, 64))
    monkeypatch.setattr(K2, "max_hidden", lambda: 128)
    return calls, rc


@pytest.mark.parametrize("wrapper", sorted(SEAM))
def test_seam_counts_one_launch_on_the_current_stream(seam, wrapper):
    calls, _ = seam
    run, counted, _, entry = SEAM[wrapper]
    before = counted.launches
    run(3)
    assert counted.launches == before + 1
    assert len(calls[entry]) == 1 and calls[entry][0][-1] == STREAM


@pytest.mark.parametrize("wrapper,code,exc,match", [
    ("conv_forward", -2, ValueError, "shared memory"),
    ("conv_forward", -1, ValueError, "kMaxConv"),
    ("conv_forward", -3, RuntimeError, "workspace smaller than the plan's"),
    ("conv_tower", -2, ValueError, "shared memory"),
    ("lstm_scan", -1, ValueError, "kMaxHidden = 128"),
    ("lstm_scan_ids", -1, ValueError, "kMaxHidden = 128"),
    ("embed_grad", -1, RuntimeError, "workspace smaller than the plan's"),
])
def test_seam_raises_the_wrappers_own_code_from_its_table(seam, wrapper,
                                                          code, exc, match):
    _, rc = seam
    run, counted, _, entry = SEAM[wrapper]
    rc[entry] = code
    before = counted.launches
    with pytest.raises(exc, match=match):
        run(3)
    assert counted.launches == before


@pytest.mark.parametrize("wrapper", sorted(SEAM))
def test_seam_raises_a_cuda_error_with_its_message(seam, wrapper):
    _, rc = seam
    run, counted, lib, entry = SEAM[wrapper]
    rc[entry] = 700
    before = counted.launches
    with pytest.raises(RuntimeError, match=rf"^{lib} kernel launch failed "
                       rf"\(700\): stub error 700 of {lib}$"):
        run(3)
    assert counted.launches == before


@pytest.mark.parametrize("wrapper", sorted(SEAM))
def test_seam_counts_nothing_without_a_launch(seam, wrapper):
    """B = 0 (an empty lookup for E1) launches nothing and counts
    nothing; only K2's entries are called, for their check of H."""
    calls, _ = seam
    run, counted, _, entry = SEAM[wrapper]
    before = counted.launches
    out = run(0)
    assert out.shape[0] == (16 if wrapper == "embed_grad" else 0)
    assert counted.launches == before
    assert (entry in calls) == wrapper.startswith("lstm_scan")
