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
from repro_torch import params as P
from repro_torch.configs import costmodel as T_CFG
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d_stack as K
from repro_torch.kernels import ops as T_OPS
from repro_torch.kernels import ref as T_REF

FILTERS = [(2, 2, 2), (16, 16, 8, 8, 2, 1), (3, 5), (1,)]
# float32 with another accumulation order than the reference kernel's
TOL = 2e-4


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
    assert T_OPS.KERNEL_KINDS == R_OPS.KERNEL_KINDS
    pt = P.from_numpy(ref_params(COSTMODEL_SMALL, None), "cpu")
    with pytest.raises(NotImplementedError, match="LSTM"):
        T_OPS.forward_apply("lstm", pt, _ids())
    with pytest.raises(ValueError, match="conv1d"):
        T_OPS.forward_apply("fc", pt, _ids())
    assert T_OPS.forward_apply("conv1d", pt, _ids()).shape == (3,)


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


def test_build_dir_is_the_checkout_or_named(monkeypatch, tmp_path):
    """Libraries build under the checkout's build/ (where src/ sits next
    to pyproject.toml), or where $REPRO_TORCH_BUILD_DIR says."""
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    root = Path(_build.__file__).resolve().parents[3]
    assert _build._build_dir() == root / "build" / "repro_torch_kernels"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build._build_dir() == tmp_path
