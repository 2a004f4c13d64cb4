"""The port on an NVIDIA card: the CUDA kernels (the fused conv forward,
the LSTM recurrence through both its entries, the masked conv tower, the
conv1d lookup's backward) against their plain versions, rows
bit-identical across the batch ladder, and the services and server on
the card. Every case is marked ``chip`` and skips where
``torch.cuda.is_available()`` is False. This file imports neither JAX
nor the reference package, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_chip.py

The training checks need deterministic algorithms, and with them cuBLAS
needs ``CUBLAS_WORKSPACE_CONFIG`` before its first call; this module
sets it when it is imported.
"""
import dataclasses
import functools
import importlib.util
import os
import threading
from pathlib import Path
from unittest import mock

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import params as P
from repro_torch.checkpoint import ckpt
from repro_torch.configs import costmodel as CFGS
from repro_torch.core import models as CM
from repro_torch.core import tokenizer as TOK
from repro_torch.core import trainer as TR
from repro_torch.core.models import DEFAULT_HEADS
from repro_torch.core.server import CostModelServer
from repro_torch.core.service import CostModelService
from repro_torch.ir import dataset as DS
from repro_torch.ir import frontdoor as FD
from repro_torch.ir import printer, samplers
from repro_torch.obs import trace as OBS
from repro_torch.kernels import conv1d_stack as K
from repro_torch.kernels import embed_grad as EG
from repro_torch.kernels import lstm_scan as K2
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF

TOL = 2e-4          # float32: the kernel sums in another order than cuDNN
LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

pytestmark = pytest.mark.chip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is "
                    "False); the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False        # f32 yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def ragged_ids(rng, B, S, vocab):
    ids = rng.integers(1, vocab, (B, S))
    lens = rng.integers(1, S + 1, (B,))
    ids[np.arange(S)[None, :] >= lens[:, None]] = 0
    ids[0] = 0                                    # one all-PAD row
    return ids.astype(np.int32)


def seeded_params(cfg, heads, seed):
    """Seeded params with the embedding scaled x100 (outputs reach a few
    tenths at COSTMODEL_BASE widths) and every bias drawn nonzero
    (conv_init zeroes them), so a kernel that drops a bias or pads with
    relu(bias) fails the 2e-4 limit."""
    g = torch.Generator().manual_seed(seed)
    p = P.conv_init(cfg, heads, generator=g)
    p["emb"] = p["emb"] * 100.0
    for lyr in [*p["convs"], *p["fc"], *p.get("heads", {}).values()]:
        lyr["b"] = torch.randn(lyr["b"].shape, generator=g) * 0.1
    return p


def seeded_lstm_params(cfg, heads, seed):
    """Seeded LSTM params with the embedding scaled x50 (input gates of
    about unit size) and the gate and head biases drawn nonzero."""
    g = torch.Generator().manual_seed(seed)
    p = P.lstm_init(cfg, heads, generator=g)
    p["emb"] = p["emb"] * 50.0
    p["b"] = torch.randn(p["b"].shape, generator=g) * 0.1
    for lyr in (p["heads"].values() if heads else [p["head"]]):
        lyr["b"] = torch.randn(lyr["b"].shape, generator=g) * 0.1
    return p


def card_params(cfg, heads, device, dtype=None, seed=0):
    return P.from_numpy(seeded_params(cfg, heads, seed), device, dtype)


def _columns(out, heads):
    return torch.stack([out[t] for t in heads], 1) if heads else out


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("heads", [None, DEFAULT_HEADS])
@pytest.mark.parametrize("cfg_name,S", [("COSTMODEL_BASE", 256),
                                        ("COSTMODEL_BASE", 160),
                                        ("COSTMODEL_BASE", 32),
                                        ("COSTMODEL_OPERAND", 1024)])
def test_kernel_matches_plain(cuda, cfg_name, S, heads, dtype):
    """Both filter mixes (OPERAND's S=1024 needs several tiles with
    halos; S=160, the serve CLI's longest bucket, ends in a short tile),
    both head layouts; bf16 params against the plain version on the
    same params widened to f32."""
    cfg = getattr(CFGS, cfg_name)
    pt = card_params(cfg, heads, cuda, dtype)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(S), 5, S,
                                      cfg.vocab_size)).to(cuda)
    before = K.conv_forward_fused.launches
    got = _columns(ops.conv_forward_apply(pt, ids), heads)
    want = _columns(REF.conv_forward_ref(pt, ids), heads)
    torch.cuda.synchronize()
    assert K.conv_forward_fused.launches == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_rows_bit_identical_across_ladder(cuda):
    """Each row, at another position in a batch of every ladder size, has
    the same bits (row 0 of the full batch is all PAD, so B=1 holds a
    real row)."""
    cfg = CFGS.COSTMODEL_BASE
    pt = card_params(cfg, DEFAULT_HEADS, cuda, seed=1)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(2), 65, 256,
                                      cfg.vocab_size)).to(cuda)
    full = ops.conv_forward_apply(pt, ids)
    for b in LADDER:
        part = ops.conv_forward_apply(pt, ids[1:b + 1].contiguous())
        for t in DEFAULT_HEADS:
            assert torch.equal(part[t], full[t][1:b + 1]), (b, t)


def test_out_of_range_id_raises_on_card(cuda):
    cfg = CFGS.COSTMODEL_BASE
    pt = card_params(cfg, DEFAULT_HEADS, cuda)
    ids = torch.zeros((2, 32), dtype=torch.int32, device=cuda)
    ids[1, 3] = cfg.vocab_size
    with pytest.raises(ValueError, match="token ids"):
        ops.conv_forward_apply(pt, ids)


@pytest.mark.parametrize("bad", [-1, 8192, 1 << 30])
def test_unchecked_out_of_range_id_reads_as_pad(cuda, bad):
    """check_ids=False (the service checks on the host): the kernel
    reads an id outside the table as PAD and never outside the table."""
    cfg = CFGS.COSTMODEL_BASE
    pt = card_params(cfg, DEFAULT_HEADS, cuda)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(5), 3, 32,
                                      cfg.vocab_size)).to(cuda)
    want = ops.conv_forward_apply(pt, ids)
    ids[1, 0], ids[2, 31] = bad, bad
    pad = ids.clone()
    pad[1, 0], pad[2, 31] = 0, 0
    got = ops.conv_forward_apply(pt, ids, check_ids=False)
    torch.cuda.synchronize()
    for t in DEFAULT_HEADS:
        assert torch.equal(got[t], ops.conv_forward_apply(pt, pad)[t]), t
    assert torch.equal(got[DEFAULT_HEADS[0]][0], want[DEFAULT_HEADS[0]][0])


def _halo(filters):
    return sum((f - 1) // 2 + f // 2 for f in filters)


def _assert_plan_rules(plan_at, S, halo):
    """The rules of csrc/conv_tile.cuh's tile_plan: tiles of at least
    twice the halo (or all of S), n_tiles covering S, one block a tile,
    shared memory within 227 KB; more tiles a row at small B, and a
    batch of 64 spread over at least two blocks an SM."""
    plans = {B: plan_at(B) for B in (1, 4, 64, 256)}
    for B, p in plans.items():
        assert p["tile"] >= min(2 * halo, S), (B, p)
        assert p["n_tiles"] == -(-S // p["tile"]), (B, p)
        assert p["blocks"] == B * p["n_tiles"], (B, p)
        assert 0 < p["smem"] <= 232448, (B, p)
        assert p["workspace"] >= B * p["n_tiles"] * 4, (B, p)
    return plans


def test_plan_tile(cuda):
    """The tile plan of csrc/conv_forward.cu (conv_tile.cuh's rules):
    a COSTMODEL_BASE row over more tiles at B=1 than at B=64, whose 5
    tiles a row fill 2 x 132 SMs; the operand mix at S=1024 in tiles of
    at least twice its halo of 45; a ValueError at COSTMODEL_100M's 1024
    channels."""
    base, op = CFGS.COSTMODEL_BASE, CFGS.COSTMODEL_OPERAND
    plans = _assert_plan_rules(lambda B: K.plan(
        B, 256, base.embed_dim, base.conv_filters, base.conv_channels,
        base.fc_dims), 256, _halo(base.conv_filters))
    assert plans[1]["n_tiles"] > plans[64]["n_tiles"] > 1
    assert plans[64]["blocks"] >= 2 * 132
    ops_plans = _assert_plan_rules(lambda B: K.plan(
        B, 1024, op.embed_dim, op.conv_filters, op.conv_channels,
        op.fc_dims), 1024, _halo(op.conv_filters))
    assert ops_plans[1]["tile"] >= 90 and ops_plans[1]["n_tiles"] > 1
    big = CFGS.COSTMODEL_100M
    with pytest.raises(ValueError, match="shared memory"):
        K.plan(1, 1024, big.embed_dim, big.conv_filters, big.conv_channels,
               big.fc_dims)


def test_wrapper_rejects_too_many_layers_on_card(cuda):
    pt = card_params(CFGS.COSTMODEL_SMALL, DEFAULT_HEADS, cuda)
    args = list(ops.fused_args(pt)[0])
    args[1], args[2] = args[1] * 2, args[2] * 2
    ids = torch.ones((2, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="kMaxConv"):
        K.conv_forward_fused(ids, *args)


# ------------------------------------------------------ LSTM recurrence
def _scan_inputs(device, B, S, H, dtype, seed=0):
    """Random gates, a random mask with row 0 all masked (when B > 1),
    and a wh of the reference test's scale (H <= 16) or 1/sqrt(H)."""
    rng = np.random.default_rng(seed)
    xw = torch.tensor(rng.normal(size=(B, S, 4 * H)) * 0.5, dtype=dtype,
                      device=device)
    mask = torch.from_numpy((rng.random((B, S)) < 0.8).astype(np.float32))
    if B > 1:
        mask[0] = 0.0
    scale = 0.3 if H <= 16 else H ** -0.5
    wh = torch.tensor(rng.normal(size=(H, 4 * H)) * scale, dtype=dtype,
                      device=device)
    return xw, mask.to(device), wh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H", [(1, 16, 8), (5, 32, 16), (8, 64, 16),
                                   (1, 256, 128), (5, 32, 128),
                                   (64, 256, 128), (256, 48, 128)])
def test_lstm_kernel_matches_plain(cuda, B, S, H, dtype):
    """The reference's test shapes (f32 within its 1e-5) and
    COSTMODEL_BASE's H=128 (2e-4), up to the service's max_batch of 256
    (several waves of clusters); bf16 against the plain version on the
    same bf16 values; the all-PAD row is exactly 0."""
    xw, mask, wh = _scan_inputs(cuda, B, S, H, dtype)
    before = K2.lstm_scan_fused.launches
    got = K2.lstm_scan_fused(xw, mask, wh)
    want = REF.lstm_scan_ref(xw, mask, wh)
    torch.cuda.synchronize()
    assert K2.lstm_scan_fused.launches == before + 1
    tol = 1e-5 if H <= 16 and dtype == torch.float32 else TOL
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert B == 1 or not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [16, 33, 64, 65, 119, 128])
def test_lstm_ids_kernel_matches_plain(cuda, H, dtype):
    """The ids entry with stacked heads against its plain version, at
    one-block plans (H <= 64, odd H) and 2-block cluster plans (at H=65
    block 1 has a whole warp of idle lanes); the two entries give the
    same bits on the same gates."""
    rng = np.random.default_rng(H)
    V, B, S = 200, 9, 40
    table = torch.tensor(rng.normal(size=(V, 4 * H)) * 0.5, dtype=dtype,
                         device=cuda)
    wh = torch.tensor(rng.normal(size=(H, 4 * H)) * H ** -0.5, dtype=dtype,
                      device=cuda)
    hw = torch.tensor(rng.normal(size=(H, 3)) * H ** -0.5, dtype=dtype,
                      device=cuda)
    hb = torch.tensor(rng.normal(size=(3,)) * 0.1, dtype=dtype, device=cuda)
    ids = torch.from_numpy(ragged_ids(rng, B, S, V)).to(cuda)
    before = K2.lstm_scan_ids.launches
    got = K2.lstm_scan_ids(table, ids, wh, hw, hb)
    h = K2.lstm_scan_ids(table, ids, wh)
    want = REF.lstm_scan_ids_ref(table, ids, wh, hw, hb)
    torch.cuda.synchronize()
    assert K2.lstm_scan_ids.launches == before + 2
    tol = 1e-5 if H <= 16 and dtype == torch.float32 else TOL
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert not h[0].any()
    xw, mask = table[ids].contiguous(), (ids != 0).float()
    assert torch.equal(got, K2.lstm_scan_fused(xw, mask, wh, hw, hb))
    assert torch.equal(h, K2.lstm_scan_fused(xw, mask, wh))


@pytest.mark.parametrize("bad", [-1, 8192, 1 << 30])
def test_lstm_ids_out_of_range_id_reads_as_pad(cuda, bad):
    """The kernel reads an id outside the table as PAD, never outside
    the table."""
    cfg = CFGS.COSTMODEL_BASE
    pt = P.from_numpy(seeded_lstm_params(cfg, None, 3), cuda)
    table = ops.lstm_xw_table(pt)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(8), 3, 32,
                                      cfg.vocab_size)).to(cuda)
    ids[1, 0], ids[2, 0] = 5, 7                  # rows 1, 2 start real
    bad_ids, pad = ids.clone(), ids.clone()
    bad_ids[1, 0], bad_ids[2, 31] = bad, bad
    pad[1, 0], pad[2, 31] = 0, 0
    got = K2.lstm_scan_ids(table, bad_ids, pt["wh"])
    assert torch.equal(got, K2.lstm_scan_ids(table, pad, pt["wh"]))
    assert not torch.equal(got, K2.lstm_scan_ids(table, ids, pt["wh"]))


def test_lstm_plan(cuda):
    """The plans of csrc/lstm_scan.cu: a 2-block cluster a row at
    COSTMODEL_BASE's H=128 (512 threads, 16 rows of k a lane), one block
    at H <= 64, a ValueError above kMaxHidden."""
    assert K2.plan(128) == {"ctas": 2, "rows": 16, "units": 64,
                            "threads": 512}
    assert K2.plan(119)["ctas"] == 2 and K2.plan(119)["units"] == 60
    assert K2.plan(65) == {"ctas": 2, "rows": 16, "units": 33,
                           "threads": 8 * 36}
    assert K2.plan(64) == {"ctas": 1, "rows": 8, "units": 64,
                           "threads": 512}
    assert K2.plan(33)["threads"] == 8 * 36
    with pytest.raises(ValueError, match="kMaxHidden"):
        K2.plan(K2.max_hidden() + 1)


@pytest.mark.parametrize("heads", [None, DEFAULT_HEADS])
def test_lstm_forward_matches_plain_model(cuda, heads):
    cfg = CFGS.COSTMODEL_BASE
    pt = P.from_numpy(seeded_lstm_params(cfg, heads, 1), cuda)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(7), 16, 256,
                                      cfg.vocab_size)).to(cuda)
    got = _columns(ops.lstm_forward_apply(pt, ids), heads)
    want = _columns(CM.lstm_apply(pt, ids), heads)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_lstm_rows_bit_identical_across_ladder(cuda):
    """Each row, at another position in a batch of every ladder size,
    has the same bits: both kernel entries alone and the forward with its
    projection table and in-kernel heads."""
    cfg = CFGS.COSTMODEL_BASE
    pt = P.from_numpy(seeded_lstm_params(cfg, DEFAULT_HEADS, 2), cuda)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(3), 65, 32,
                                      cfg.vocab_size)).to(cuda)
    full = ops.lstm_forward_apply(pt, ids)
    xw = ops.lstm_xw_table(pt)[ids]
    mask = (ids != 0).float()
    h = K2.lstm_scan_fused(xw, mask, pt["wh"])
    table = ops.lstm_xw_table(pt)
    h_ids = K2.lstm_scan_ids(table, ids, pt["wh"])
    assert torch.equal(h_ids, h)
    for b in LADDER:
        part = ops.lstm_forward_apply(pt, ids[1:b + 1].contiguous())
        for t in DEFAULT_HEADS:
            assert torch.equal(part[t], full[t][1:b + 1]), (b, t)
        assert torch.equal(K2.lstm_scan_fused(
            xw[1:b + 1].contiguous(), mask[1:b + 1].contiguous(),
            pt["wh"]), h[1:b + 1]), b
        assert torch.equal(K2.lstm_scan_ids(
            table, ids[1:b + 1].contiguous(), pt["wh"]), h[1:b + 1]), b


def test_lstm_hidden_above_the_limit_raises(cuda):
    limit = K2.max_hidden()
    assert limit == 128
    xw, mask, wh = _scan_inputs(cuda, 2, 8, limit + 4, torch.float32)
    with pytest.raises(ValueError, match="kMaxHidden"):
        K2.lstm_scan_fused(xw, mask, wh)
    ids = torch.ones((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="kMaxHidden"):
        K2.lstm_scan_ids(xw[0], ids, wh)


# ------------------------------------------------------- tower (masked)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name,S,B", [("COSTMODEL_BASE", 256, 64),
                                          ("COSTMODEL_BASE", 32, 5),
                                          ("COSTMODEL_OPERAND", 1024, 5)])
def test_tower_kernel_matches_plain(cuda, cfg_name, S, B, dtype):
    """The masked tower against conv1d_stack_ref(mask) on the f32-widened
    inputs: f32 within 2e-4, a bf16 output within 2^-7 relative (its
    rounding); the all-masked row pools to 0."""
    cfg = getattr(CFGS, cfg_name)
    pt = card_params(cfg, DEFAULT_HEADS, cuda, dtype)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(S), B, S,
                                      cfg.vocab_size)).to(cuda)
    mask = (ids != 0).float()
    x = pt["emb"][ids] * mask[..., None].to(dtype)
    ws = [lyr["w"] for lyr in pt["convs"]]
    bs = [lyr["b"] for lyr in pt["convs"]]
    before = K.conv1d_stack_fused.launches
    got = K.conv1d_stack_fused(x, ws, bs, mask)
    want = REF.conv1d_stack_ref(x.float(), [w.float() for w in ws],
                                [b.float() for b in bs], mask)
    torch.cuda.synchronize()
    assert K.conv1d_stack_fused.launches == before + 1
    assert got.dtype == dtype
    rtol = TOL if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5)
    assert not got[0].any()


def test_tower_rows_bit_identical_across_ladder(cuda):
    cfg = CFGS.COSTMODEL_BASE
    pt = card_params(cfg, DEFAULT_HEADS, cuda, seed=1)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(4), 65, 256,
                                      cfg.vocab_size)).to(cuda)
    mask = (ids != 0).float()
    x = pt["emb"][ids] * mask[..., None]
    ws = [lyr["w"] for lyr in pt["convs"]]
    bs = [lyr["b"] for lyr in pt["convs"]]
    full = K.conv1d_stack_fused(x, ws, bs, mask)
    for b in LADDER:
        assert torch.equal(K.conv1d_stack_fused(
            x[1:b + 1].contiguous(), ws, bs, mask[1:b + 1].contiguous()),
            full[1:b + 1]), b


def test_tower_apply_matches_plain_path(cuda):
    cfg = CFGS.COSTMODEL_BASE
    pt = card_params(cfg, DEFAULT_HEADS, cuda)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(6), 16, 256,
                                      cfg.vocab_size)).to(cuda)
    got = _columns(ops.conv_tower_apply(pt, ids), DEFAULT_HEADS)
    want = _columns(ops.conv_tower_apply(pt, ids, use_kernel=False),
                    DEFAULT_HEADS)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_tower_plan_tile(cuda):
    base, op = CFGS.COSTMODEL_BASE, CFGS.COSTMODEL_OPERAND
    plans = _assert_plan_rules(lambda B: K.tower_plan(
        B, 256, base.embed_dim, base.conv_filters, base.conv_channels),
        256, _halo(base.conv_filters))
    assert plans[1]["n_tiles"] > plans[64]["n_tiles"] > 1
    _assert_plan_rules(lambda B: K.tower_plan(
        B, 1024, op.embed_dim, op.conv_filters, op.conv_channels), 1024,
        _halo(op.conv_filters))
    big = CFGS.COSTMODEL_100M
    with pytest.raises(ValueError, match="shared memory"):
        K.tower_plan(1, 1024, big.embed_dim, big.conv_filters,
                     big.conv_channels)


def test_rows_bit_identical_at_b1_and_b256(cuda):
    """A row alone (16 tiles of 16 positions) and in a batch of the
    service's max_batch of 256 (5 tiles of 52) has the same bits, through
    K1 and through K3, at every position of a few rows."""
    cfg = CFGS.COSTMODEL_BASE
    pt = card_params(cfg, DEFAULT_HEADS, cuda, seed=2)
    args, _ = ops.fused_args(pt)
    ids = torch.from_numpy(ragged_ids(np.random.default_rng(9), 256, 256,
                                      cfg.vocab_size)).to(cuda)
    mask = (ids != 0).float()
    x = pt["emb"][ids] * mask[..., None]
    ws = [lyr["w"] for lyr in pt["convs"]]
    bs = [lyr["b"] for lyr in pt["convs"]]
    full = K.conv_forward_fused(ids, *args)
    tower = K.conv1d_stack_fused(x, ws, bs, mask)
    for r in (1, 2, 100, 255):
        assert torch.equal(K.conv_forward_fused(ids[r:r + 1], *args),
                           full[r:r + 1]), r
        assert torch.equal(K.conv1d_stack_fused(
            x[r:r + 1], ws, bs, mask[r:r + 1]), tower[r:r + 1]), r


def test_two_streams_at_once_give_plain_rows(cuda):
    """K1 launched on two streams at once, each with its own workspace
    and row counters, gives the plain version's rows on both."""
    cfg = CFGS.COSTMODEL_BASE
    pt = card_params(cfg, DEFAULT_HEADS, cuda, seed=3)
    args, _ = ops.fused_args(pt)
    rng = np.random.default_rng(10)
    batches = [torch.from_numpy(ragged_ids(rng, B, 256, cfg.vocab_size))
               .to(cuda) for B in (4, 64)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in batches]
    outs = []
    for _ in range(20):
        for st, ids in zip(streams, batches):
            with torch.cuda.stream(st):
                outs.append(K.conv_forward_fused(ids, *args,
                                                 check_ids=False))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        want = REF.conv_forward_fused_ref(batches[i % 2], *args)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.fixture
def corpus():
    rng = np.random.default_rng(3)
    graphs = [samplers.sample_graph(rng) for _ in range(48)]
    vocab = TOK.fit_vocab([TOK.graph_tokens(g, "ops") for g in graphs],
                          max_size=8192)
    return graphs, vocab


SEEDED = {"conv1d": seeded_params, "lstm": seeded_lstm_params}
KERNEL = {"conv1d": K.conv_forward_fused, "lstm": K2.lstm_scan_ids}


def _service(vocab, device, kind="conv1d", **kw):
    cfg = CFGS.COSTMODEL_BASE
    params = SEEDED[kind](cfg, DEFAULT_HEADS, seed=4)
    stats = {t: {"mu": 0.3, "sigma": 1.7} for t in DEFAULT_HEADS}
    kw.setdefault("max_batch", 16)
    return CostModelService(kind, cfg, params, vocab, stats,
                            mode="ops", max_seq=256, device=device, **kw)


@pytest.mark.parametrize("kind", ["conv1d", "lstm"])
def test_service_on_card_matches_cpu(cuda, corpus, kind):
    graphs, vocab = corpus
    want = _service(vocab, "cpu", kind).predict_all(graphs)
    before = KERNEL[kind].launches
    got = _service(vocab, None, kind, use_kernel=True).predict_all(graphs)
    assert KERNEL[kind].launches > before
    for t in DEFAULT_HEADS:
        np.testing.assert_allclose(got[t], want[t], rtol=TOL, atol=TOL)
    b16 = _service(vocab, None, kind, use_kernel=True,
                   dtype="bf16").predict_all(graphs)
    for t in DEFAULT_HEADS:
        r_a = np.argsort(np.argsort(want[t]))
        r_b = np.argsort(np.argsort(b16[t]))
        assert np.corrcoef(r_a, r_b)[0, 1] >= 0.99, t


@pytest.mark.parametrize("kind", ["conv1d", "lstm"])
def test_server_bit_identical_to_direct_on_card(cuda, corpus, kind):
    """Coalesced server batches reproduce direct predict_all bit for bit:
    each row is computed by its own thread block (the LSTM's projection
    is a gather and its heads run in the kernel)."""
    graphs, vocab = corpus
    want = _service(vocab, None, kind, use_kernel=True).predict_all(graphs)
    served = _service(vocab, None, kind, use_kernel=True)
    results, lock = {}, threading.Lock()
    with CostModelServer(served, max_batch=16, flush_us=1000) as server:
        def client(idxs):
            for i in idxs:
                out = server.predict_all([graphs[i]])
                with lock:
                    results[i] = out
        threads = [threading.Thread(target=client,
                                    args=(range(k, len(graphs), 6),))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert set(results) == set(range(len(graphs)))
    for i in range(len(graphs)):
        for t in DEFAULT_HEADS:
            assert results[i][t][0] == want[t][i], (i, t)


def test_predict_text_through_kernel_matches_plain_card_service(cuda,
                                                               corpus):
    """The front door on the card: printer texts and the affine example
    through predict_text of the K1 service are TextPredictions whose
    rows lie within TOL of the plain card service's, K1 launched once a
    forward batch; fuzzed texts never fail at the predict stage."""
    graphs, vocab = corpus
    texts = [printer.to_mlir(g) for g in graphs[:16]] + [FD.AFFINE_EXAMPLE]
    kern = _service(vocab, None, use_kernel=True)
    plain = _service(vocab, None)
    launches = []
    for text in texts:
        before = K.conv_forward_fused.launches
        got = kern.predict_text(text)
        launches.append(K.conv_forward_fused.launches - before)
        want = plain.predict_text(text)
        assert isinstance(got, FD.TextPrediction), got
        assert isinstance(want, FD.TextPrediction), want
        assert got.key == want.key
    assert all(n <= 1 for n in launches) and sum(launches) > 0
    entries = [(e.key, e.ids) for e in map(kern.ingest_text, texts)]
    np.testing.assert_allclose(kern.predict_entries(entries),
                               plain.predict_entries(entries),
                               rtol=TOL, atol=TOL)
    fuzz = FD.fuzz_corpus(texts[:4] + [FD.AFFINE_EXAMPLE], 60,
                          np.random.default_rng(5))
    for text in fuzz:
        out = kern.predict_text(text)
        assert not (isinstance(out, FD.IngestError)
                    and out.stage == "predict"), out


# ------------------------------------------------ TF32 and training (F1)
# One loss's gradients, card against CPU, as the relative L2 distance of
# all leaves together, on the dataset's rows: both float32 sum in other
# orders (measured 5.1e-7), TF32 convolutions land 6.0e-4 off. A ReLU
# input within rounding of 0 opens its gate on one side only, whatever
# the precision (random tokens at COSTMODEL_BASE did that: 1.5e-3), so
# the check runs on the dataset's rows, as training does.
GRAD_RTOL = 1e-4


@pytest.fixture
def torch_default_tf32(cuda):
    """The TF32 switches as torch leaves them (cuDNN's on, matmul's off)
    for one test, then back to the f32 yardsticks'."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def tf32_conv1d(x, w, b):
    """models.conv1d without its precision guard: cuDNN under the
    process's switches (the plain path as it was before the repair)."""
    fs = w.shape[0]
    xc = torch.nn.functional.pad(x.transpose(1, 2),
                                 ((fs - 1) // 2, fs // 2))
    out = torch.nn.functional.conv1d(xc, w.permute(2, 1, 0))
    return out.transpose(1, 2) + b


def grad_distance(a, b) -> float:
    fa = [x.double().cpu() for x in P.tree_flatten(a)]
    fb = [x.double().cpu() for x in P.tree_flatten(b)]
    num = sum(float(((x - y) ** 2).sum()) for x, y in zip(fa, fb))
    den = sum(float((y ** 2).sum()) for y in fb)
    return (num / den) ** 0.5


def test_default_card_service_matches_cpu_with_tf32_at_defaults(
        torch_default_tf32, corpus):
    """A default-constructed service (plain path, no kernel) on the card
    with torch's own TF32 switches: within 2e-4 of the CPU service. Its
    rows do not keep their bits across batch packing (cuDNN and cuBLAS
    pick their algorithms by shape; the service's docstring says so):
    a row forwarded alone is held to the same row in a full batch
    within 2e-4 only."""
    graphs, vocab = corpus
    want = _service(vocab, "cpu").predict_all(graphs)
    card = _service(vocab, None)
    assert not card.use_kernel
    got = card.predict_all(graphs)
    for t in DEFAULT_HEADS:
        np.testing.assert_allclose(got[t], want[t], rtol=TOL, atol=TOL)
    assert torch.backends.cudnn.allow_tf32     # the guard gave them back
    entries = [card.entry(g) for g in graphs]
    by_len = {}
    for e in entries:
        by_len.setdefault(len(e[1]), []).append(e)
    for group in by_len.values():
        batch = card.forward_entries(group)
        alone = np.stack([card.forward_entries([e])[0] for e in group])
        np.testing.assert_allclose(alone, batch, rtol=TOL, atol=TOL)


def test_train_gradients_on_card_match_cpu_with_tf32_at_defaults(
        torch_default_tf32):
    """One multi-head loss's gradients at COSTMODEL_BASE with torch's
    TF32 switches: the card within GRAD_RTOL of the CPU; the plain conv
    without its guard (TF32 forward and backward) misses it."""
    cfg = CFGS.COSTMODEL_BASE
    params = seeded_params(cfg, DEFAULT_HEADS, 0)
    tr, _ = DS.build_dataset(300, mode="ops", max_seq=256, vocab_size=8192,
                             seed=0).split(0.1)
    rows = slice(64, 128)          # chip_smoke.py checks rows 0-63
    ids = torch.from_numpy(tr.ids[rows])
    y, _ = DS.stacked_normalized_targets(
        {t: v[rows] for t, v in tr.targets.items()}, DEFAULT_HEADS)
    y = torch.from_numpy(y)
    loss_fn = TR.make_loss_fn(CM.conv_apply, DEFAULT_HEADS)
    _, want = TR.value_and_grad(loss_fn, P.from_numpy(params, "cpu"), ids, y)

    def on_card():
        return TR.value_and_grad(loss_fn, P.from_numpy(params, "cuda"),
                                 ids.cuda(), y.cuda())[1]
    got = grad_distance(on_card(), want)
    with mock.patch.object(CM, "conv1d", tf32_conv1d):
        tf32 = grad_distance(on_card(), want)
    assert got <= GRAD_RTOL, got
    assert tf32 > GRAD_RTOL, tf32


def test_engine_resume_on_card_is_exact(cuda, tmp_path):
    """Kill and resume on the card under deterministic algorithms lands
    on the uninterrupted run's params (the reference test's limits)."""
    tr, _ = DS.build_dataset(300, mode="ops", max_seq=96, vocab_size=512,
                             augment_factor=2, seed=1).split(0.1)
    kw = dict(steps=40, batch_size=32, seed=3, device="cuda")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        full = TR.TrainEngine("conv1d", CFGS.COSTMODEL_SMALL, DEFAULT_HEADS,
                              **kw).fit(tr)

        class Kill(Exception):
            pass

        def killer(step, dt):
            if step == 17:
                raise Kill()
        d = str(tmp_path / "ck")
        with pytest.raises(Kill):
            TR.TrainEngine("conv1d", CFGS.COSTMODEL_SMALL, DEFAULT_HEADS,
                           ckpt_dir=d, save_every=10, **kw).fit(
                               tr, on_step=killer)
        resumed = TR.TrainEngine("conv1d", CFGS.COSTMODEL_SMALL,
                                 DEFAULT_HEADS, ckpt_dir=d, save_every=10,
                                 **kw).fit(tr)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert resumed.stats["steps"] == 30.0
    for a, b in zip(P.tree_flatten(full.params),
                    P.tree_flatten(resumed.params)):
        assert b.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------------ the graphed training step
@functools.lru_cache(maxsize=None)
def smoke():
    """``chip_smoke.py`` as a module."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def two_width_corpus(n_each=1024, vocab=8192, seed=0):
    """``n_each`` rows of 4-20 tokens and ``n_each`` of 24-50 (buckets
    32 and 64 at COSTMODEL_BASE's pad slack of 12), ids drawn from the
    vocabulary, three positive targets: at B=512 the homogeneous loader
    gives two batches of each width an epoch."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([rng.integers(4, 21, n_each),
                           rng.integers(24, 51, n_each)]).astype(np.int32)
    ids = rng.integers(1, vocab, (2 * n_each, 64)).astype(np.int32)
    ids[np.arange(64)[None, :] >= lens[:, None]] = 0
    targets = {t: np.exp(rng.normal(2.0, 0.5, 2 * n_each)).astype(
        np.float32) for t in DEFAULT_HEADS}
    return DS.CostDataset(ids=ids, targets=targets,
                          vocab=TOK.Vocab({"<pad>": 0}), mode="ops",
                          max_seq=64, seq_lens=lens)


def small_corpus():
    tr, _ = DS.build_dataset(300, mode="ops", max_seq=96, vocab_size=512,
                             augment_factor=2, seed=1).split(0.1)
    return tr


# (kind, config, batch, engine options, corpus): conv1d at the cell's
# B=512 over two widths, the other families and compression small
GRAPH_CASES = {
    "conv1d-b512": ("conv1d", CFGS.COSTMODEL_BASE, 512,
                    {"bucket_mode": "homogeneous"}, two_width_corpus),
    "conv1d-compress": ("conv1d", CFGS.COSTMODEL_SMALL, 32,
                        {"compress_grads": True}, small_corpus),
    "fc": ("fc", CFGS.COSTMODEL_SMALL, 32, {}, small_corpus),
    "lstm": ("lstm", CFGS.COSTMODEL_SMALL, 32, {}, small_corpus),
    "xformer": ("xformer", dataclasses.replace(CFGS.COSTMODEL_SMALL,
                                               max_seq=96), 32, {},
                small_corpus),
}


@pytest.fixture
def deterministic(cuda):
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield cuda
    torch.use_deterministic_algorithms(prev)


def eager_sgd_loop(engine, train, steps):
    """``chip_smoke.py``'s eager loop of ``make_sgd_step`` over the
    engine's batches: (params, opt state, error state, losses, shapes)."""
    return smoke().eager_sgd_loop(engine, train, steps)


def graphed_flags(shapes):
    """Which steps a graph runs: each shape's steps after its first
    ``WARMUP``."""
    seen = {}
    out = []
    for s in shapes:
        seen[s] = seen.get(s, 0) + 1
        out.append(seen[s] > TR._StepGraphs.WARMUP)
    return out


def assert_same_bits(got, want):
    got, want = P.tree_flatten(got), P.tree_flatten(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graphed_fit_is_the_eager_loop_bit_for_bit(deterministic, case,
                                                   tmp_path):
    """Under deterministic algorithms, 20 steps of a fit on the card
    (eager warm-ups, then a CUDA graph a batch shape) and 20 eager
    ``make_sgd_step`` steps over the same batches give the same bits:
    params, both moments, the count, the error state and every loss;
    every step after a shape's third is tagged ``graphed``."""
    kind, cfg, batch, opts, corpus = GRAPH_CASES[case]
    train = corpus()
    tracer = OBS.Tracer(sample_every=1, proc="trainer")
    engine = TR.TrainEngine(kind, cfg, DEFAULT_HEADS, steps=20,
                            batch_size=batch, seed=4, log_every=1,
                            device="cuda", ckpt_dir=str(tmp_path),
                            tracer=tracer, **opts)
    got = engine.fit(train)
    params, state, err, losses, shapes = eager_sgd_loop(engine, train, 20)
    if case == "conv1d-b512":
        assert sorted(set(shapes)) == [(512, 32), (512, 64)]
    flags = graphed_flags(shapes)
    assert sum(flags) >= 10
    saved, step, _ = ckpt.restore(str(tmp_path), (params, state, err))
    assert step == 20
    assert [v for _, v in got.history] == losses
    assert_same_bits(got.params, params)
    assert_same_bits(saved, (params, state, err))
    tags = [s["tags"] for s in tracer.recorder.snapshot()
            if s["name"] == "trainer.step"]
    assert [t["graphed"] for t in tags] == flags


def test_a_replayed_step_makes_the_host_wait_for_nothing(deterministic):
    """Every graph replay of a conv1d fit at B=512 over two widths runs
    under ``set_sync_debug_mode("error")``: 14 of its 20 steps."""
    real = torch.cuda.CUDAGraph.replay
    calls = []

    def replay(graph):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(graph)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(1)
    with mock.patch.object(torch.cuda.CUDAGraph, "replay", replay):
        result = TR.TrainEngine("conv1d", CFGS.COSTMODEL_BASE,
                                DEFAULT_HEADS, steps=20, batch_size=512,
                                device="cuda", bucket_mode="homogeneous"
                                ).fit(two_width_corpus())
    assert len(calls) == 14 and np.isfinite(result.stats["final_loss"])


def test_graphed_resume_from_a_checkpoint_is_bit_exact(deterministic,
                                                       tmp_path):
    """A graphed run killed at step 17 and resumed from its step-10
    checkpoint (new graphs, captured after the restore) lands on the
    uninterrupted run's params bit for bit."""
    train = small_corpus()
    kw = dict(steps=40, batch_size=32, seed=3, device="cuda")
    full = TR.TrainEngine("conv1d", CFGS.COSTMODEL_SMALL, DEFAULT_HEADS,
                          **kw).fit(train)

    class Kill(Exception):
        pass

    def killer(step, dt):
        if step == 17:
            raise Kill()
    d = str(tmp_path / "ck")
    with pytest.raises(Kill):
        TR.TrainEngine("conv1d", CFGS.COSTMODEL_SMALL, DEFAULT_HEADS,
                       ckpt_dir=d, save_every=10, **kw).fit(
                           train, on_step=killer)
    resumed = TR.TrainEngine("conv1d", CFGS.COSTMODEL_SMALL, DEFAULT_HEADS,
                             ckpt_dir=d, save_every=10, **kw).fit(train)
    assert resumed.stats["steps"] == 30.0
    assert_same_bits(resumed.params, full.params)


def test_graphs_captured_under_a_cuda_profiler_give_the_same_bits(
        deterministic):
    """A fit whose captures happen while a CUDA profiler records (as in
    a traced benchmark window or ``chip_smoke.py``'s profiled steps)
    lands on the unprofiled fit's params, and the profiler sees the
    replayed graphs' kernels."""
    from torch.profiler import ProfilerActivity, profile
    train = small_corpus()
    kw = dict(steps=12, batch_size=32, seed=5, device="cuda")
    plain = TR.TrainEngine("conv1d", CFGS.COSTMODEL_SMALL, DEFAULT_HEADS,
                           **kw).fit(train)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = TR.TrainEngine("conv1d", CFGS.COSTMODEL_SMALL,
                                DEFAULT_HEADS, **kw).fit(train)
    assert_same_bits(traced.params, plain.params)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in kernels) > 0


def test_graphed_fit_counts_e1_once_a_step(deterministic):
    """E1's host counter over a graphed conv1d fit over two widths: one
    a step, eager or replayed (a replay adds what its capture counted,
    and the capture's own count is taken back)."""
    before = EG.embed_grad.launches
    TR.TrainEngine("conv1d", CFGS.COSTMODEL_BASE, DEFAULT_HEADS, steps=20,
                   batch_size=512, device="cuda", bucket_mode="homogeneous"
                   ).fit(two_width_corpus())
    assert EG.embed_grad.launches - before == 20


# ------------------------------------------- the conv1d lookup's backward
# base-train-b512's shapes: B=512 rows padded to a bucket of the ladder
# (32, 64, 128, 256), the 8,192-id vocabulary, E=64
EG_B, EG_V, EG_E = 512, 8192, 64
EG_CASES = ["pad0", "pad50", "pad95", "hot90", "ragged"]


def lookup_ids(case, S, seed=0):
    """(B, S) int32 ids: uniform with a PAD share of 0, 1/2 or 19/20;
    half PAD with one id in 90% of the rest (an op name that fills the
    batch); or bucketed rows, PAD after each row's length."""
    rng = np.random.default_rng(seed)
    if case == "ragged":
        return torch.from_numpy(ragged_ids(rng, EG_B, S, EG_V))
    pad, hot = {"pad0": (0.0, 0.0), "pad50": (0.5, 0.0),
                "pad95": (0.95, 0.0), "hot90": (0.5, 0.9)}[case]
    ids = rng.integers(1, EG_V, (EG_B, S))
    ids[rng.random(ids.shape) < hot] = 7
    ids[rng.random(ids.shape) < pad] = 0
    return torch.from_numpy(ids.astype(np.int32))


def lookup_grad(ids, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((*ids.shape, EG_E), generator=g).to(dtype)


def exact_sums(grad, ids):
    """Each id's sum of rows in float64 (exact for these counts), its
    row count and its sum of |rows|, PAD's row left empty."""
    flat, rows = ids.reshape(-1).long(), grad.reshape(-1, EG_E).double()
    keep = flat != 0
    zeros = torch.zeros(EG_V, EG_E, dtype=torch.float64)
    count = torch.zeros(EG_V, dtype=torch.float64).index_add_(
        0, flat[keep], torch.ones(int(keep.sum()), dtype=torch.float64))
    return (zeros.clone().index_add_(0, flat[keep], rows[keep]), count,
            zeros.index_add_(0, flat[keep], rows[keep].abs()))


def sum_limit(exact, count, mass, dtype, chain):
    """How far a sum may land from ``exact`` when its longest chain of
    dependent adds is ``chain`` (a (V,) tensor): chain x 2^-23 x the sum
    of |rows| (twice float32's unit roundoff; 2^-52 for float64), and
    for a bfloat16 result one more rounding, 2^-8 of the value."""
    eps = 2.0 ** -52 if dtype == torch.float64 else 2.0 ** -23
    tol = chain[:, None] * eps * mass
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * (exact.abs() + tol)
    return tol


def kernel_chain(count):
    """The kernel's longest chain for an id of ``count`` rows: a chunk of
    EG.CHUNK rows, one group's share of the segment's chunks (4 groups
    a block, a segment over ceil(count / CHUNK) + 1 chunks at most),
    and the join of the 4 groups' sums to the first chunk's."""
    chunks = torch.ceil(count / EG.CHUNK) + 1
    return EG.CHUNK + torch.ceil(chunks / 4) + 5


@pytest.mark.parametrize("case", EG_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("S", [32, 64, 128, 256])
def test_embed_grad_matches_plain(cuda, S, dtype, case):
    """The kernel and the plain version against float64 sums: the
    kernel within its own longest chain of adds (a chunk, a group's
    partials, the join) x eps x the sum of |rows|, the plain version
    (one chain a segment) within count x eps x the same. A sum missing
    one chunk of the most frequent id's rows misses the kernel's limit,
    so a dropped or doubled chunk fails. PAD's row and the rows of
    absent ids are exactly zero."""
    ids = lookup_ids(case, S)
    grad = lookup_grad(ids, dtype)
    got = EG.embed_grad(grad.to(cuda), ids.to(cuda), EG_V).cpu()
    want = EG.embed_grad_ref(grad, ids, EG_V)
    assert got.dtype == dtype and got.shape == (EG_V, EG_E)
    exact, count, mass = exact_sums(grad, ids)
    tol = sum_limit(exact, count, mass, dtype, kernel_chain(count))
    assert bool(((got.double() - exact).abs() <= tol).all())
    plain_tol = sum_limit(exact, count, mass, dtype, count)
    assert bool(((want.double() - exact).abs() <= plain_tol).all())
    assert not got[count == 0].any()
    # the limit can fail: one chunk of the most frequent id left out
    flat = ids.reshape(-1).long()
    top = int(count.argmax())
    pos = (flat == top).nonzero().reshape(-1)[:EG.CHUNK]
    short = exact[top] - grad.reshape(-1, EG_E)[pos].double().sum(0)
    assert not bool(((short - exact[top]).abs() <= tol[top]).all())


def test_embed_grad_same_bits_every_launch_and_stream(cuda):
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        ids = lookup_ids("hot90", 128).to(cuda)
        grad = lookup_grad(ids, dtype).to(cuda)
        first = EG.embed_grad(grad, ids, EG_V)
        assert torch.equal(EG.embed_grad(grad, ids, EG_V), first)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            other = EG.embed_grad(grad, ids, EG_V)
        torch.cuda.current_stream().wait_stream(side)
        assert torch.equal(other, first)


def test_masked_gather_backward_needs_no_sync(cuda):
    """The op's backward, sort and kernel included, under
    set_sync_debug_mode("error"): nothing in it makes the host wait."""
    ids = lookup_ids("ragged", 128).to(cuda)
    table = torch.randn(EG_V, EG_E, device=cuda, requires_grad=True)
    grad = lookup_grad(ids, torch.float32).to(cuda)
    torch.autograd.grad(EG.masked_gather(table, ids), table, grad)  # warm
    out = EG.masked_gather(table, ids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, = torch.autograd.grad(out, table, grad)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, EG.embed_grad(grad, ids, EG_V))


def test_masked_gather_counts_one_launch_a_backward(cuda):
    """The forward launches nothing of the kernel's, each backward one,
    and a conv1d training step on the card goes through it once."""
    ids = lookup_ids("pad50", 64).to(cuda)
    table = torch.randn(EG_V, EG_E, device=cuda, requires_grad=True)
    grad = lookup_grad(ids, torch.float32).to(cuda)
    before = EG.embed_grad.launches
    out = EG.masked_gather(table, ids)
    assert EG.embed_grad.launches == before
    for i in range(3):
        torch.autograd.grad(out, table, grad, retain_graph=True)
        assert EG.embed_grad.launches == before + i + 1
    cfg = CFGS.COSTMODEL_BASE
    params = P.from_numpy(seeded_params(cfg, DEFAULT_HEADS, 0), cuda)
    y = torch.zeros((EG_B, len(DEFAULT_HEADS)), device=cuda)
    loss_fn = TR.make_loss_fn(CM.conv_apply, DEFAULT_HEADS)
    before = EG.embed_grad.launches
    TR.value_and_grad(loss_fn, params, ids, y)
    assert EG.embed_grad.launches == before + 1


# ------------------------------------------------- the replicated tier
def _tier_world(cfg, n_graphs):
    """Seeded graphs, their vocab, and a K1 card service over seeded
    params (biases nonzero), max_batch 16."""
    rng = np.random.default_rng(5)
    graphs = [samplers.sample_graph(rng) for _ in range(n_graphs)]
    vocab = TOK.fit_vocab([TOK.graph_tokens(g, "ops") for g in graphs],
                          max_size=cfg.vocab_size)
    stats = {t: {"mu": 0.2, "sigma": 1.3} for t in DEFAULT_HEADS}
    svc = CostModelService("conv1d", cfg, seeded_params(cfg, DEFAULT_HEADS,
                                                        0),
                           vocab, stats, mode="ops", max_seq=256,
                           max_batch=16, use_kernel=True)
    return graphs, svc


def test_replicated_k1_tier_on_card(cuda):
    """Two spawned replicas serve through K1 on the card: rows bit for
    bit the direct service's, each replica's stats name the card, no
    replica ran nvcc, and each launched K1 once for each forward batch
    it ran after warm-up."""
    from repro_torch.serving import (ReplicaClient, ServiceSpec,
                                     start_replicas)
    graphs, svc = _tier_world(CFGS.COSTMODEL_BASE, 48)
    want = svc.predict_all(graphs)
    tier = start_replicas(ServiceSpec.from_service(svc), 2, n_clients=1,
                          flush_us=300.0, start_timeout_s=120.0)
    try:
        client = ReplicaClient(tier.client_handle(0))
        assert client.fsvc.device == "cpu"
        before = client.replica_stats()
        got = client.predict_all(graphs)
        after = client.replica_stats()
    finally:
        tier.stop()
    for t in want:
        np.testing.assert_array_equal(got[t], want[t])
    name = torch.cuda.get_device_name(0)
    batches = 0
    for b, a in zip(before, after):
        assert a["device"] == {"type": "cuda", "name": name}
        assert a["nvcc_runs"] == 0
        launched = a["kernel_launches"]["conv_forward_fused"] - \
            b["kernel_launches"]["conv_forward_fused"]
        ran = a["forward_batches"] - b["forward_batches"]
        assert launched == ran
        batches += ran
    assert batches > 0
    assert client.fsvc.forward_batches == 0


def test_start_replicas_builds_kernels_before_spawning(cuda, tmp_path,
                                                       monkeypatch):
    """With an empty build directory, start_replicas builds K1's library
    in the parent before the first child starts; the children only load
    it."""
    from repro_torch.kernels import _build
    from repro_torch.serving import (ReplicaClient, ServiceSpec,
                                     start_replicas)
    from repro_torch.serving.replica import ReplicaTier
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "compiled", [])
    built_at_spawn = []
    spawn = ReplicaTier.spawn

    def watched(self, i):
        built_at_spawn.append(_build.library_path(K.LIB).exists())
        return spawn(self, i)
    monkeypatch.setattr(ReplicaTier, "spawn", watched)
    _, svc = _tier_world(CFGS.COSTMODEL_SMALL, 8)
    assert not _build.library_path(K.LIB).exists()
    tier = start_replicas(ServiceSpec.from_service(svc), 2, n_clients=1,
                          start_timeout_s=120.0)
    try:
        stats = ReplicaClient(tier.client_handle(0)).replica_stats()
    finally:
        tier.stop()
    assert built_at_spawn == [True, True]
    assert _build.compiled == [K.LIB]
    assert [s["nvcc_runs"] for s in stats] == [0, 0]


# ------------------------------------------------ the FC and transformer
def seeded_family_params(kind, cfg, heads, seed):
    """``chip_smoke.py``'s seeded FC or transformer params: the embedding
    x20, every bias, the position table and the LayerNorm gains drawn."""
    return smoke().seeded_family_params(kind, cfg, heads, seed)


@pytest.mark.parametrize("kind", ["fc", "xformer"])
def test_family_card_forward_matches_cpu(cuda, kind):
    """The plain forward on the card within 2e-4 of the CPU's with
    torch's default precision switches, both head layouts, ragged ids
    and an all-PAD row that stays finite; bf16 params give bf16 heads."""
    cfg = CFGS.COSTMODEL_BASE
    apply = CM.get_model(kind)[1]
    rng = np.random.default_rng(8)
    torch.backends.cudnn.allow_tf32 = True        # torch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for heads in (None, DEFAULT_HEADS):
            p = seeded_family_params(kind, cfg, heads, seed=5)
            for S, B in ((32, 5), (256, 64)):
                ids = ragged_ids(rng, B, S, cfg.vocab_size)
                with torch.inference_mode():
                    got = apply(P.from_numpy(p, cuda),
                                torch.from_numpy(ids).to(cuda))
                    want = apply(P.from_numpy(p, "cpu"),
                                 torch.from_numpy(ids))
                got = _columns(got, heads).cpu()
                assert torch.isfinite(got).all()
                torch.testing.assert_close(got, _columns(want, heads),
                                           rtol=TOL, atol=TOL)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        out = apply(P.from_numpy(p, cuda, torch.bfloat16),
                    torch.from_numpy(ids).to(cuda))
    assert all(out[t].dtype == torch.bfloat16 for t in DEFAULT_HEADS)


# the ingest CLI's conv1d: embedding 32, 3 layers of 32 channels, FC 64
INGEST_CFG = CFGS.CostModelConfig(name="ingest", vocab_size=2048,
                                  max_seq=192, embed_dim=32,
                                  conv_channels=(32,) * 3, fc_dims=(64,))


@pytest.mark.parametrize("heads", [None, DEFAULT_HEADS])
@pytest.mark.parametrize("S", [32, 64, 128, 192])
def test_kernel_matches_plain_at_ingest_widths(cuda, S, heads):
    """The ingest CLI's widths at each of its buckets; S=192 is no
    power of two, so its last tile is short."""
    pt = card_params(INGEST_CFG, heads, cuda)
    for B in (1, 5, 64):
        ids = torch.from_numpy(ragged_ids(np.random.default_rng(S + B), B,
                                          S, INGEST_CFG.vocab_size)).to(cuda)
        got = _columns(ops.conv_forward_apply(pt, ids), heads)
        want = _columns(REF.conv_forward_ref(pt, ids), heads)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_ingest_cli_on_card_launches_once_a_shape_and_batch(cuda, capsys):
    """``launch.ingest --kernel`` on the card: every arch text predicts
    with no unk, and K1 launches once a warm-up shape and once a forward
    batch of its service."""
    from repro_torch.launch import ingest
    before = K.conv_forward_fused.launches
    out = ingest.main(["--arch", "qwen3-0.6b,granite-moe-1b-a400m",
                       "--train-steps", "20", "--fuzz", "20", "--kernel"])
    svc = out["service"]
    assert svc.use_kernel and str(svc.device or "cuda").startswith("cuda")
    assert len(out["arch_rows"]) == 9 and out["fuzz"]["uncaught"] == 0
    assert all(isinstance(r, FD.TextPrediction) and r.unk_rate == 0.0
               for *_, r in out["arch_rows"])
    assert svc.warmup_shapes > 0 and svc.forward_batches > 0
    assert K.conv_forward_fused.launches - before == \
        svc.warmup_shapes + svc.forward_batches
    assert "0 uncaught exceptions" in capsys.readouterr().out


# ------------------------------------------------------------ LLM substrate
def lm_numpy_batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["patch_embeds"] = (rng.normal(size=(
            B, cfg.vision_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.frontend == "audio":
        b["frame_embeds"] = (rng.normal(size=(
            B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return b


def test_lm_full_width_qwen3_train_step_on_card(cuda):
    """qwen3-0.6b at its published widths: one train step (f32 master
    weights, bf16 compute, remat, the chunked fused loss) is finite and
    moves every param."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as MODEL
    from repro_torch.models import steps as STEPS
    from repro_torch.optim import adamw
    cfg = get_arch("qwen3-0.6b")
    with cuda:
        params = MODEL.init_params(torch.Generator(cuda).manual_seed(0),
                                   cfg)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in
             lm_numpy_batch(cfg, 2, 256).items()}
    step = STEPS.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    new, state, m = step(params, adamw.init_state(params), batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert 11.0 < float(m["loss"]) < 13.0        # ~ln(151936) at init
    for a, b in zip(P.tree_flatten(params), P.tree_flatten(new)):
        assert bool(torch.isfinite(b).all()) and not torch.equal(a, b)


@pytest.mark.parametrize("name", [
    "granite-moe-1b-a400m", "jamba-v0.1-52b", "llava-next-34b",
    "phi3.5-moe-42b-a6.6b", "qwen1.5-32b", "qwen3-0.6b", "qwen3-1.7b",
    "starcoder2-3b", "whisper-small", "xlstm-125m"])
def test_lm_reduced_arch_card_matches_cpu(cuda, name):
    """Each registered arch, reduced, on the same params (numpy, through
    lm_from_numpy): float32 logits on the card within 1e-4 of the CPU's
    (relative to the largest), the greedy decode tokens of 4 float32
    steps equal, and a bf16 train step finite."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as MODEL
    from repro_torch.models import steps as STEPS
    from repro_torch.optim import adamw
    cfg = get_arch(name).reduced()
    tree = P.to_numpy(MODEL.init_params(torch.Generator().manual_seed(0),
                                        cfg))
    b = lm_numpy_batch(cfg, 2, 16)
    out = {}
    for dev in ("cpu", cuda):
        params = P.lm_from_numpy(tree, cfg, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        with torch.no_grad():
            logits = MODEL.forward(params, cfg, batch, cdt=torch.float32)[0]
        cache = MODEL.init_cache(cfg, 2, 8, kv_dtype=torch.float32,
                                 device=dev)
        tok, toks = batch["tokens"][:, :1], []
        for i in range(4):
            lg, _ = MODEL.decode_forward(params, cfg, tok, cache, i,
                                         cdt=torch.float32)
            tok = STEPS.next_token(lg, cfg.vocab)
            toks.append(tok.cpu())
        out[str(dev)] = (logits.cpu(), torch.cat(toks, 1))
    (lc, tc), (ld, td) = out["cpu"], out[str(cuda)]
    assert float((ld - lc).abs().max() / lc.abs().max()) <= 1e-4
    assert torch.equal(tc, td)
    params = P.lm_from_numpy(tree, cfg, cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
    new, _, m = STEPS.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))(
        params, adamw.init_state(params), batch)
    assert np.isfinite(float(m["loss"]))
    assert all(bool(torch.isfinite(t).all()) for t in P.tree_flatten(new))


def test_lm_rules_step_on_one_rank_nccl_mesh(cuda):
    """The LM steps' ``rules`` paths on a one-rank NCCL mesh (qwen3-0.6b
    reduced): params, state and cache as replicated DTensors; one train
    step and 4 decode steps equal ``rules=None``'s bit for bit (every
    placement on a mesh of one is Replicate: the same ops run)."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_single_device_mesh
    from repro_torch.models import model as MODEL
    from repro_torch.models import steps as STEPS
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as SH
    assert not dist.is_initialized()
    try:
        rules = SH.ShardingRules(make_single_device_mesh())
        assert dist.get_backend() == "nccl"
        cfg = get_arch("qwen3-0.6b").reduced()
        with cuda:
            params = MODEL.init_params(
                torch.Generator(cuda).manual_seed(0), cfg)
        axes = MODEL.param_axes(cfg)
        dp = SH.place_tree(params, SH.tree_shardings(rules, axes, params))
        batch = {k: torch.from_numpy(v).to(cuda) for k, v in
                 lm_numpy_batch(cfg, 2, 32).items()}
        opt_cfg = adamw.AdamWConfig(lr=1e-3)
        state = adamw.init_state(params)
        dstate = SH.place_tree(state, SH.tree_shardings(
            rules, STEPS.opt_state_axes(axes), state))
        p0, _, m0 = STEPS.make_train_step(cfg, opt_cfg)(params, state,
                                                        batch)
        p1, _, m1 = STEPS.make_train_step(cfg, opt_cfg, rules=rules)(
            dp, dstate, batch)
        assert torch.equal(m1["total_loss"], m0["total_loss"])
        for a, b in zip(P.tree_flatten(p1), P.tree_flatten(p0)):
            assert torch.equal(a.full_tensor(), b)
        c0 = MODEL.init_cache(cfg, 2, 8, device=cuda)
        c1 = SH.place_tree(MODEL.init_cache(cfg, 2, 8, device=cuda),
                           SH.tree_shardings(rules, MODEL.cache_axes(cfg),
                                             c0))
        t0 = t1 = batch["tokens"][:, :1]
        d0 = STEPS.make_decode_step(cfg)
        d1 = STEPS.make_decode_step(cfg, rules=rules)
        for i in range(4):
            t0, c0 = d0(params, c0, t0, i)
            t1, c1 = d1(dp, c1, t1, i)
            assert torch.equal(t1.full_tensor(), t0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------- the selective scan (S1, jamba)
def _scan_case(device, B, L, D, N, seed=0):
    """x, dt (softplus of N(-3, 1): ~0.05), A (-exp(log(1..N) + noise)),
    B, C, D (1 + noise) and an output gradient, float32 on ``device``."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    A = -torch.exp(torch.log(torch.arange(1, N + 1.0)).repeat(D, 1)
                   + 0.1 * r(D, N))
    ts = (r(B, L, D), torch.nn.functional.softplus(r(B, L, D) - 3), A,
          r(B, L, N), r(B, L, N), 1 + 0.1 * r(D), r(B, L, D))
    return [t.to(device) for t in ts]


def _scan_and_grads(scan, x, dt, A, Bm, Cm, D, dy):
    """(y, dx, ddt, dA, dB, dC, dD) of ``scan(x, dt, A, B, C, D)``."""
    ts = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    y = scan(*ts)
    return (y.detach(),) + torch.autograd.grad(y, ts, dy)


def _plain_scan(x, dt, A, Bm, Cm, D):
    from repro_torch.models import mamba as MB
    return MB.chunked_scan(x, dt, A, Bm, Cm) + D * x


def _plain_by_channels(case, width=256):
    """The plain scan's outputs and gradients a block of channels at a
    time (channels are independent but for dB and dC, which sum over
    them): the plain scan's autograd holds ~30 (B, 256, channels, N)
    tensors a chunk, too many at the cell's size for all channels."""
    x, dt, A, Bm, Cm, D, dy = case
    outs = [torch.empty_like(x), torch.empty_like(x), torch.empty_like(x),
            torch.empty_like(A), torch.zeros_like(Bm), torch.zeros_like(Cm),
            torch.empty_like(D)]
    for c0 in range(0, x.shape[2], width):
        sl = slice(c0, c0 + width)
        got = _scan_and_grads(_plain_scan, x[..., sl], dt[..., sl], A[sl],
                              Bm, Cm, D[sl], dy[..., sl])
        for i in (0, 1, 2):
            outs[i][..., sl] = got[i]
        outs[3][sl], outs[6][sl] = got[3], got[6]
        outs[4] += got[4]
        outs[5] += got[5]
    return outs


SCAN_NAMES = ("y", "dx", "ddt", "dA", "dB", "dC", "dD")
# float32 both ways; the kernel sums in other orders (a sequential state
# against the chunked log-depth scan; dA and dD over rows and steps, dB
# and dC over channels, each in one fixed order) and takes expf: each
# output within 1e-4 of its largest entry
SCAN_TOL = 1e-4


def _scan_gaps(got, want):
    return {n: float((a - b).abs().max() / b.abs().max())
            for n, a, b in zip(SCAN_NAMES, got, want)}


@pytest.mark.parametrize("B,L,D,N", [
    (2, 100, 96, 16),       # L not a multiple of the 16-step chunk
    (1, 1000, 200, 16),     # one row; the last channel block part-filled
    (3, 257, 70, 8),        # 8 states (the reduced hybrids'), 2 lanes
    (2, 33, 130, 8),        # 3 channel blocks, the last of 2 channels
])
def test_selective_scan_matches_plain(cuda, B, L, D, N):
    from repro_torch.kernels import selective_scan as SS
    case = _scan_case(cuda, B, L, D, N)
    before = SS.selective_scan.launches
    got = _scan_and_grads(SS.selective_scan, *case)
    assert SS.selective_scan.launches - before == 2   # forward, backward
    gaps = _scan_gaps(got, _scan_and_grads(_plain_scan, *case))
    assert max(gaps.values()) <= SCAN_TOL, gaps


@pytest.mark.parametrize("B", [1, 8])
def test_selective_scan_at_the_cells_shapes(cuda, B):
    """jamba2-3b-train-s4096's scan (S 4,096, 5,120 channels, 16 states)
    against the plain scan a block of channels at a time, at the cell's
    B=8 and at B=1; and two launches give the same bits."""
    from repro_torch.kernels import selective_scan as SS
    case = _scan_case(cuda, B, 4096, 5120, 16, seed=B)
    got = _scan_and_grads(SS.selective_scan, *case)
    again = _scan_and_grads(SS.selective_scan, *case)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    gaps = _scan_gaps(got, _plain_by_channels(case))
    print(f"scan B={B} gaps {gaps}")
    assert max(gaps.values()) <= SCAN_TOL, gaps


def _ms(fn, n=5):
    """Median card milliseconds of ``fn()`` over ``n`` timed runs after
    one warm-up."""
    fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def test_selective_scan_ten_times_the_plain_scan(cuda):
    """Forward and backward where the plain scan still fits whole (2 rows
    of 1,024 steps, 5,120 channels, 16 states): the kernel at least 10x
    faster, timed in turns."""
    from repro_torch.kernels import selective_scan as SS
    case = _scan_case(cuda, 2, 1024, 5120, 16)
    kernel = _ms(lambda: _scan_and_grads(SS.selective_scan, *case))
    plain = _ms(lambda: _scan_and_grads(_plain_scan, *case))
    print(f"scan fwd+bwd at (2, 1024, 5120, 16): kernel {kernel:.3f} ms, "
          f"plain {plain:.3f} ms")
    assert plain >= 10 * kernel, (kernel, plain)


def test_jamba2_train_step_against_the_bench_reference(cuda):
    """jamba2-3b (one 14-layer period at the published widths) through
    models/steps.make_train_step at B=1, S=1,024 on the card, three
    steps, held to bench/reference/jamba.py as the benchmark's check
    holds the cell (its numbers against the cell's limits), with the
    scan kernel on every Mamba layer."""
    import json
    import sys
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from bench.drivers import lm_train as LT
    from bench.harness import model as M
    from bench.harness import runner
    from bench.harness import spec as SP
    from repro_torch.kernels import selective_scan as SS
    bench = SP.load_benchmark(root)
    cell = SP.workload(bench, "jamba2-3b-train-s4096")
    cfg = SP.config(bench, cell["config"], root)
    tr = dict(SP.traffic(cell["traffic"]), batch_size=1, seq_len=1024)
    run = runner.Run(bench, cell, cfg, tr, 2 ** 40 + 3, 1.0, False, cuda,
                     0.0)
    run.params = M.seeded_params(cfg, run.seed, cuda)
    driver = LT.Driver()
    before = SS.selective_scan.launches
    st = driver.setup(run)
    assert SS.selective_scan.launches - before == 3 * 39
    ans = driver.answers(run, st, None)
    driver.stop(st)
    got = LT.lm_numbers(run, ans)
    print("jamba2-3b B=1 S=1024 " + json.dumps(got))
    lim = cfg["limits"]["lmtrain"]
    assert all(got[k] <= v for k, v in lim.items()), (got, lim)
