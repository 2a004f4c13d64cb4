"""The plain reference against the port's plain path, on the CPU: the
frozen tokenizer and bucketing against the port's tokenizer and service,
the conv1d forward against ``core.models.conv_apply``, the training
step against the port's loss, gradients and AdamW."""
import random

import numpy as np
import pytest

import benchtest_util  # noqa: F401  (import paths)

torch = pytest.importorskip("torch")

from bench.harness import graphs as G  # noqa: E402
from bench.harness import model as M  # noqa: E402
from bench.reference import conv1d as RC  # noqa: E402
from bench.reference import tokenizer as RT  # noqa: E402
from bench.reference import train as RTR  # noqa: E402

HEADS = ["register_pressure", "valu_utilization", "latency_us"]
SMALL_CFG = {"name": "small", "vocab_size": 512, "max_seq": 64,
             "embed_dim": 16, "conv_filters": [2, 2, 2, 2, 2, 2],
             "conv_channels": [16] * 6, "fc_dims": [32, 16],
             "heads": HEADS, "mode": "ops", "kind": "conv1d"}
OPERAND_CFG = dict(SMALL_CFG, name="small-operand", max_seq=256,
                   conv_filters=[16, 16, 8, 8, 2, 1], mode="ops_operands")


def _graphs(n, seed=0, dressed=False):
    rng = random.Random(seed)
    fams = sorted(G.SAMPLERS)
    gs = [G.sample(rng, fams) for _ in range(n)]
    return [G.unoptimized_ir(g, rng) for g in gs] if dressed else gs


def _port_cfg(cfg):
    from bench.models import conv1d
    return conv1d.port_config(cfg)


@pytest.mark.parametrize("mode", ["ops", "ops_operands"])
@pytest.mark.parametrize("dressed", [False, True])
def test_tokens_equal_the_ports(mode, dressed):
    from repro_torch.core import tokenizer as TOK
    for g in _graphs(60, seed=3, dressed=dressed):
        assert RT.graph_tokens(g, mode) == TOK.graph_tokens(g, mode)


@pytest.mark.parametrize("cfg", [SMALL_CFG, OPERAND_CFG],
                         ids=["ops", "ops_operands"])
def test_ids_and_buckets_equal_the_services(cfg):
    from repro_torch.core import tokenizer as TOK
    from repro_torch.core.service import CostModelService
    vocab = M.fit_vocab(cfg, 1, 200)
    params = M.seeded_params(cfg, 1, torch.device("cpu"))
    svc = CostModelService("conv1d", _port_cfg(cfg), params,
                           TOK.Vocab(dict(vocab)), M.norm_stats(cfg, 1),
                           mode=cfg["mode"], max_seq=cfg["max_seq"],
                           device="cpu")
    for g in _graphs(80, seed=4):
        _, ids = svc.entry(g)
        np.testing.assert_array_equal(RT.graph_ids(g, cfg, vocab), ids)


@pytest.mark.parametrize("cfg", [SMALL_CFG, OPERAND_CFG],
                         ids=["ops", "ops_operands"])
def test_forward_equals_conv_apply(cfg):
    from repro_torch.core import models as CM
    params = M.seeded_params(cfg, 2, torch.device("cpu"))
    vocab = M.fit_vocab(cfg, 2, 200)
    ids = torch.from_numpy(np.stack([
        RT.encode(RT.graph_tokens(g, cfg["mode"]), vocab, cfg["max_seq"])
        for g in _graphs(32, seed=5)]))
    got = RC.forward(params, ids)
    want = CM.conv_apply(params, ids.to(torch.int32))
    want = torch.stack([want[t] for t in HEADS], dim=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_denormalize_equals_the_services():
    from repro_torch.core import tokenizer as TOK
    from repro_torch.core.service import CostModelService
    cfg = SMALL_CFG
    stats = M.norm_stats(cfg, 3)
    svc = CostModelService("conv1d", _port_cfg(cfg),
                           M.seeded_params(cfg, 3, torch.device("cpu")),
                           TOK.Vocab(M.fit_vocab(cfg, 3, 50)), stats,
                           device="cpu")
    raw = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    den = svc.denormalize_rows(raw)
    got = RC.denormalize(torch.from_numpy(raw), stats, HEADS).numpy()
    np.testing.assert_allclose(got, np.stack([den[t] for t in HEADS], 1),
                               rtol=1e-6)


def test_train_steps_equal_the_ports():
    """Three steps of the reference against the port's loss, gradients
    and AdamW from the same weights on the same batches."""
    from repro_torch import params as P
    from repro_torch.core import models as CM
    from repro_torch.core.trainer import make_loss_fn, value_and_grad
    from repro_torch.optim import adamw
    cfg = SMALL_CFG
    params = M.seeded_params(cfg, 4, torch.device("cpu"))
    vocab = M.fit_vocab(cfg, 4, 200)
    gs = _graphs(96, seed=6)
    ids = torch.from_numpy(np.stack([
        RT.encode(RT.graph_tokens(g, "ops"), vocab, 64) for g in gs]))
    targets = {t: np.exp(np.random.default_rng(i).normal(
        2, 0.5, len(gs))).astype(np.float32) for i, t in enumerate(HEADS)}
    y = torch.from_numpy(RTR.normalize(targets, HEADS))
    batches = [(ids[i:i + 32], y[i:i + 32]) for i in (0, 32, 64)]
    opt = RTR.AdamW(lr=1e-3, weight_decay=0.01, warmup_steps=50,
                    total_steps=1000)
    losses, g1, p3 = RTR.run_steps(params, batches, opt)
    cfg_p = adamw.AdamWConfig(lr=1e-3, total_steps=1000, warmup_steps=50,
                              weight_decay=0.01)
    loss_fn = make_loss_fn(CM.get_model("conv1d")[1], tuple(HEADS))
    p, st = M.tree_to(params, "cpu"), adamw.init_state(params)
    port_losses = []
    for k, (i, yy) in enumerate(batches):
        loss, grads = value_and_grad(loss_fn, p, i.to(torch.int32), yy)
        p, st, _ = adamw.apply_updates(p, grads, st, cfg_p)
        port_losses.append(float(loss))
        if k == 0:
            port_g1 = [x / 0.1 for x in P.tree_flatten(st["m"])]
    np.testing.assert_allclose(losses, port_losses, rtol=1e-5)
    for a, b in zip(g1, port_g1):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    for a, b in zip(p3, P.tree_flatten(p)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, -3.0],
                     dtype=torch.float32)
    got = RC.tf32_round(x)
    assert got[0] == 1.0 + 2 ** -10
    assert got[1] == 1.0 + 2 ** -10       # rounded up to 10 bits
    assert got[2] == -3.0
