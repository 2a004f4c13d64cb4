"""The port's CostModelServer against the flush, cache and lifecycle
contracts of ``tests/test_server.py``: the deadline and full-batch
flush paths, LRU hits at submit, coalescing of concurrent duplicates,
and a server that must be started. Rows through the server equal the
port's direct service bit for bit and the reference service on the same
numpy params within TOL."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.costmodel import CostModelConfig
from repro.core import models as RM
from repro.core import service as R_SVC
from repro.core import tokenizer as R_TOK
from repro.ir import samplers as R_SMP
from repro_torch.core import tokenizer as TOK
from repro_torch.core.server import CostModelServer
from repro_torch.core.service import CostModelService
from repro_torch.ir import samplers

CFG = CostModelConfig(name="srv-test", vocab_size=512, max_seq=64,
                      embed_dim=16, conv_channels=(16,) * 6,
                      fc_dims=(32, 16))
STATS = {t: {"mu": 0.3, "sigma": 1.7} for t in RM.DEFAULT_HEADS}
TOL = 2e-4     # float32 in another accumulation order than XLA's


@pytest.fixture(scope="module")
def world():
    """The reference fixture's 48 graphs and vocab from both packages,
    its untrained params as numpy, the reference's direct rows, and a
    maker of identically weighted port services."""
    rng, r_rng = np.random.default_rng(7), np.random.default_rng(7)
    graphs = [samplers.sample_graph(rng) for _ in range(48)]
    r_graphs = [R_SMP.sample_graph(r_rng) for _ in range(48)]
    vocab = TOK.fit_vocab([TOK.graph_tokens(g, "ops") for g in graphs],
                          max_size=512)
    r_vocab = R_TOK.fit_vocab([R_TOK.graph_tokens(g, "ops")
                               for g in r_graphs], max_size=512)
    assert vocab.token_to_id == r_vocab.token_to_id
    params = RM.conv_init(jax.random.PRNGKey(0), CFG,
                          heads=RM.DEFAULT_HEADS)
    ref = R_SVC.CostModelService("conv1d", CFG, params, r_vocab, STATS,
                                 mode="ops", max_seq=64, max_batch=8)
    pn = jax.tree.map(np.asarray, params)

    def make(**kw):
        kw.setdefault("max_batch", 8)
        return CostModelService("conv1d", CFG, pn, vocab, STATS,
                                mode="ops", max_seq=64, device="cpu", **kw)
    return {"graphs": graphs, "r_graphs": r_graphs, "ref": ref,
            "make": make}


def _close_to_reference(world, got, idx):
    want = world["ref"].predict_all([world["r_graphs"][i] for i in idx])
    for t in want:
        np.testing.assert_allclose(got[t], want[t], rtol=TOL, atol=TOL)


def test_deadline_flush_path(world):
    """Fewer requests than max_batch resolve via the deadline/stall
    path, never a full-batch flush, and match direct results."""
    graphs = world["graphs"]
    direct = world["make"]()
    svc = world["make"]()
    with CostModelServer(svc, max_batch=8, flush_us=500) as server:
        out = server.predict_all(graphs[:3])
        m = server.metrics.snapshot()
    want = direct.predict_all(graphs[:3])
    for t in RM.DEFAULT_HEADS:
        np.testing.assert_array_equal(out[t], want[t])
    assert m["full_flushes"] == 0
    assert m["deadline_flushes"] + m["stagnant_flushes"] >= 1
    assert m["requests"] == 3
    _close_to_reference(world, out, range(3))


def test_full_batch_flush_path(world):
    """A bucket reaching max_batch flushes at once though the deadline
    is far away, and matches direct results bit for bit."""
    graphs = world["graphs"]
    svc = world["make"]()
    by_bucket = {}
    for i, g in enumerate(graphs):       # same-bucket graphs fill a queue
        _, ids = svc.entry(g)
        by_bucket.setdefault(len(ids), []).append(i)
    idx = max(by_bucket.values(), key=len)[:4]
    assert len(idx) == 4
    bucket_graphs = [graphs[i] for i in idx]
    want = world["make"]().predict_all(bucket_graphs)
    svc2 = world["make"](max_batch=4)
    with CostModelServer(svc2, max_batch=4, flush_us=10_000_000) as server:
        futs = [server.submit(g) for g in bucket_graphs]
        raw = np.stack([f.result(timeout=30) for f in futs])
        m = server.metrics.snapshot()
        out = svc2.denormalize_rows(raw)
    for t in RM.DEFAULT_HEADS:
        np.testing.assert_array_equal(out[t], want[t])
    assert m["full_flushes"] >= 1
    _close_to_reference(world, out, idx)


def test_cache_hit_and_coalescing(world):
    graphs = world["graphs"]
    svc = world["make"]()
    with CostModelServer(svc, max_batch=8, flush_us=2000) as server:
        g = graphs[0]
        first = server.predict_all([g])
        again = server.predict_all([g])  # resolved at submit from the LRU
        m = server.metrics.snapshot()
        assert m["cache_hits"] >= 1
        assert m["cache_hit_rate"] > 0
        for t in RM.DEFAULT_HEADS:
            np.testing.assert_array_equal(first[t], again[t])

        # concurrent duplicates of a new graph coalesce onto one compute
        futs = [server.submit(graphs[1]) for _ in range(5)]
        rows = [f.result(timeout=30) for f in futs]
        m = server.metrics.snapshot()
        assert m["coalesced"] >= 1
        for r in rows[1:]:
            np.testing.assert_array_equal(r, rows[0])


def test_submit_requires_started_server(world):
    g = world["graphs"][0]
    server = CostModelServer(world["make"]())
    with pytest.raises(RuntimeError):
        server.submit(g)
    server.start(warmup=False)
    assert np.isfinite(server.predict(g, "latency_us"))
    server.stop()
    with pytest.raises(RuntimeError):
        server.submit(g)
