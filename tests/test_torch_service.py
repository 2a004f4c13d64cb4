"""The port's CostModelService and CostModelServer against the
reference service, built on the same (untrained) params, vocab and
norm stats. Port-vs-reference checks are allclose: the reference does
not give bit-identical rows across batch packings on the CPU. Nor does
the port: on the CPU a row can take other last bits in one rung of the
batch ladder than in another, so its exact checks across packings pin
one rung."""
import sys
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.costmodel import CostModelConfig
from repro.core import models as RM
from repro.core import service as R_SVC
from repro.core import tokenizer as R_TOK
from repro.ir import samplers as R_SMP
from repro.opt.evaluate import spearman
from repro_torch.core import service as T_SVC
from repro_torch.core import tokenizer as T_TOK
from repro_torch.core.server import CostModelServer
from repro_torch.ir import samplers as T_SMP
from repro_torch.kernels import ops as T_OPS

CFG = CostModelConfig(name="svc-port-test", vocab_size=512, max_seq=64,
                      embed_dim=16, conv_channels=(16,) * 6,
                      fc_dims=(32, 16))
TOL = 2e-4     # float32, another accumulation order than XLA's


@pytest.fixture(scope="module")
def world():
    """Identical graphs from both samplers, one vocab, reference params
    (embedding scaled so predictions spread, biases nonzero), and the
    reference service's f32 predictions."""
    r_rng, t_rng = np.random.default_rng(7), np.random.default_rng(7)
    r_graphs = [R_SMP.sample_graph(r_rng) for _ in range(40)]
    t_graphs = [T_SMP.sample_graph(t_rng) for _ in range(40)]
    vocab = R_TOK.fit_vocab([R_TOK.graph_tokens(g, "ops")
                             for g in r_graphs], max_size=512)
    t_vocab = T_TOK.fit_vocab([T_TOK.graph_tokens(g, "ops")
                               for g in t_graphs], max_size=512)
    assert t_vocab.token_to_id == vocab.token_to_id
    params = RM.conv_init(jax.random.PRNGKey(0), CFG, heads=RM.DEFAULT_HEADS)
    params["emb"] = params["emb"] * 20.0
    b_rng = np.random.default_rng(0)          # conv_init zeroes biases
    for lyr in [*params["convs"], *params["fc"], *params["heads"].values()]:
        lyr["b"] = (b_rng.normal(size=lyr["b"].shape) * 0.1).astype(
            np.float32)
    stats = {t: {"mu": 0.3, "sigma": 1.7} for t in RM.DEFAULT_HEADS}
    ref = R_SVC.CostModelService("conv1d", CFG, params, vocab, stats,
                                 mode="ops", max_seq=64, max_batch=8)
    want = ref.predict_all(r_graphs)
    pn = jax.tree.map(np.asarray, params)

    def make(**kw):
        kw.setdefault("max_batch", 8)
        kw.setdefault("device", "cpu")
        return T_SVC.CostModelService("conv1d", CFG, pn, t_vocab, stats,
                                      mode="ops", max_seq=64, **kw)
    return {"graphs": t_graphs, "want": want, "make": make, "ref": ref}


def _close(got, want, tol=TOL):
    assert set(got) == set(want)
    for t in want:
        np.testing.assert_allclose(got[t], want[t], rtol=tol, atol=tol)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_predict_all_matches_reference(world, use_kernel):
    svc = world["make"](use_kernel=use_kernel)
    _close(svc.predict_all(world["graphs"]), world["want"])


def test_bf16_keeps_rank_order(world):
    svc = world["make"](use_kernel=True, dtype="bf16")
    got = svc.predict_all(world["graphs"])
    for t in RM.DEFAULT_HEADS:
        assert got[t].dtype == np.float32
        assert spearman(world["want"][t], got[t]) >= 0.99, t


def test_repeat_query_hits_lru(world):
    svc = world["make"](use_kernel=True)
    first = svc.predict_all(world["graphs"][:6])
    hits = svc.cache_stats()["hits"]
    again = svc.predict_all(world["graphs"][:6])
    assert svc.cache_stats()["hits"] >= hits + len(
        {g.struct_key() for g in world["graphs"][:6]})
    for t in first:
        np.testing.assert_array_equal(first[t], again[t])


def test_bucketed_equals_full_length(world):
    """pad_slack keeps bucket-padded predictions equal to max_seq-padded
    ones (the max-pool covers pads, so the slack is what makes it so)."""
    a = world["make"](use_kernel=True).predict_all(world["graphs"])
    b = world["make"](use_kernel=True, buckets=(64,)).predict_all(
        world["graphs"])
    _close(a, b, tol=1e-6)


def test_ladders_buckets_and_slack_match_reference(world):
    svc, ref = world["make"](), world["ref"]
    assert svc.batch_ladder == ref.batch_ladder
    assert svc.buckets == ref.buckets
    assert set(svc.heads) == set(ref.heads)
    for fs in [(2,) * 6, (16, 16, 8, 8, 2, 1)]:
        cfg = CostModelConfig(name="x", vocab_size=8, max_seq=8,
                              conv_filters=fs)
        assert T_SVC.pad_slack("conv1d", cfg) == R_SVC.pad_slack("conv1d",
                                                                 cfg)
    assert set(svc.phase_stats()) == set(ref.phase_stats())


def test_sorted_head_order_maps_by_name(world):
    """A param tree whose heads are listed in another order serves the
    same per-target predictions: collect maps columns by name."""
    svc = world["make"](use_kernel=True)
    shuffled = dict(svc.params)
    shuffled["heads"] = {t: svc.params["heads"][t]
                         for t in reversed(list(svc.params["heads"]))}
    other = T_SVC.CostModelService(
        "conv1d", CFG, shuffled, svc.vocab, svc.norm_stats, mode="ops",
        max_seq=64, max_batch=8, use_kernel=True, device="cpu")
    assert other.heads != svc.heads
    a, b = svc.predict_all(world["graphs"]), other.predict_all(
        world["graphs"])
    for t in RM.DEFAULT_HEADS:
        np.testing.assert_array_equal(a[t], b[t])


def test_guards(world):
    svc = world["make"]()
    with pytest.raises(ValueError, match="no kernel") as e:
        T_SVC.CostModelService("fc", CFG, svc.params, svc.vocab,
                               svc.norm_stats, use_kernel=True,
                               device="cpu")
    assert str(T_OPS.KERNEL_KINDS) in str(e.value)
    with pytest.raises(ValueError, match="no kernel") as e:
        T_SVC.CostModelService("xformer", CFG, svc.params, svc.vocab,
                               svc.norm_stats, use_kernel=True,
                               device="cpu")
    assert str(T_OPS.KERNEL_KINDS) in str(e.value)
    with pytest.raises(ValueError, match="dtype"):
        world["make"](dtype="fp8")
    with pytest.raises(ValueError, match="multi-target"):
        svc.predict_graphs(world["graphs"][:1])


@pytest.mark.parametrize("bad", [-1, CFG.vocab_size])
def test_dispatch_checks_id_range_on_host(world, bad):
    """forward_dispatch rejects ids outside the table before it copies
    them, so the kernel's launch needs no device check."""
    svc = world["make"](use_kernel=True)
    ids = np.zeros((2, 16), np.int32)
    ids[1, 3] = bad
    with pytest.raises(ValueError, match="token ids"):
        svc.forward_dispatch(ids)


def test_warmup_runs_every_shape(world):
    svc = world["make"](use_kernel=True)
    n = svc.warmup()
    assert n == len(svc.buckets) * len(svc.batch_ladder)
    assert svc.warmup_shapes == n and svc.forward_batches == 0


# --------------------------------- mirrors of tests/test_multihead.py:174-235
def test_lru_eviction_bounds_cache(world):
    svc = world["make"](cache_size=8)
    rng = np.random.default_rng(8)
    gs = [T_SMP.sample_graph(rng) for _ in range(30)]
    n_unique = len({svc._encode(g).tobytes() for g in gs})
    svc.predict_all(gs)
    assert len(svc._cache) == min(8, n_unique)
    svc.predict_all(gs[-4:])             # refresh recency for these four
    keys = set(svc._cache)
    svc.predict_all(gs[-4:])             # pure hits: no eviction, no growth
    assert set(svc._cache) == keys
    assert len(svc._cache) <= 8


@pytest.mark.parametrize("use_kernel", [False, True])
def test_service_lru_thread_safety_hammer(world, use_kernel):
    """Concurrent direct predict_all callers on one service with a tiny
    LRU (constant eviction) neither crash nor corrupt results: rows
    equal, bit for bit, a service on the same single rung that never
    evicts (twin of tests/test_server.py's hammer)."""
    graphs = world["graphs"]
    svc = world["make"](use_kernel=use_kernel, cache_size=8,
                        batch_ladder=(8,))
    want = world["make"](use_kernel=use_kernel,
                         batch_ladder=(8,)).predict_all(graphs)
    errs = []

    def hammer(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(6):
                idx = rng.integers(0, len(graphs), 12)
                out = svc.predict_all([graphs[i] for i in idx])
                for t in RM.DEFAULT_HEADS:
                    np.testing.assert_array_equal(out[t], want[t][idx])
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(6)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as it can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    stats = svc.cache_stats()
    assert stats["size"] <= 8
    assert stats["misses"] > 0 and stats["hits"] > 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_predict_all_empty_batch(world, use_kernel):
    out = world["make"](use_kernel=use_kernel).predict_all([])
    assert set(out) == set(RM.DEFAULT_HEADS)
    assert set(world["ref"].predict_all([])) == set(out)
    for v in out.values():
        assert v.shape == (0,)


def test_named_single_head_rejects_mismatched_target(world):
    """A service that knows it predicts latency does not answer a
    register-pressure request with latency numbers; its latency agrees
    with the reference's single-head service on the same params."""
    params = RM.conv_init(jax.random.PRNGKey(0), CFG)
    stats = {"mu": 0.0, "sigma": 1.0}
    svc = T_SVC.CostModelService(
        "conv1d", CFG, jax.tree.map(np.asarray, params), world["ref"].vocab,
        stats, mode="ops", max_seq=64, target="latency_us", device="cpu")
    ref = R_SVC.CostModelService("conv1d", CFG, params, world["ref"].vocab,
                                 stats, mode="ops", max_seq=64,
                                 target="latency_us")
    g = world["graphs"][0]
    r_g = R_SMP.sample_graph(np.random.default_rng(7))   # the same graph
    assert svc.predict(g, "latency_us") == svc.predict(g)
    with pytest.raises(KeyError):
        svc.predict(g, "register_pressure")
    np.testing.assert_allclose(svc.predict(g), ref.predict(r_g),
                               rtol=TOL, atol=TOL)


def test_server_threads_answer_like_direct(world):
    """4 client threads through the port's async server get what direct
    predict_all gives (allclose), and repeats coalesce or hit the LRU."""
    graphs = world["graphs"]
    direct = world["make"](use_kernel=True).predict_all(graphs)
    served = world["make"](use_kernel=True)
    results, lock = {}, threading.Lock()
    with CostModelServer(served, max_batch=8, flush_us=1000) as server:
        def client(k):
            for i in list(range(k, len(graphs), 4)) * 2:
                out = server.predict_all([graphs[i]])
                with lock:
                    results[i] = out
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        snap = server.metrics_snapshot()
    assert set(results) == set(range(len(graphs)))
    assert snap["cache_hits"] + snap["coalesced"] >= len(graphs)
    assert snap["requests"] == 2 * len(graphs)
    for i in range(len(graphs)):
        for t in RM.DEFAULT_HEADS:
            np.testing.assert_allclose(results[i][t][0], direct[t][i],
                                       rtol=TOL, atol=TOL)


# ------------------------------------------------------------------ LSTM
@pytest.fixture(scope="module")
def lstm_world(world):
    """The world's graphs and vocab, reference LSTM params (embedding x20,
    gate and head biases nonzero) and the reference LSTM service's f32
    predictions."""
    params = RM.lstm_init(jax.random.PRNGKey(1), CFG, heads=RM.DEFAULT_HEADS)
    params["emb"] = params["emb"] * 20.0
    b_rng = np.random.default_rng(1)             # lstm_init zeroes biases
    params["b"] = (b_rng.normal(size=params["b"].shape) * 0.1).astype(
        np.float32)
    for lyr in params["heads"].values():
        lyr["b"] = (b_rng.normal(size=lyr["b"].shape) * 0.1).astype(
            np.float32)
    ref = world["ref"]
    r_rng = np.random.default_rng(7)              # the world's graphs
    r_graphs = [R_SMP.sample_graph(r_rng) for _ in range(40)]
    want = R_SVC.CostModelService(
        "lstm", CFG, params, ref.vocab, ref.norm_stats, mode="ops",
        max_seq=64, max_batch=8).predict_all(r_graphs)
    pn = jax.tree.map(np.asarray, params)
    vocab = world["make"]().vocab

    def make(**kw):
        kw.setdefault("max_batch", 8)
        kw.setdefault("device", "cpu")
        return T_SVC.CostModelService("lstm", CFG, pn, vocab,
                                      ref.norm_stats, mode="ops",
                                      max_seq=64, **kw)
    return {"graphs": world["graphs"], "want": want, "make": make}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lstm_predict_all_matches_reference(lstm_world, use_kernel):
    """The LSTM service, plain or through the fused forward (its plain
    versions on the CPU), against the reference service on the same
    params, vocab and graphs."""
    svc = lstm_world["make"](use_kernel=use_kernel)
    _close(svc.predict_all(lstm_world["graphs"]), lstm_world["want"])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lstm_bf16_keeps_rank_order(lstm_world, use_kernel):
    svc = lstm_world["make"](use_kernel=use_kernel, dtype="bf16")
    got = svc.predict_all(lstm_world["graphs"])
    for t in RM.DEFAULT_HEADS:
        assert got[t].dtype == np.float32
        assert spearman(lstm_world["want"][t], got[t]) >= 0.99, t


def test_lstm_service_precomputes_the_projection_table(lstm_world):
    """use_kernel builds the (V, 4H) table of emb @ wx + b once; warmup
    runs every shape through it."""
    svc = lstm_world["make"](use_kernel=True)
    assert svc.warmup() == len(svc.buckets) * len(svc.batch_ladder)
    plain = lstm_world["make"]()
    assert svc.batch_ladder == plain.batch_ladder
    assert T_SVC.pad_slack("lstm", CFG) == R_SVC.pad_slack("lstm", CFG) == 0


def test_lstm_server_threads_answer_like_direct(lstm_world):
    graphs = lstm_world["graphs"]
    direct = lstm_world["make"](use_kernel=True).predict_all(graphs)
    served = lstm_world["make"](use_kernel=True)
    results, lock = {}, threading.Lock()
    with CostModelServer(served, max_batch=8, flush_us=1000) as server:
        def client(k):
            for i in range(k, len(graphs), 4):
                out = server.predict_all([graphs[i]])
                with lock:
                    results[i] = out
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert set(results) == set(range(len(graphs)))
    for i in range(len(graphs)):
        for t in RM.DEFAULT_HEADS:
            np.testing.assert_allclose(results[i][t][0], direct[t][i],
                                       rtol=TOL, atol=TOL)
