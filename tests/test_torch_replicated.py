"""The port's replicated serving tier against the reference: spawned CPU
replicas behind the struct-key router give the reference's direct
service's predictions (allclose 2e-4, the port-against-reference limit),
routing keeps per-replica LRUs hot, the shared cross-replica cache, the
wire format, the consistent-hash ring and the client's retry, backoff,
health and shed state machine (a fake transport, no processes). The
pure modules (ring, wire packing, shared-cache slots) are held to the
reference's exactly. The router's featurizer runs on the CPU and never
forwards. The reference's stablehlo case waits for a port of
``ir/stablehlo.py``."""
import dataclasses
import hashlib
import os
import queue
import signal
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.costmodel import CostModelConfig as R_Config
from repro.core import models as RM
from repro.core import service as R_SVC
from repro.core import tokenizer as R_TOK
from repro.ir import frontdoor as R_FD
from repro.ir import samplers as R_SMP
from repro.serving import router as R_ROUTER
from repro.serving import shared_cache as R_SC
from repro.serving import transport as R_T
from repro_torch import params as P
from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import service as T_SVC
from repro_torch.core import tokenizer as TOK
from repro_torch.core.server import ServerOverloadedError
from repro_torch.ir import frontdoor as FD
from repro_torch.ir import samplers
from repro_torch.serving import (HashRing, ReplicaClient,
                                 ReplicaSupervisor, ServiceSpec,
                                 SharedRowCache, start_replicas)
from repro_torch.serving import transport as T

DIMS = dict(vocab_size=512, max_seq=64, embed_dim=16,
            conv_channels=(16,) * 2, fc_dims=(32,))
CFG = CostModelConfig(name="repl-test", **DIMS)
R_CFG = R_Config(name="repl-test", **DIMS)
SVC_KW = dict(mode="ops", max_seq=64, max_batch=8, buckets=(32, 64),
              batch_ladder=(1, 2, 4, 8))
N_REPLICAS = 4
TOL = 2e-4          # port against reference: float32 in another order
# port against port across processes: the CPU's plain forward sums in
# another order by batch composition and thread count (the replicas run
# one thread), a few float32 ulps of rows of a few tenths
PORT_TOL = dict(rtol=1e-6, atol=1e-6)


def _sha_keys(n, salt=""):
    """Production-shaped keys (struct_key() is sha1 hex)."""
    return [hashlib.sha1(f"{salt}k{i}".encode()).hexdigest()
            for i in range(n)]


def _close(got, want, tol=TOL):
    assert set(got) == set(want)
    for t in want:
        np.testing.assert_allclose(got[t], want[t], rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def world():
    """The same 24 graphs from both samplers, one vocab, reference params
    (embedding x20, biases nonzero) as numpy, the reference's direct
    service and the port's CPU service on them."""
    r_rng, t_rng = np.random.default_rng(11), np.random.default_rng(11)
    r_graphs = [R_SMP.sample_graph(r_rng) for _ in range(24)]
    graphs = [samplers.sample_graph(t_rng) for _ in range(24)]
    r_vocab = R_TOK.fit_vocab([R_TOK.graph_tokens(g, "ops")
                               for g in r_graphs], max_size=512)
    vocab = TOK.fit_vocab([TOK.graph_tokens(g, "ops") for g in graphs],
                          max_size=512)
    assert vocab.token_to_id == r_vocab.token_to_id
    params = RM.conv_init(jax.random.PRNGKey(3), R_CFG,
                          heads=RM.DEFAULT_HEADS)
    params["emb"] = params["emb"] * 20.0
    b_rng = np.random.default_rng(3)          # conv_init zeroes biases
    for lyr in [*params["convs"], *params["fc"], *params["heads"].values()]:
        lyr["b"] = (b_rng.normal(size=lyr["b"].shape) * 0.1).astype(
            np.float32)
    stats = {t: {"mu": 0.2, "sigma": 1.3} for t in RM.DEFAULT_HEADS}
    ref = R_SVC.CostModelService("conv1d", R_CFG, params, r_vocab, stats,
                                 **SVC_KW)
    pn = jax.tree.map(np.asarray, params)

    def make(**kw):
        kw.setdefault("device", "cpu")
        return T_SVC.CostModelService("conv1d", CFG, pn, vocab, stats,
                                      **SVC_KW, **kw)
    return {"graphs": graphs, "r_graphs": r_graphs, "ref": ref,
            "want": ref.predict_all(r_graphs), "make": make,
            "service": make()}


@pytest.fixture(scope="module")
def service(world):
    return world["service"]


@pytest.fixture(scope="module")
def spec(service):
    return ServiceSpec.from_service(service)


@pytest.fixture(scope="module")
def tier(spec):
    """One real spawned CPU tier shared by the process-backed tests."""
    tier = start_replicas(spec, N_REPLICAS, n_clients=3,
                          flush_us=300.0, start_timeout_s=240.0)
    yield tier
    tier.stop()


# ------------------------------------------------------------ real tier
def test_replicated_parity_matches_reference(world, service, tier):
    """Predictions through 4 replicas + router == the reference's direct
    predict_all within 2e-4, and the port's own direct service's within
    the reference test's rtol 1e-6."""
    graphs = world["graphs"]
    client = ReplicaClient(tier.client_handle(0))
    got = client.predict_all(graphs)
    _close(got, world["want"])
    direct = service.predict_all(graphs)
    for t in direct:
        np.testing.assert_allclose(got[t], direct[t], **PORT_TOL)
    again = client.predict_all(graphs)       # the client's local LRU
    for t in got:
        np.testing.assert_array_equal(again[t], got[t])
    assert client.shed_count == 0


def test_replicated_predict_text_parity(world, service, tier):
    """The front door through the tier: the reference service's key and
    predictions for the same text, and garbage degrades to a structured
    IngestError, never an exception."""
    want = world["ref"].predict_text(R_FD.AFFINE_EXAMPLE)
    assert not isinstance(want, R_FD.IngestError)
    client = ReplicaClient(tier.client_handle(1))
    got = client.predict_text(FD.AFFINE_EXAMPLE)
    assert not isinstance(got, FD.IngestError)
    assert got.key == want.key
    direct = service.predict_text(FD.AFFINE_EXAMPLE)
    for t, v in want.predictions.items():
        np.testing.assert_allclose(got.predictions[t], v, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got.predictions[t],
                                   direct.predictions[t], **PORT_TOL)
    again = client.predict_text(FD.AFFINE_EXAMPLE)   # client-side LRU
    assert again.predictions == got.predictions
    assert isinstance(client.predict_text(b"\x00\xff"), FD.IngestError)


def test_replicated_use_kernel_parity(world):
    """use_kernel and device survive the ServiceSpec round trip, and a
    2-replica tier serving the fused forward (its plain version on the
    CPU) answers like the reference's plain direct service."""
    ksvc = world["make"](use_kernel=True)
    kspec = ServiceSpec.from_service(ksvc)
    assert kspec.use_kernel is True and kspec.device == "cpu"
    rebuilt = kspec.build()
    assert rebuilt.use_kernel is True and rebuilt.device == "cpu"
    _close(rebuilt.predict_all(world["graphs"]), world["want"])
    ktier = start_replicas(kspec, 2, n_clients=1, flush_us=300.0,
                           start_timeout_s=240.0)
    try:
        client = ReplicaClient(ktier.client_handle(0))
        _close(client.predict_all(world["graphs"]), world["want"])
        assert client.shed_count == 0
    finally:
        ktier.stop()


def test_featurizer_never_forwards(world, tier):
    """The router's featurizer is a CPU service that only keys, encodes
    and caches: its forward counters stay at 0 over predict_all and
    predict_text, and it builds on the CPU from a card spec too."""
    client = ReplicaClient(tier.client_handle(2), local_cache=False)
    fsvc = client.fsvc
    assert fsvc.device == "cpu"
    client.predict_all(world["graphs"][:8])
    assert not isinstance(client.predict_text(FD.AFFINE_EXAMPLE),
                          FD.IngestError)
    assert fsvc.forward_batches == 0
    assert fsvc.phase_stats()["forward_s"] == 0.0
    card = ServiceSpec.from_service(world["make"](use_kernel=True))
    card.device = "cuda"
    feat = ReplicaClient(transport=FakeTransport(4, lambda r, ks: ("ok",)),
                         spec=card).fsvc
    assert feat.device == "cpu" and feat.forward_batches == 0


def test_replica_stats_report_device_and_work(world, tier):
    """Each replica's stats name its device and report its kind's kernel
    launch counters (0 on the CPU, where the wrappers run their plain
    versions) and its forward batches; no replica ran nvcc."""
    client = ReplicaClient(tier.client_handle(2), local_cache=False)
    client.predict_all(world["graphs"])
    stats = [s for s in client.replica_stats() if s]
    assert len(stats) == N_REPLICAS
    for s in stats:
        assert s["device"] == {"type": "cpu", "name": None}
        assert s["kernel_launches"] == {"conv_forward_fused": 0}
        assert s["nvcc_runs"] == 0
    assert sum(s["forward_batches"] for s in stats) >= 1
    assert sum(s["server"]["batches"] for s in stats) == \
        sum(s["forward_batches"] for s in stats)


def test_start_replicas_raises_without_a_card(spec):
    """A replica that cannot reach the card fails to start, and
    start_replicas raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    card = dataclasses.replace(spec, device="cuda")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        start_replicas(card, 1, start_timeout_s=240.0)


def test_struct_key_routing_preserves_replica_lru(world, tier):
    """Struct-key routing sends a key to the same replica every time, so
    repeat queries hit that replica's own LRU."""
    graphs = world["graphs"]
    client = ReplicaClient(tier.client_handle(1), local_cache=False)
    client.clear_caches()
    tier.shared_cache.clear()
    before = {s["replica_id"]: s["cache"]
              for s in client.replica_stats() if s}
    client.predict_all(graphs)         # pass 1: compulsory misses
    client.predict_all(graphs)         # pass 2: replica-LRU hits
    stats = [s for s in client.replica_stats() if s]
    assert len(stats) == N_REPLICAS
    delta = {}
    for s in stats:
        b, c = before[s["replica_id"]], s["cache"]
        delta[s["replica_id"]] = (c["hits"] - b["hits"],
                                  c["misses"] - b["misses"])
    used = {r: d for r, d in delta.items() if d[0] + d[1] > 0}
    assert len(used) >= 2, "routing degenerated onto one replica"
    for r, (hits, misses) in used.items():
        assert hits / (hits + misses) >= 0.5 - 1e-9, \
            f"replica {r} LRU went cold: hits={hits} misses={misses}"
    assert sum(d[1] for d in used.values()) == \
        len({g.struct_key() for g in graphs})


def test_shared_cache_serves_cross_replica_misses(service, tier):
    """A row published to the shared tier is served without a forward
    pass."""
    g = samplers.sample_graph(np.random.default_rng(99), "unet")
    key = service.key_of(g)
    client = ReplicaClient(tier.client_handle(2), local_cache=False)
    client.clear_caches()
    sentinel = np.full((len(service.heads),), 0.125, np.float32)
    tier.shared_cache.put(key, sentinel)
    got = client.predict_all([g])
    want = service.denormalize_rows(sentinel[None])
    for t in want:
        np.testing.assert_allclose(got[t], want[t], **PORT_TOL)


def test_replicated_entrypoint_exports(tier):
    assert tier.n_replicas == N_REPLICAS
    assert all(tier.alive())


def test_fleet_workers_search_through_the_tier(world, service, tier):
    """Two spawned fleet workers search a pool through the tier: every
    worker finds the direct search's best graphs (costs within the
    cross-process tolerance), counts its candidates, and never
    initialises CUDA."""
    from repro_torch.opt import search as SE
    from repro_torch.serving import FleetDriver
    pool = world["graphs"][:4]
    kw = dict(beam_width=2, max_steps=2, eval_budget=24)
    want = {r.root.struct_key(): r for r in SE.search_pool(service, pool,
                                                           **kw)}
    drv = FleetDriver.start(tier, pool, 2, search_kw=kw,
                            start_timeout_s=240.0)
    try:
        p = drv.run_pass()
        stats = drv.stats()
    finally:
        drv.stop()
    assert p["candidates"] == 2 * sum(r.evaluated + 1
                                      for r in want.values())
    for best in p["best"]:
        assert set(best) == set(want)
        for k, (key, score) in best.items():
            assert key == want[k].best.struct_key()
            np.testing.assert_allclose(score, want[k].best_score,
                                       **PORT_TOL)
    assert [w["cuda_initialized"] for w in stats] == [False, False]
    assert all(w["shed_count"] == 0 for w in stats)


# ------------------------------------------------- shared cache (unit)
def test_shared_row_cache_roundtrip():
    c = SharedRowCache(n_heads=3, n_slots=64)
    assert c.get("a" * 40) is None
    row = np.array([1.5, -2.0, 0.25], np.float32)
    c.put("a" * 40, row)
    np.testing.assert_array_equal(c.get("a" * 40), row)
    assert c.fill() == 1
    c.put("a" * 40, row * 2)            # refresh in place
    np.testing.assert_array_equal(c.get("a" * 40), row * 2)
    assert c.fill() == 1
    c.put("not-a-hex-key", row)         # non-hex keys digest via sha1
    np.testing.assert_array_equal(c.get("not-a-hex-key"), row)
    c.clear()
    assert c.fill() == 0
    assert c.get("a" * 40) is None


def test_shared_row_cache_eviction_bounded():
    c = SharedRowCache(n_heads=2, n_slots=8)
    keys = [f"{i:040x}" for i in range(64)]
    c.put_many([(k, np.array([i, -i], np.float32))
                for i, k in enumerate(keys)])
    assert c.fill() <= 8
    live = [k for k in keys if c.get(k) is not None]
    assert live
    for k in live:
        i = int(k, 16)
        np.testing.assert_array_equal(c.get(k),
                                      np.array([i, -i], np.float32))


def test_shared_row_cache_get_many():
    c = SharedRowCache(n_heads=1, n_slots=32)
    c.put("b" * 40, np.array([7.0], np.float32))
    got = c.get_many(["b" * 40, "c" * 40])
    np.testing.assert_array_equal(got[0], [7.0])
    assert got[1] is None


def test_shared_row_cache_slots_match_reference():
    """The same puts (hex and sha1 keys, refreshes, evictions) leave the
    same slot bytes, CRCs included, in both packages' tables."""
    rng = np.random.default_rng(5)
    ours, theirs = SharedRowCache(3, n_slots=16), R_SC.SharedRowCache(
        3, n_slots=16)
    keys = _sha_keys(40) + ["plain-key", "another"]
    for i in range(3):
        items = [(k, rng.normal(size=3).astype(np.float32))
                 for k in keys[i::2]]
        ours.put_many(items)
        theirs.put_many(items)
    assert bytes(ours._buf) == bytes(theirs._buf)
    assert ours.fill() == theirs.fill()
    for k in keys:
        a, b = ours.get(k), theirs.get(k)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ transport (unit)
def test_pack_unpack_entries_roundtrip():
    entries = [("k1", np.arange(8, dtype=np.int32)),
               ("k2", np.arange(100, 116, dtype=np.int32)),
               ("k3", np.zeros(0, np.int32))]
    keys, lens_b, ids_b = T.pack_entries(entries)
    back = T.unpack_entries(keys, lens_b, ids_b)
    assert [k for k, _ in back] == ["k1", "k2", "k3"]
    for (_, a), (_, b) in zip(entries, back):
        np.testing.assert_array_equal(a, b)
    assert T.pack_entries([]) == ([], b"", b"")


def test_pack_unpack_rows_roundtrip():
    rows = [np.array([1.0, 2.0, 3.0], np.float32),
            np.array([-1.0, 0.5, 9.0], np.float32)]
    rows_b, nh = T.pack_rows(rows)
    assert nh == 3
    np.testing.assert_array_equal(T.unpack_rows(rows_b, nh),
                                  np.stack(rows))


def test_wire_format_matches_reference():
    """The message tags and the packed bytes are the reference's, byte
    for byte."""
    for name in ("MSG_REQ", "MSG_RES", "MSG_OVERLOAD", "MSG_ERR",
                 "MSG_STATS", "MSG_STATS_RES", "MSG_CLEAR", "MSG_STOP"):
        assert getattr(T, name) == getattr(R_T, name)
    rng = np.random.default_rng(2)
    entries = [(k, rng.integers(0, 512, n).astype(np.int32))
               for k, n in zip(_sha_keys(5), (3, 0, 64, 17, 32))]
    assert T.pack_entries(entries) == R_T.pack_entries(entries)
    rows = [rng.normal(size=3).astype(np.float32) for _ in range(4)]
    assert T.pack_rows(rows) == R_T.pack_rows(rows)
    msg = (T.MSG_REQ, 0, 1, [], b"", b"", ("t", "s"))
    assert T.req_trace(msg) == R_T.req_trace(msg) == ("t", "s")
    assert T.res_spans(msg[:5]) is None


def test_service_spec_rebuild_parity(world, service, spec):
    """build() in the same process reproduces the service."""
    rebuilt = spec.build()
    assert rebuilt.device == "cpu"
    want = service.predict_all(world["graphs"])
    got = rebuilt.predict_all(world["graphs"])
    for t in want:
        np.testing.assert_allclose(got[t], want[t], **PORT_TOL)


def test_service_spec_from_tensor_params(service):
    """A service on torch params (as the card checks seed them) exports
    numpy params, and the rebuilt service answers the same."""
    t_params = P.tree_map(torch.tensor, service.params)
    svc = T_SVC.CostModelService("conv1d", CFG, t_params, service.vocab,
                                 service.norm_stats, device="cpu",
                                 **SVC_KW)
    spec = ServiceSpec.from_service(svc)
    assert all(isinstance(a, np.ndarray)
               for a in P.tree_leaves(spec.params))
    g = samplers.sample_graph(np.random.default_rng(4))
    want, got = svc.predict_all([g]), spec.build().predict_all([g])
    for t in want:
        np.testing.assert_array_equal(got[t], want[t])


def test_export_import_cache_roundtrip(world, service):
    graphs = world["graphs"]
    donor = ServiceSpec.from_service(service).build()
    donor.predict_all(graphs)
    items = donor.export_cache()
    assert len(items) == len({g.struct_key() for g in graphs})
    recip = ServiceSpec.from_service(service).build()
    assert recip.import_cache(items) == len(items)
    before = recip.phase_stats()["forward_s"]
    got = recip.predict_all(graphs)    # all answered from imported rows
    assert recip.phase_stats()["forward_s"] == before
    assert recip.forward_batches == 0
    want = service.predict_all(graphs)
    for t in want:
        np.testing.assert_allclose(got[t], want[t], **PORT_TOL)


# ------------------------------------------------------------- hash ring
def test_hash_ring_stable_and_balanced():
    ring = HashRing(4, vnodes=32)
    keys = _sha_keys(1000)
    owners = [ring.primary(k) for k in keys]
    assert owners == [ring.primary(k) for k in keys]
    counts = np.bincount(owners, minlength=4)
    assert (counts > 0).all()
    assert counts.max() <= 3 * counts.min() + 8
    order = ring.route(keys[0])
    assert sorted(order) == [0, 1, 2, 3]
    assert ring.route(keys[0], 2) == order[:2]


@pytest.mark.parametrize("n,vnodes", [(1, 32), (3, 8), (4, 32), (7, 16)])
def test_hash_ring_matches_reference(n, vnodes):
    """Every key's full route is the reference ring's."""
    ours, theirs = HashRing(n, vnodes), R_ROUTER.HashRing(n, vnodes)
    for k in _sha_keys(300) + ["plain", "x" * 40, ""]:
        assert ours.route(k) == theirs.route(k)


# --------------------------------------- router state machine (no procs)
def _row_for(key: str, n_heads: int) -> np.ndarray:
    h = int(key[:8], 16) if len(key) == 40 else abs(hash(key))
    return (np.arange(n_heads, dtype=np.float32) + h % 97) / 97.0


class FakeTransport:
    """Scripted tier: behavior(replica, keys) decides each request's
    fate — ("ok",), ("overload", retry_after), ("err",), ("drop",)."""

    def __init__(self, n_replicas, behavior, n_heads=3):
        self.n_replicas = n_replicas
        self.client_id = 0
        self.behavior = behavior
        self.n_heads = n_heads
        self.q = queue.Queue()
        self.sent = []

    def send(self, replica, msg):
        if msg[0] != T.MSG_REQ:
            return
        _, _client, bid, keys, _lens, _ids = msg
        self.sent.append((replica, list(keys)))
        act = self.behavior(replica, keys)
        if act[0] == "ok":
            rows_b, nh = T.pack_rows(
                [_row_for(k, self.n_heads) for k in keys])
            self.q.put((T.MSG_RES, bid, list(range(len(keys))),
                        rows_b, nh))
        elif act[0] == "overload":
            self.q.put((T.MSG_OVERLOAD, bid, list(range(len(keys))),
                        act[1]))
        elif act[0] == "err":
            self.q.put((T.MSG_ERR, bid, list(range(len(keys))),
                        "scripted failure"))

    def recv(self, timeout):
        return self.q.get(timeout=timeout)


@pytest.fixture()
def fake_client(spec):
    def make(behavior, **kw):
        tr = FakeTransport(4, behavior)
        kw.setdefault("backoff_s", 0.001)
        kw.setdefault("timeout_s", 0.25)
        kw.setdefault("cooldown_s", 0.02)
        return ReplicaClient(transport=tr, spec=spec, **kw), tr
    return make


def _entries(n, start=0):
    return [(k, np.arange(4, dtype=np.int32))
            for k in _sha_keys(n, salt=f"{start}-")]


def test_router_happy_path_routes_by_ring(fake_client):
    client, tr = fake_client(lambda r, ks: ("ok",))
    ents = _entries(32)
    got = client._fetch(ents)
    assert set(got) == {k for k, _ in ents}
    for k in got:
        np.testing.assert_array_equal(got[k], _row_for(k, 3))
    for replica, keys in tr.sent:
        for k in keys:
            assert client.ring.primary(k) == replica
    assert sum(h.ok for h in client.health) == len(tr.sent)


def test_router_reroutes_around_overloaded_replica(fake_client):
    client, tr = fake_client(
        lambda r, ks: ("overload", 0.01) if r == 0 else ("ok",))
    ents = _entries(64)
    primaries = {k: HashRing(4).primary(k) for k, _ in ents}
    assert any(p == 0 for p in primaries.values())
    got = client._fetch(ents)
    assert len(got) == len(ents)
    assert client.health[0].overload >= 1
    assert client.health[0].consecutive_failures >= 1
    assert client.health[0].unhealthy_until > time.monotonic() - 1.0
    assert client.shed_count == 0
    retried = [(r, ks) for r, ks in tr.sent[1:] if r != 0
               and any(primaries[k] == 0 for k in ks)]
    assert retried


def test_router_sheds_when_all_replicas_overloaded(fake_client):
    client, tr = fake_client(lambda r, ks: ("overload", 0.001),
                             max_retries=2)
    with pytest.raises(ServerOverloadedError):
        client._fetch(_entries(4))
    assert client.shed_count == 1
    rounds = len(tr.sent)
    assert rounds >= 3
    assert sum(h.overload for h in client.health) == rounds


def test_router_honors_retry_after_hint(fake_client):
    state = {"n": 0}

    def behavior(r, ks):
        state["n"] += 1
        return ("overload", 0.15) if state["n"] == 1 else ("ok",)

    client, _ = fake_client(behavior)
    t0 = time.monotonic()
    assert len(client._fetch(_entries(1))) == 1
    assert time.monotonic() - t0 >= 0.15


def test_router_reroutes_around_dead_replica(fake_client):
    ents = _entries(1, start=5000)
    dead = HashRing(4).primary(ents[0][0])
    client, tr = fake_client(
        lambda r, ks: ("drop",) if r == dead else ("ok",),
        timeout_s=0.05)
    assert len(client._fetch(ents)) == 1
    assert client.health[dead].timeout >= 1
    assert tr.sent[0][0] == dead
    assert tr.sent[-1][0] != dead


def test_router_shared_client_concurrent_fetch(fake_client):
    """One client shared by many threads: the reply demux hands each
    thread its own batch."""
    client, tr = fake_client(lambda r, ks: ("ok",), timeout_s=5.0)
    n_threads, per_thread = 8, 12
    errs, done = [], []

    def worker(w):
        try:
            for i in range(per_thread):
                ents = _entries(3, start=w * 1000 + i * 10)
                got = client._fetch(ents)
                assert set(got) == {k for k, _ in ents}
                for k in got:
                    np.testing.assert_array_equal(got[k], _row_for(k, 3))
            done.append(w)
        except Exception as e:           # pragma: no cover - regression
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    assert len(done) == n_threads
    assert client.shed_count == 0
    assert sum(h.timeout for h in client.health) == 0
    assert not client._mail and not client._live


def test_router_scripted_error_counts_and_reroutes(fake_client):
    ents = _entries(1, start=900)
    bad = HashRing(4).primary(ents[0][0])
    client, _ = fake_client(
        lambda r, ks: ("err",) if r == bad else ("ok",))
    assert len(client._fetch(ents)) == 1
    assert client.health[bad].err == 1
    st = client.stats()
    assert st["health"][bad]["err"] == 1
    assert st["shed_count"] == 0


# --------------------------------------------- hard failure (real tier)
def test_replica_sigkill_mid_load_recovers(world, service, spec):
    """SIGKILL a replica while a client drives load: requests reroute to
    the survivor (no exception, no wrong prediction), the supervisor
    respawns the slot, and its keys come back to it."""
    graphs = world["graphs"]
    want = service.predict_all(graphs)
    tier2 = start_replicas(spec, 2, n_clients=1, flush_us=300.0,
                           start_timeout_s=240.0)
    sup = None
    try:
        sup = ReplicaSupervisor(tier2, heartbeat_s=0.25,
                                heartbeat_timeout_s=60.0,
                                restart_backoff_s=0.05,
                                start_timeout_s=240.0).start()
        client = ReplicaClient(tier2.client_handle(0),
                               local_cache=False, timeout_s=2.0,
                               cooldown_s=0.05)
        results, errs = [], []
        stop = threading.Event()

        def load():
            while not stop.is_set():
                try:
                    results.append(client.predict_all(graphs))
                except Exception as e:    # pragma: no cover - regression
                    errs.append(e)
                    return

        t = threading.Thread(target=load)
        t.start()
        time.sleep(0.5)
        os.kill(tier2.procs[0].pid, signal.SIGKILL)
        deadline = time.monotonic() + 240.0
        while time.monotonic() < deadline:
            st = sup.stats()
            if st["restarts_recovered"] >= 1 and not st["respawning"]:
                break
            time.sleep(0.25)
        stop.set()
        t.join(timeout=120.0)
        assert not t.is_alive()
        assert not errs
        assert results
        for r in results:
            for tgt in want:
                np.testing.assert_allclose(r[tgt], want[tgt], **PORT_TOL)
        assert client.health[0].timeout + client.health[0].reroutes >= 1
        st = sup.stats()
        assert st["restarts_total"] >= 1
        assert st["restarts_recovered"] >= 1
        assert any(rec["replica"] == 0 and rec["reason"] == "died"
                   for rec in st["restart_log"])
        assert all(tier2.alive())
        before = client.health[0].ok
        deadline = time.monotonic() + 30.0
        while client.health[0].ok == before and \
                time.monotonic() < deadline:
            time.sleep(0.5)
            client.predict_all(graphs)
        assert client.health[0].ok > before
        payloads = [p for p in client.replica_stats() if p]
        assert {p["replica_id"] for p in payloads} == {0, 1}
    finally:
        if sup is not None:
            sup.stop()
        tier2.stop()
