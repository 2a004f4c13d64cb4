"""The port's telemetry (``repro_torch.obs``) and its gateway metrics:
trace primitives, the metrics registry and its exporters, the drift
sentinel, tracing through the port's server and router (a trace-aware
fake transport), a live 2-replica CPU tier whose sampled requests
reconstruct complete span trees across processes, and the server's
``ServerMetrics`` and adaptive flush on a stub service. The same
registry gives the reference's Prometheus text and JSONL exactly, and
every field the registry adapters read exists in the port's server,
service, router, shared cache and supervisor. The reference's CLI case
waits for a port of ``launch/obs.py``."""
import json
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import models as RM
from repro.obs import export as R_EXPORT
from repro.obs import registry as R_REG
from repro.obs import trace as R_TRACE
from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import service as T_SVC
from repro_torch.core import tokenizer as TOK
from repro_torch.core.server import (CostModelServer, ServerMetrics,
                                     ServerOverloadedError)
from repro_torch.ir import samplers
from repro_torch.obs import (JsonlExporter, MetricsRegistry, TraceContext,
                             Tracer, assemble, completeness,
                             register_drift, register_router,
                             register_server, register_shared_cache,
                             register_supervisor, to_prometheus)
from repro_torch.obs import registry as T_REG
from repro_torch.obs.drift import Alarm, DriftMonitor, attach
from repro_torch.obs.trace import TraceRecorder, _new_id
from repro_torch.serving import (ReplicaClient, ReplicaSupervisor,
                                 ServiceSpec, SharedRowCache,
                                 start_replicas)
from repro_torch.serving import transport as T

CFG = CostModelConfig(name="obs-test", vocab_size=512, max_seq=64,
                      embed_dim=16, conv_channels=(16,) * 2,
                      fc_dims=(32,))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    graphs = [samplers.sample_graph(rng) for _ in range(24)]
    vocab = TOK.fit_vocab([TOK.graph_tokens(g, "ops") for g in graphs],
                          max_size=512)
    return graphs, vocab


@pytest.fixture(scope="module")
def service(corpus):
    _, vocab = corpus
    # the reference's initial params, as numpy
    params = jax.tree.map(np.asarray, RM.conv_init(
        jax.random.PRNGKey(5), CFG, heads=RM.DEFAULT_HEADS))
    stats = {t: {"mu": 0.3, "sigma": 1.7} for t in RM.DEFAULT_HEADS}
    return T_SVC.CostModelService("conv1d", CFG, params, vocab, stats,
                                  mode="ops", max_seq=64, max_batch=8,
                                  buckets=(32, 64),
                                  batch_ladder=(1, 2, 4, 8), device="cpu")


@pytest.fixture(scope="module")
def spec(service):
    return ServiceSpec.from_service(service)


# --------------------------------------------------- trace primitives
def test_new_ids_unique():
    assert len({_new_id() for _ in range(4096)}) == 4096


def test_trace_context_wire_roundtrip():
    ctx = TraceContext("t1", "s1")
    back = TraceContext.from_wire(ctx.to_wire())
    assert (back.trace_id, back.span_id) == ("t1", "s1")
    assert TraceContext.from_wire(None) is None
    assert TraceContext.from_wire(()) is None
    # the reference's contexts read the port's wire tuples and back
    theirs = R_TRACE.TraceContext.from_wire(ctx.to_wire())
    assert theirs.to_wire() == ctx.to_wire()


def test_tracer_head_sampling_rate():
    tr = Tracer(sample_every=4)
    hits = [tr.sample() for _ in range(100)]
    assert sum(c is not None for c in hits) == 25
    assert all(tr.sample(force=True) is not None for _ in range(3))


def test_span_tree_assembly_walk_and_completeness():
    tr = Tracer(sample_every=1, proc="t")
    root = tr.start("root", tr.sample())
    with tr.span("child-a", root.ctx) as a:
        tr.emit("grandchild", a.ctx, 0.001)
    tr.end(root, n=1)
    trees = assemble(tr.recorder.snapshot())
    assert len(trees) == 1
    tree = trees[root.trace_id]
    assert tree.complete
    assert completeness(trees) == 1.0
    assert [(d, s["name"]) for d, s in tree.walk()] == \
        [(0, "root"), (1, "child-a"), (2, "grandchild")]
    tr.emit("stray", TraceContext(root.trace_id, "no-such-span"), 0.0)
    trees = assemble(tr.recorder.snapshot())
    assert not trees[root.trace_id].complete
    assert completeness(trees) == 0.0


def test_span_trees_assemble_like_reference():
    """The reference's assembler reads the port's span records into the
    same trees (completeness, walk order, processes)."""
    tr = Tracer(sample_every=1, proc="port")
    for i in range(5):
        root = tr.start("root", tr.sample(), tags={"i": i})
        with tr.span("a", root.ctx) as a:
            tr.emit("b", a.ctx, 0.001 * i)
        if i == 3:
            tr.emit("orphan", TraceContext(root.trace_id, "gone"), 0.0)
        tr.end(root)
    recs = tr.recorder.snapshot()
    ours, theirs = assemble(recs), R_TRACE.assemble(recs)
    assert set(ours) == set(theirs)
    assert completeness(ours) == R_TRACE.completeness(theirs) == 0.8
    for tid in ours:
        assert [(d, s["span"]) for d, s in ours[tid].walk()] == \
            [(d, s["span"]) for d, s in theirs[tid].walk()]
        assert ours[tid].procs == theirs[tid].procs


def test_error_span_is_always_on():
    tr = Tracer(sample_every=1 << 30)
    assert tr.sample() is None
    ctx = tr.error_span("server.shed", None, pending=3)
    recs = tr.recorder.snapshot()
    assert len(recs) == 1
    assert recs[0]["status"] == "err"
    assert recs[0]["tags"]["forced"] == 1
    assert recs[0]["trace"] == ctx.trace_id


def test_recorder_bounded_and_take():
    rec = TraceRecorder(capacity=4)
    for i in range(6):
        rec.record_raw({"trace": f"t{i % 2}", "span": f"s{i}",
                        "parent": "", "name": "x", "proc": "p",
                        "t_wall": 0.0, "dur_s": 0.0, "status": "ok",
                        "tags": {}})
    assert len(rec) == 4
    assert rec.dropped == 2
    taken = rec.take(["t0"])
    assert all(r["trace"] == "t0" for r in taken)
    assert all(r["trace"] == "t1" for r in rec.snapshot())
    assert rec.take([]) == []


# ------------------------------------------------------------ registry
def _fill(reg):
    """The same instruments and sources in either package's registry."""
    reg.counter("server.requests").inc(7)
    reg.counter("reqs").inc(3)
    reg.gauge("drift.oov_rate").set(0.125)
    reg.gauge("depth").set(1.5)
    h = reg.histogram("lat")
    for v in (3.0, 1.0, 2.0, 10.0):
        h.observe(v)
    reg.add_source("svc", lambda: {"a": 1, "nested": {"b": 2.5},
                                   "flag": True, "skip": "string",
                                   "lst": [1, 2.5]})
    return reg


def test_registry_instruments_sources_and_schema():
    snap = _fill(MetricsRegistry()).snapshot()
    assert snap["schema"] == "repro.obs/v1"
    m = snap["metrics"]
    assert m["reqs"] == 3 and m["depth"] == 1.5
    assert m["lat.count"] == 4.0 and m["lat.mean"] == 4.0
    assert m["svc.a"] == 1 and m["svc.nested.b"] == 2.5
    assert m["svc.flag"] == 1 and "svc.skip" not in m
    assert m["svc.lst.1"] == 2.5


def test_registry_source_failure_never_raises():
    reg = MetricsRegistry()

    def bad():
        raise RuntimeError("source down")

    reg.add_source("bad", bad)
    reg.add_source("ok", lambda: {"x": 1})
    snap = reg.snapshot()
    assert snap["metrics"]["ok.x"] == 1
    assert snap["metrics"]["obs.source_errors"] == 1
    reg.add_source("bad", lambda: {"y": 2})
    snap = reg.snapshot()
    assert snap["metrics"]["bad.y"] == 2
    assert snap["metrics"]["obs.source_errors"] == 1


def test_prometheus_exposition_format():
    reg = MetricsRegistry()
    reg.counter("server.requests").inc(7)
    reg.gauge("drift.oov_rate").set(0.125)
    text = to_prometheus(reg.snapshot())
    assert "server_requests 7\n" in text
    assert "drift_oov_rate 0.125\n" in text
    assert text.rstrip().endswith("obs_snapshot_seq 1")


def test_prometheus_and_jsonl_match_reference(tmp_path):
    """The same registry contents give the reference's Prometheus text
    exactly, and JSONL lines equal but for the wall-clock stamp."""
    ours, theirs = _fill(MetricsRegistry()), _fill(R_REG.MetricsRegistry())
    a, b = ours.snapshot(), theirs.snapshot()
    assert to_prometheus(a) == R_EXPORT.to_prometheus(b)
    assert {k: v for k, v in a.items() if k != "ts"} == \
        {k: v for k, v in b.items() if k != "ts"}
    lines = []
    for reg, cls, name in ((ours, JsonlExporter, "t.jsonl"),
                           (theirs, R_EXPORT.JsonlExporter, "r.jsonl")):
        path = str(tmp_path / name)
        cls(path, reg, interval_s=60.0).tick()
        rec = json.loads(open(path).read())
        rec.pop("ts")
        lines.append(rec)
    assert lines[0] == lines[1]


def test_jsonl_exporter_writes_metrics_and_spans(tmp_path):
    reg = MetricsRegistry()
    reg.counter("n").inc()
    tr = Tracer(sample_every=1)
    with tr.span("op", tr.sample()):
        pass
    path = str(tmp_path / "obs.jsonl")
    exp = JsonlExporter(path, reg, tracer=tr, interval_s=60.0)
    exp.tick()
    kinds = [json.loads(line)["kind"]
             for line in open(path) if line.strip()]
    assert kinds.count("metrics") == 1
    assert kinds.count("span") == 1
    assert len(tr.recorder) == 0
    assert exp.lines_written == 2


# --------------------------------------------------------------- drift
def test_alarm_hysteresis_never_flaps_in_band():
    a = Alarm(hi=0.25, lo=0.10)
    assert not a.update(0.2)
    assert a.update(0.3)
    assert a.update(0.15)
    assert not a.update(0.05)
    assert not a.update(0.2)


def test_drift_monitor_scores_and_gauges():
    def oracle(g):
        return {"latency_us": 10.0 * g}

    mon = DriftMonitor(oracle, targets=("latency_us",), sample_every=1,
                       score_interval_s=0.0)
    g0 = mon.gauges()
    assert g0["spearman.latency_us"] == 0.0
    assert g0["window_n.latency_us"] == 0
    assert g0["oov_rate"] == 0.0 and g0["oov_alarm"] == 0
    graphs = list(range(1, 9))
    mon.observe_batch(graphs, {"latency_us": np.array(
        [10.0 * g + 0.5 for g in graphs])})
    mon.flush()
    g1 = mon.gauges()
    assert g1["observed"] == 8 and g1["scored"] == 8
    assert g1["window_n.latency_us"] == 8
    assert g1["spearman.latency_us"] == pytest.approx(1.0)
    assert g1["mae.latency_us"] == pytest.approx(0.5)


def test_drift_note_text_feeds_ewma_alarms():
    mon = DriftMonitor(lambda g: {}, oov_alarm=(0.5, 0.2),
                       unk_alarm=(0.5, 0.2), ewma_alpha=1.0)
    mon.note_text(0.6, 0.0)
    g = mon.gauges()
    assert g["oov_alarm"] == 1 and g["unk_alarm"] == 0
    mon.note_text(0.1, 0.0)
    assert mon.gauges()["oov_alarm"] == 0


def test_drift_default_oracle_is_the_analyzers(corpus):
    """Without an oracle the monitor scores against the port's analyzer
    oracle; the served heads it models get windows."""
    graphs, _ = corpus
    mon = DriftMonitor(targets=("latency_us",), sample_every=1,
                       score_interval_s=0.0)
    mon.observe_batch(graphs[:4], {"latency_us": np.arange(4.0)})
    mon.flush()
    g = mon.gauges()
    assert g["scored"] == 4 and g["oracle_errors"] == 0
    assert g["window_n.latency_us"] == 4


def test_drift_attach_wires_service_hook(service):
    mon = attach(service, DriftMonitor(
        lambda g: {}, sample_every=1, score_interval_s=0.0))
    try:
        assert service.drift is mon
        assert mon.targets == tuple(service.heads)
        service.predict_all([samplers.sample_graph(
            np.random.default_rng(3))])
        assert mon.observed == 1
    finally:
        mon.stop()
        service.drift = None


# ------------------------------------------- in-process traced gateway
def test_server_predict_all_builds_complete_tree(corpus, service):
    graphs, _ = corpus
    tracer = Tracer(sample_every=1, proc="gw")
    server = CostModelServer(service, max_batch=8, flush_us=300.0,
                             tracer=tracer)
    server.start(warmup=False)
    try:
        with service._cache_lock:
            service._cache.clear()
        server.predict_all(graphs[:6])
    finally:
        server.stop()
    trees = assemble(tracer.recorder.snapshot())
    assert len(trees) == 1
    tree = next(iter(trees.values()))
    assert tree.complete
    assert {"client.predict_all", "server.queue",
            "server.forward"} <= {s["name"] for s in tree.spans}
    root = tree.roots[0]
    assert root["name"] == "client.predict_all"
    assert root["tags"]["n_graphs"] == 6


def test_registry_adapts_live_server(corpus, service):
    graphs, _ = corpus
    server = CostModelServer(service, max_batch=8, flush_us=300.0)
    server.start(warmup=False)
    reg = MetricsRegistry()
    register_server(reg, server)
    mon = DriftMonitor(lambda g: {}, targets=tuple(service.heads))
    register_drift(reg, mon)
    try:
        server.predict_all(graphs[:4])
        m = reg.snapshot()["metrics"]
        assert m["server.requests"] >= 4
        for t in service.heads:
            assert f"drift.spearman.{t}" in m
        assert "drift.oov_rate" in m
    finally:
        server.stop()


def test_registry_adapters_read_the_ports_fields(corpus, service, spec):
    """Every source the registry adapts answers with the reference's
    field names: the port's server, service and tracer give the
    reference registry's keys, and the router, shared cache and
    supervisor sources flatten without a source error."""
    from repro.core import service as R_SVC
    from repro.core import tokenizer as R_TOK
    from repro.core.server import CostModelServer as R_Server
    from repro.ir import samplers as R_SMP
    graphs, _ = corpus
    r_rng = np.random.default_rng(7)
    r_graphs = [R_SMP.sample_graph(r_rng) for _ in range(24)]
    r_vocab = R_TOK.fit_vocab([R_TOK.graph_tokens(g, "ops")
                               for g in r_graphs], max_size=512)
    ref = R_SVC.CostModelService(
        "conv1d", CFG, jax.tree.map(jax.numpy.asarray, service.params),
        r_vocab, service.norm_stats, mode="ops", max_seq=64, max_batch=8,
        buckets=(32, 64), batch_ladder=(1, 2, 4, 8))
    snaps = []
    for svc, gs, server_cls, reg_mod, tracer_cls in (
            (service, graphs, CostModelServer, T_REG, Tracer),
            (ref, r_graphs, R_Server, R_REG, R_TRACE.Tracer)):
        server = server_cls(svc, max_batch=8, flush_us=300.0)
        server.start(warmup=False)
        try:
            server.predict_all(gs[:4])
            reg = reg_mod.MetricsRegistry()
            reg_mod.register_server(reg, server)
            reg_mod.register_service(reg, svc)
            reg_mod.register_tracer(reg, tracer_cls(sample_every=4))
            snaps.append(reg.snapshot()["metrics"])
        finally:
            server.stop()
    assert set(snaps[0]) == set(snaps[1])
    assert snaps[0]["obs.source_errors"] == 0
    reg = MetricsRegistry()
    client = ReplicaClient(transport=TracedFakeTransport(
        2, lambda r, ks: ("ok",)), spec=spec)
    client.predict_all(graphs[:3])
    register_router(reg, client)
    register_shared_cache(reg, SharedRowCache(3, n_slots=16))

    class _Tier:                       # what the supervisor's stats read
        max_replicas, n_replicas, active = 2, 2, None
    register_supervisor(reg, ReplicaSupervisor(_Tier()))
    m = reg.snapshot()["metrics"]
    assert m["obs.source_errors"] == 0
    for key in ("router.shed_count", "router.failures.timeout",
                "router.unhealthy_now", "router.local_cache.hits",
                "router.health.0.cooldown_remaining_s",
                "shared_cache.fill", "shared_cache.lock_timeouts",
                "supervisor.restarts_total", "supervisor.recovery_s_max"):
        assert key in m, key


# ------------------------------- traced router over a fake transport
def _row_for(key, n_heads=3):
    h = int(key[:8], 16) if len(key) == 40 else abs(hash(key))
    return (np.arange(n_heads, dtype=np.float32) + h % 97) / 97.0


class TracedFakeTransport:
    """A fake tier that tolerates the optional 7th MSG_REQ element and,
    for traced requests, ships back a replica-side span on MSG_RES."""

    def __init__(self, n_replicas, behavior, n_heads=3):
        import queue as _q
        self.n_replicas = n_replicas
        self.client_id = 0
        self.behavior = behavior
        self.n_heads = n_heads
        self.q = _q.Queue()
        self.sent = []

    def send(self, replica, msg):
        if msg[0] != T.MSG_REQ:
            return
        _, _client, bid, keys, _lens, _ids = msg[:6]
        wire = T.req_trace(msg)
        self.sent.append((replica, list(keys), wire))
        act = self.behavior(replica, keys)
        if act[0] == "ok":
            rows_b, nh = T.pack_rows(
                [_row_for(k, self.n_heads) for k in keys])
            res = (T.MSG_RES, bid, list(range(len(keys))), rows_b, nh)
            if wire is not None:
                res = res + ([{
                    "trace": wire[0], "span": f"fake-{bid}",
                    "parent": wire[1], "name": "replica.batch",
                    "proc": "fake-replica", "t_wall": time.time(),
                    "dur_s": 0.001, "status": "ok", "tags": {}}],)
            self.q.put(res)
        elif act[0] == "overload":
            self.q.put((T.MSG_OVERLOAD, bid, list(range(len(keys))),
                        act[1]))
        elif act[0] == "err":
            self.q.put((T.MSG_ERR, bid, list(range(len(keys))),
                        "scripted failure"))

    def recv(self, timeout):
        return self.q.get(timeout=timeout)


@pytest.fixture()
def traced_client(spec):
    def make(behavior, **kw):
        tr = TracedFakeTransport(4, behavior)
        kw.setdefault("backoff_s", 0.001)
        kw.setdefault("timeout_s", 0.25)
        kw.setdefault("cooldown_s", 0.02)
        kw.setdefault("local_cache", False)
        tracer = Tracer(sample_every=1, proc="client")
        return ReplicaClient(transport=tr, spec=spec, tracer=tracer,
                             **kw), tr, tracer
    return make


def test_router_traced_request_tree_spans_processes(corpus,
                                                    traced_client):
    graphs, _ = corpus
    client, tr, tracer = traced_client(lambda r, ks: ("ok",))
    client.predict_all(graphs[:4])
    trees = assemble(tracer.recorder.snapshot())
    assert len(trees) == 1
    tree = next(iter(trees.values()))
    assert tree.complete
    assert {"client.predict_all", "client.featurize", "router.fetch",
            "router.rpc", "replica.batch"} <= {s["name"]
                                               for s in tree.spans}
    assert "fake-replica" in tree.procs
    assert all(w is not None and w[0] == tree.trace_id
               for _, _, w in tr.sent)


def test_untraced_requests_keep_classic_wire_shape(corpus, spec):
    graphs, _ = corpus
    tr = TracedFakeTransport(4, lambda r, ks: ("ok",))
    client = ReplicaClient(transport=tr, spec=spec, local_cache=False,
                           backoff_s=0.001, timeout_s=0.25)
    client.predict_all(graphs[:4])
    assert tr.sent and all(w is None for _, _, w in tr.sent)


def test_trace_id_survives_retry_and_failover(corpus, traced_client):
    graphs, _ = corpus
    state = {"n": 0}

    def flaky(r, ks):
        state["n"] += 1
        return ("overload", 0.001) if state["n"] == 1 else ("ok",)

    client, tr, tracer = traced_client(flaky)
    client.predict_all(graphs[:3])
    trees = assemble(tracer.recorder.snapshot())
    assert len(trees) == 1
    tree = next(iter(trees.values()))
    assert tree.complete
    rpcs = [s for s in tree.spans if s["name"] == "router.rpc"]
    assert len(rpcs) >= 2
    assert {s["status"] for s in rpcs} == {"overload", "ok"}
    assert len({s["trace"] for s in rpcs}) == 1


def test_shed_emits_error_span_under_the_same_trace(corpus,
                                                    traced_client):
    graphs, _ = corpus
    client, tr, tracer = traced_client(
        lambda r, ks: ("overload", 0.001), max_retries=1)
    with pytest.raises(ServerOverloadedError):
        client.predict_all(graphs[:2])
    trees = assemble(tracer.recorder.snapshot())
    assert len(trees) == 1
    tree = next(iter(trees.values()))
    assert tree.complete
    by_name = {s["name"]: s for s in tree.spans}
    assert by_name["router.shed"]["status"] == "err"
    assert by_name["router.fetch"]["status"] == "shed"
    assert by_name["client.predict_all"]["status"] == "err"


# ------------------------------------------------- live 2-replica tier
@pytest.fixture(scope="module")
def traced_tier(spec):
    tier = start_replicas(spec, 2, n_clients=1, flush_us=300.0,
                          start_timeout_s=240.0, obs_trace=True)
    yield tier
    tier.stop()


def test_live_tier_span_trees_complete_across_processes(corpus,
                                                        traced_tier):
    """>= 99% of sampled requests through a spawned tier reconstruct
    complete span trees client-side, over a cold pass (forward spans)
    and a warm pass (replica-LRU hit spans)."""
    graphs, _ = corpus
    tracer = Tracer(sample_every=1, proc="client")
    client = ReplicaClient(traced_tier.client_handle(0),
                           local_cache=False, tracer=tracer)
    client.clear_caches()
    for g in graphs:
        client.predict_all([g])
    for g in graphs[:8]:
        client.predict_all([g])
    trees = assemble(tracer.recorder.snapshot())
    assert len(trees) == len(graphs) + 8
    assert completeness(trees) >= 0.99
    assert client.shed_count == 0
    assert sum(any(p.startswith("replica-") for p in t.procs)
               for t in trees.values()) == len(trees)
    names = {s["name"] for t in trees.values() for s in t.spans}
    assert {"client.predict_all", "router.rpc", "replica.batch",
            "server.queue", "server.forward"} <= names


def test_live_tier_stats_expose_obs_and_cooldown(corpus, traced_tier):
    graphs, _ = corpus
    client = ReplicaClient(traced_tier.client_handle(0),
                           local_cache=False)
    client.predict_all(graphs[:4])
    st = client.stats()
    assert "cooldown_remaining_s" in st["health"][0]
    assert st["failures"]["overload"] == 0
    assert st["unhealthy_now"] == 0
    rstats = [s for s in client.replica_stats() if s]
    assert rstats and all("obs" in s for s in rstats)
    assert all(s["obs"]["spans_dropped"] == 0 for s in rstats)


# ------------------------------------ gateway metrics (stub service)
class StubService:
    """Minimal duck-typed CostModelService: fixed bucket, zero rows."""

    buckets = (8,)
    batch_ladder = (1, 2, 4, 8)
    max_batch = 8
    heads = ("latency", "regs")

    def __init__(self):
        self.forwards = 0

    def _ladder_batch(self, n):
        return n

    def warmup(self, batch_sizes=None):
        pass

    def cache_lookup(self, key):
        return None

    def phase_stats(self):
        return {"hash_s": 1.5, "encode_s": 0.25, "oov_rate": 0.125}

    def forward_entries_dispatch(self, entries):
        self.forwards += 1
        return entries

    def forward_entries_collect(self, entries):
        return np.zeros((len(entries), len(self.heads)), np.float32)


def _ids():
    return np.zeros(8, np.int32)


def test_percentiles_match_numpy_on_known_sequence():
    m = ServerMetrics()
    lats = [float(v) for v in range(1, 101)]
    m.observe_latencies(lats)
    snap = m.snapshot()
    for name, q in (("p50", 50), ("p95", 95), ("p99", 99)):
        assert snap[f"latency_{name}_us"] == pytest.approx(
            float(np.percentile(lats, q)))
    assert snap["latency_p50_us"] < snap["latency_p95_us"] \
        < snap["latency_p99_us"]


def test_empty_reservoir_reports_zero_percentiles():
    snap = ServerMetrics().snapshot()
    for name in ("p50", "p95", "p99"):
        assert snap[f"latency_{name}_us"] == 0.0


def test_reservoir_bounded_and_keeps_newest():
    m = ServerMetrics(reservoir=8192)
    m.observe_latencies([float(v) for v in range(10_000)])
    assert len(m._lat_us) == 8192
    kept = np.arange(1808, 10_000, dtype=np.float64)
    assert m.snapshot()["latency_p50_us"] == pytest.approx(
        float(np.percentile(kept, 50)))
    assert min(m._lat_us) == 1808.0


def test_custom_reservoir_size():
    m = ServerMetrics(reservoir=16)
    m.observe_latencies([float(v) for v in range(100)])
    assert list(m._lat_us) == [float(v) for v in range(84, 100)]


def test_note_request_counters_and_hit_rate():
    m = ServerMetrics()
    m.note_request(cache_hit=True)
    m.note_request(coalesced=True, queue_depth=3)
    m.note_request(shed=True)
    m.note_request(queue_depth=7)
    snap = m.snapshot(queue_depth=2)
    assert snap["requests"] == 4
    assert snap["cache_hits"] == 1
    assert snap["cache_hit_rate"] == pytest.approx(0.25)
    assert snap["coalesced"] == 1
    assert snap["shed"] == 1
    assert snap["queue_depth"] == 2
    assert snap["max_queue_depth"] == 7


def test_server_metrics_snapshot_matches_reference():
    """The same observations give the reference's snapshot, key for key
    and value for value."""
    from repro.core.server import ServerMetrics as R_Metrics
    snaps = []
    for m in (ServerMetrics(reservoir=64), R_Metrics(reservoir=64)):
        m.observe_latencies([float(v) * 1.5 for v in range(100)])
        m.note_request(cache_hit=True)
        m.note_request(coalesced=True, queue_depth=5)
        m.note_request(shed=True)
        m.count("batches", 3)
        m.phase_source = lambda: {"hash_s": 2.0, "oov_rate": 0.25}
        m.gauges["flush_us_effective"] = 321.0
        snaps.append(m.snapshot(queue_depth=1))
    assert snaps[0] == snaps[1]


def test_phase_source_and_gauges_travel_in_snapshot():
    m = ServerMetrics()
    m.phase_source = lambda: {"hash_s": 2.0, "truncated": 3,
                              "oov_rate": 0.25}
    m.gauges["flush_us_effective"] = 123.0
    snap = m.snapshot()
    assert snap["phase_hash_s"] == 2.0
    assert snap["phase_truncated"] == 3
    assert snap["phase_oov_rate"] == 0.25
    assert snap["flush_us_effective"] == 123.0


def test_queue_depth_gauge_and_shed_under_backpressure():
    server = CostModelServer(StubService(), max_batch=8, flush_us=500.0,
                             max_queue=4)
    server._running = True             # no worker: the queue only grows
    try:
        for i in range(4):
            server.submit_entry(f"k{i}", _ids())
        with pytest.raises(ServerOverloadedError) as ei:
            server.submit_entry("k-over", _ids())
        assert ei.value.retry_after_s > 0.0
        snap = server.metrics_snapshot()
        assert snap["queue_depth"] == 4
        assert snap["max_queue_depth"] == 4
        assert snap["shed"] == 1
        assert snap["requests"] == 5
    finally:
        server._running = False


def test_coalesce_counter_on_duplicate_inflight_key():
    server = CostModelServer(StubService(), max_batch=8, flush_us=500.0)
    server._running = True
    try:
        server.submit_entry("same", _ids())
        server.submit_entry("same", _ids())
        snap = server.metrics_snapshot()
        assert snap["coalesced"] == 1
        assert snap["queue_depth"] == 1
        assert server._n_pending == 2
    finally:
        server._running = False


def test_stub_end_to_end_resolves_and_observes_latency():
    svc = StubService()
    server = CostModelServer(svc, max_batch=4, flush_us=200.0)
    with server:
        futs = [server.submit_entry(f"g{i}", _ids()) for i in range(4)]
        rows = [f.result(timeout=10.0) for f in futs]
    assert all(r.shape == (2,) for r in rows)
    snap = server.metrics_snapshot()
    assert snap["batches"] >= 1
    assert snap["batch_occupancy"] > 0
    assert snap["latency_p50_us"] > 0
    assert snap["phase_hash_s"] == 1.5
    assert svc.forwards >= 1


def _adaptive_server(**kw):
    kw.setdefault("flush_us", 1000.0)
    kw.setdefault("adaptive_flush", True)
    return CostModelServer(StubService(), max_batch=8, **kw)


def test_adaptive_flush_defaults_to_budget_before_any_arrivals():
    assert _adaptive_server()._effective_flush_us_locked() == 1000.0


def test_adaptive_flush_scales_with_arrival_rate():
    s = _adaptive_server(adaptive_k=8.0)
    s._arrival_ewma_us = 25.0
    assert s._effective_flush_us_locked() == pytest.approx(200.0)
    assert s.metrics.gauges["flush_us_effective"] == pytest.approx(200.0)
    assert s.metrics.snapshot()["flush_us_effective"] == \
        pytest.approx(200.0)


def test_adaptive_flush_collapses_when_arrivals_outpace_budget():
    s = _adaptive_server()
    s._arrival_ewma_us = 5000.0
    assert s._effective_flush_us_locked() == s.flush_us_min
    assert s.flush_us_min < s.flush_us


def test_adaptive_flush_clamped_to_budget():
    s = _adaptive_server(adaptive_k=8.0)
    s._arrival_ewma_us = 900.0
    assert s._effective_flush_us_locked() == 1000.0


def test_disabled_adaptive_flush_is_constant():
    s = CostModelServer(StubService(), max_batch=8, flush_us=750.0)
    s._arrival_ewma_us = 10.0
    assert s._effective_flush_us_locked() == 750.0


def test_arrival_ewma_clamps_idle_gaps():
    s = _adaptive_server()
    s._note_arrival_locked(0.0)
    s._note_arrival_locked(60.0)
    assert s._arrival_ewma_us == pytest.approx(8 * s.flush_us)
    before = s._arrival_ewma_us
    s._note_arrival_locked(60.0001)
    assert s._arrival_ewma_us < before
