"""The port's supervision, graceful degradation and fault harness:
scale policy and restart budget units, fault-plan determinism and
FaultyTransport's message faults, shared-cache torn-write and
wedged-lock degradation, the router's analyzer-oracle floor, deadline
budget, decorrelated jitter and ring resizing (fake transports, no
processes), and one spawned CPU tier end to end: wedge detection and
in-slot respawn, then signal-driven scale-up and scale-down. The pure
parts (fault schedules, seeded RNGs, slot corruption, the oracle rows)
are held to the reference's exactly."""
import hashlib
import multiprocessing as mp
import os
import queue
import random
import signal
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import models as RM
from repro.ir import analyzers as R_AN
from repro.serving import faults as R_FAULTS
from repro.serving import shared_cache as R_SC
from repro.serving import supervisor as R_SUP
from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import service as T_SVC
from repro_torch.core import tokenizer as TOK
from repro_torch.core.server import ServerOverloadedError
from repro_torch.ir import samplers
from repro_torch.obs import MetricsRegistry, register_supervisor
from repro_torch.serving import (FaultEvent, FaultPlan, FaultyTransport,
                                 ReplicaClient, ReplicaSupervisor,
                                 RestartBudget, ScalePolicy, ServiceSpec,
                                 SharedRowCache, start_replicas)
from repro_torch.serving import faults as T_FAULTS
from repro_torch.serving import transport as T
from repro_torch.serving.faults import corrupt_slot
from repro_torch.serving.shared_cache import _DIGEST

CFG = CostModelConfig(name="sup-test", vocab_size=512, max_seq=64,
                      embed_dim=16, conv_channels=(16,) * 2,
                      fc_dims=(32,))
PORT_TOL = dict(rtol=1e-6, atol=1e-6)     # port against port, across
#                                           processes and thread counts


def _sha_keys(n, salt=""):
    return [hashlib.sha1(f"{salt}k{i}".encode()).hexdigest()
            for i in range(n)]


def _entries(n, salt=""):
    return [(k, np.arange(4, dtype=np.int32))
            for k in _sha_keys(n, salt=salt)]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(23)
    graphs = [samplers.sample_graph(rng) for _ in range(16)]
    vocab = TOK.fit_vocab([TOK.graph_tokens(g, "ops") for g in graphs],
                          max_size=512)
    return graphs, vocab


@pytest.fixture(scope="module")
def service(corpus):
    _, vocab = corpus
    # the reference's initial params, as numpy
    params = jax.tree.map(np.asarray, RM.conv_init(
        jax.random.PRNGKey(5), CFG, heads=RM.DEFAULT_HEADS))
    stats = {t: {"mu": 0.2, "sigma": 1.3} for t in RM.DEFAULT_HEADS}
    return T_SVC.CostModelService("conv1d", CFG, params, vocab, stats,
                                  mode="ops", max_seq=64, max_batch=8,
                                  buckets=(32, 64),
                                  batch_ladder=(1, 2, 4, 8), device="cpu")


@pytest.fixture(scope="module")
def spec(service):
    return ServiceSpec.from_service(service)


# --------------------------------------------------- scale policy (unit)
def test_scale_policy_scales_up_on_pressure():
    p = ScalePolicy(min_replicas=1, max_replicas=4)
    assert p.decide(2, [{"shed_delta": 1.0}]) == 3
    assert p.decide(2, [{"queue_depth": 100.0}]) == 3
    assert p.decide(4, [{"shed_delta": 5.0}]) == 4
    assert p.decide(2, [{"queue_depth": 0.0,
                         "arrival_per_s": 3.0}]) == 2
    assert p.decide(2, []) == 2
    assert p.decide(2, [{"queue_depth": 0.0, "arrival_per_s": 3.0}],
                    router={"shed_count": 1}) == 3
    assert p.decide(2, [{"queue_depth": 0.0, "arrival_per_s": 3.0}],
                    router={"shed_count": 0, "unhealthy_now": 1}) == 3


def test_scale_policy_scale_down_waits_settle():
    p = ScalePolicy(min_replicas=1, max_replicas=4, settle_ticks=3)
    quiet = [{"arrival_per_s": 0.0}]
    assert p.decide(3, quiet) == 3
    assert p.decide(3, quiet) == 3
    assert p.decide(3, quiet) == 2
    assert p.decide(2, quiet) == 2
    assert p.decide(2, [{"arrival_per_s": 10.0}]) == 2
    assert p.decide(2, quiet) == 2
    assert p.decide(2, quiet) == 2
    assert p.decide(2, quiet) == 1
    assert p.decide(1, quiet) == 1


def test_scale_policy_decisions_match_reference():
    """The same signal sequence gives the same targets in both."""
    rng = random.Random(4)
    ours = ScalePolicy(min_replicas=1, max_replicas=6, settle_ticks=2)
    theirs = R_SUP.ScalePolicy(min_replicas=1, max_replicas=6,
                               settle_ticks=2)
    active = 3
    for _ in range(200):
        sig = [{"arrival_per_s": rng.choice([0.0, 0.1, 5.0]),
                "queue_depth": rng.choice([0.0, 10.0, 50.0]),
                "shed_delta": rng.choice([0.0, 0.0, 0.0, 1.0])}
               for _ in range(rng.randint(0, 3))]
        router = rng.choice([None, {"shed_count": 0, "unhealthy_now": 0},
                             {"shed_count": 1}])
        a = ours.decide(active, sig, router)
        assert a == theirs.decide(active, sig, router)
        active = a


# ------------------------------------------------- restart budget (unit)
def test_restart_budget_escalates_and_trips():
    b = RestartBudget(backoff_s=0.5, max_restarts=3, window_s=60.0,
                      cap_s=4.0)
    assert b.next_delay(0.0) == 0.0
    b.note_restart(0.0)
    assert b.next_delay(1.0) == 0.5
    b.note_restart(1.0)
    assert b.next_delay(2.0) == 1.0
    b.note_restart(2.0)
    assert b.crash_looping(3.0)
    assert not b.crash_looping(100.0)
    assert b.next_delay(100.0) == 0.0


def test_restart_budget_caps_delay():
    b = RestartBudget(backoff_s=1.0, max_restarts=10, window_s=1e6,
                      cap_s=3.0)
    for t in range(6):
        b.note_restart(float(t))
    assert b.next_delay(6.0) == 3.0


# ---------------------------------------------------- fault plan (unit)
def test_fault_plan_fires_in_order_once():
    plan = FaultPlan([FaultEvent(at=5, kind="drop"),
                      FaultEvent(at=1, kind="kill", replica=2),
                      FaultEvent(at=5, kind="dup", replica=1)], seed=7)
    assert [e.kind for e in plan.events] == ["kill", "drop", "dup"]
    assert plan.due(0) == []
    assert [e.kind for e in plan.due(3)] == ["kill"]
    assert plan.due(3) == []
    assert [e.kind for e in plan.due(5)] == ["drop", "dup"]
    assert plan.exhausted


def test_fault_plan_seeded_rng_replayable():
    assert FaultPlan([], seed=123).rng.random() == \
        FaultPlan([], seed=123).rng.random()


def _chaos_events(mod):
    """The chaos gate's schedule, built from ``mod``'s FaultEvent."""
    E = mod.FaultEvent
    return [E(at=6, kind="corrupt", key="a" * 40),
            E(at=10, kind="kill", replica=0),
            E(at=30, kind="wedge", replica=1),
            E(at=46, kind="drop", replica=0, count=2),
            E(at=56, kind="delay", replica=1, count=2, delay_s=0.05),
            E(at=64, kind="dup", replica=0, count=2),
            E(at=70, kind="unwedge", replica=1)]


def test_fault_plan_schedule_matches_reference():
    """The same events and seed fire at the same send ops, in the same
    order, with the same seeded RNG stream."""
    ours = FaultPlan(list(reversed(_chaos_events(T_FAULTS))), seed=11)
    theirs = R_FAULTS.FaultPlan(list(reversed(_chaos_events(R_FAULTS))),
                                seed=11)
    for op in range(80):
        a, b = ours.due(op), theirs.due(op)
        assert [(e.at, e.kind, e.replica, e.count, e.delay_s, e.key)
                for e in a] == [(e.at, e.kind, e.replica, e.count,
                                 e.delay_s, e.key) for e in b]
    assert ours.exhausted and theirs.exhausted
    assert [ours.rng.random() for _ in range(5)] == \
        [theirs.rng.random() for _ in range(5)]


class _RecorderTransport:
    """Inner transport that just records sends (FaultyTransport duck)."""

    def __init__(self, n=4):
        self.n_replicas = n
        self.client_id = 0
        self.sent = []

    def send(self, replica, msg):
        self.sent.append((replica, msg))

    def recv(self, timeout):
        raise queue.Empty


def _req(key="k"):
    return (T.MSG_REQ, 0, 1, [key], b"", b"")


def test_faulty_transport_message_faults():
    inner = _RecorderTransport()
    plan = FaultPlan([FaultEvent(at=0, kind="drop", replica=0),
                      FaultEvent(at=1, kind="dup", replica=1),
                      FaultEvent(at=2, kind="delay", replica=2,
                                 delay_s=0.05)])
    ft = FaultyTransport(inner, plan)
    ft.send(0, _req("a"))                # dropped
    assert inner.sent == []
    ft.send(1, _req("b"))                # duplicated
    assert len(inner.sent) == 2
    ft.send(2, _req("c"))                # delayed: lands later
    assert len(inner.sent) == 2
    deadline = time.monotonic() + 5.0
    while len(inner.sent) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(inner.sent) == 3 and inner.sent[-1][0] == 2
    kinds = [e["kind"] for e in ft.log]
    for k in ("drop", "dropped", "dup", "duplicated", "delay",
              "delayed"):
        assert k in kinds
    assert plan.exhausted


def test_faulty_transport_spares_control_traffic():
    inner = _RecorderTransport()
    ft = FaultyTransport(inner, FaultPlan(
        [FaultEvent(at=0, kind="drop", replica=0, count=2)]))
    ft.send(0, (T.MSG_STATS, 0, 1))      # control RPC: never dropped
    assert len(inner.sent) == 1
    ft.send(0, _req("x"))                # the request eats the drop
    assert len(inner.sent) == 1


def test_faulty_transport_process_faults_need_tier():
    ft = FaultyTransport(_RecorderTransport(), FaultPlan(
        [FaultEvent(at=0, kind="kill", replica=0)]))
    ft.send(0, _req())
    assert ft.log[0]["kind"] == "kill"
    assert ft.log[0]["applied"] is False


# -------------------------------------- shared cache hardening (unit)
def test_corrupt_slot_detected_by_crc():
    c = SharedRowCache(n_heads=3, n_slots=64)
    key = "d" * 40
    c.put(key, np.array([1.0, 2.0, 3.0], np.float32))
    assert corrupt_slot(c, key, random.Random(5))
    assert c.get(key) is None
    assert c.torn_drops == 1
    assert c.get(key) is None
    assert c.torn_drops == 1
    assert not corrupt_slot(c, "e" * 40)


def test_corrupt_slot_bytes_match_reference():
    """The seeded garbage lands on the same bytes in both tables, and
    both read the torn slot as a miss."""
    ours, theirs = SharedRowCache(3, n_slots=32), R_SC.SharedRowCache(
        3, n_slots=32)
    for k in _sha_keys(6):
        row = np.arange(3, dtype=np.float32) + len(k)
        ours.put(k, row)
        theirs.put(k, row)
    key = _sha_keys(6)[2]
    assert corrupt_slot(ours, key, random.Random(9))
    assert R_FAULTS.corrupt_slot(theirs, key, random.Random(9))
    assert bytes(ours._buf) == bytes(theirs._buf)
    assert ours.get(key) is None and theirs.get(key) is None
    assert bytes(ours._buf) == bytes(theirs._buf)


def test_faulty_transport_corrupts_shared_cache():
    c = SharedRowCache(n_heads=2, n_slots=32)
    c.put("f" * 40, np.array([5.0, 6.0], np.float32))
    ft = FaultyTransport(_RecorderTransport(), FaultPlan(
        [FaultEvent(at=0, kind="corrupt", key="f" * 40)]),
        shared_cache=c)
    ft.send(0, _req())
    assert ft.log[0]["applied"] is True
    assert c.get("f" * 40) is None


def test_shared_cache_torn_write_reads_as_miss():
    c = SharedRowCache(n_heads=2, n_slots=32)
    c.put("c" * 40, np.array([9.0, -9.0], np.float32))
    view = c._view()
    s = next(i for i in range(c.n_slots) if view[i][0])
    view[s][1 + _DIGEST] ^= 0xFF         # flip one row byte
    assert c.get("c" * 40) is None
    assert c.torn_drops == 1


def test_shared_cache_wedged_lock_degrades_and_recovers():
    c = SharedRowCache(n_heads=2, n_slots=32, lock_timeout_s=0.05)
    c.put("a" * 40, np.array([1.0, 2.0], np.float32))
    assert c._lock.acquire()             # simulate a dead holder
    assert c.get("a" * 40) is None
    c.put("b" * 40, np.array([3.0, 4.0], np.float32))   # skipped
    assert c.fill() == -1
    assert c.clear() is False
    assert c.lock_timeouts >= 3
    assert c.recover(timeout_s=0.05) is True
    np.testing.assert_array_equal(c.get("a" * 40), [1.0, 2.0])
    assert c.get("b" * 40) is None
    assert c.recover(timeout_s=0.05) is False
    st = c.stats()
    assert st["lock_timeouts"] >= 3 and st["fill"] == 1


# ------------------------------------ degradation ladder (fake tier)
class _ScriptedTransport:
    """Uniform-fate fake tier: every request is answered "ok" (constant
    rows), shed with MSG_OVERLOAD, or silently dropped."""

    def __init__(self, n_replicas=2, mode="overload", n_heads=3):
        self.n_replicas = n_replicas
        self.client_id = 0
        self.mode = mode
        self.n_heads = n_heads
        self.q = queue.Queue()
        self.reqs = []

    def send(self, replica, msg):
        if msg[0] != T.MSG_REQ:
            return
        _, _c, bid, keys, _l, _i = msg
        self.reqs.append((replica, list(keys)))
        if self.mode == "ok":
            rows_b, nh = T.pack_rows(
                [np.full(self.n_heads, 0.5, np.float32) for _ in keys])
            self.q.put((T.MSG_RES, bid, list(range(len(keys))),
                        rows_b, nh))
        elif self.mode == "overload":
            self.q.put((T.MSG_OVERLOAD, bid, list(range(len(keys))),
                        0.0))

    def recv(self, timeout):
        return self.q.get(timeout=timeout)


def test_router_oracle_fallback_matches_analyzers(corpus, spec):
    """Degraded predictions are the reference's analyzer oracle (the
    port's analyzers are a copy), never cached."""
    graphs, _ = corpus
    client = ReplicaClient(transport=_ScriptedTransport(), spec=spec,
                           oracle_fallback=True, max_retries=1,
                           backoff_s=0.001, timeout_s=0.25,
                           cooldown_s=0.01)
    out = client.predict_all(graphs)
    n_uniq = len({g.struct_key() for g in graphs})
    assert client.degraded_count == n_uniq
    r_rng = np.random.default_rng(23)
    from repro.ir import samplers as R_SMP
    r_graphs = [R_SMP.sample_graph(r_rng) for _ in range(16)]
    for t, fn in R_AN.TARGETS.items():
        if t in out:
            want = np.array([fn(g) for g in r_graphs], np.float32)
            np.testing.assert_allclose(out[t], want, rtol=1e-4)
    st = client.stats()
    assert st["degraded_count"] == n_uniq
    assert client.fsvc.phase_stats()["degraded_preds"] == n_uniq
    client.predict_all(graphs)
    assert client.degraded_count == 2 * n_uniq


def test_router_without_fallback_sheds(corpus, spec):
    graphs, _ = corpus
    client = ReplicaClient(transport=_ScriptedTransport(), spec=spec,
                           oracle_fallback=False, max_retries=1,
                           backoff_s=0.001, timeout_s=0.25,
                           cooldown_s=0.01)
    with pytest.raises(ServerOverloadedError):
        client.predict_all(graphs)
    assert client.degraded_count == 0


def test_router_deadline_budget_degrades_fast(corpus, spec):
    graphs, _ = corpus
    client = ReplicaClient(transport=_ScriptedTransport(mode="drop"),
                           spec=spec, oracle_fallback=True,
                           deadline_s=0.3, timeout_s=30.0,
                           backoff_s=0.001, cooldown_s=0.01)
    t0 = time.monotonic()
    out = client.predict_all(graphs)
    assert time.monotonic() - t0 < 5.0
    assert client.deadline_expired >= 1
    assert client.degraded_count > 0
    assert set(out) == set(client.heads)


def test_backoff_jitter_decorrelated_and_bounded(corpus, spec,
                                                 monkeypatch):
    graphs, _ = corpus
    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))

    def run(seed):
        sleeps.clear()
        client = ReplicaClient(transport=_ScriptedTransport(),
                               spec=spec, oracle_fallback=True,
                               max_retries=4, backoff_s=0.01,
                               backoff_mult=2.0, timeout_s=0.25,
                               cooldown_s=0.001, jitter_seed=seed)
        client.predict_all(graphs[:4])
        return list(sleeps)

    a, b, c = run(1), run(2), run(1)
    assert a == c
    assert a != b
    cap = 0.01 * 2.0 ** 4
    for s in a + b:
        assert 0.01 - 1e-9 <= s <= cap + 1e-9


def test_client_ring_tracks_published_active_count(spec):
    tr = _ScriptedTransport(n_replicas=4, mode="ok")
    tr.active = mp.Value("i", 2)
    client = ReplicaClient(transport=tr, spec=spec, local_cache=False)
    assert client.ring.n_replicas == 2
    assert len(client.health) == 4
    client._fetch(_entries(64, salt="pre"))
    assert {r for r, _ in tr.reqs} <= {0, 1}
    tr.active.value = 4
    tr.reqs.clear()
    client._fetch(_entries(64, salt="post"))
    assert client.ring.n_replicas == 4
    assert {r for r, _ in tr.reqs} == {0, 1, 2, 3}
    tr.active.value = 3
    tr.reqs.clear()
    client._fetch(_entries(64, salt="down"))
    assert client.ring.n_replicas == 3
    assert {r for r, _ in tr.reqs} <= {0, 1, 2}


# --------------------------------------------------- real spawned tier
@pytest.fixture(scope="module")
def tier(spec):
    """Two live CPU replicas with one pre-allocated headroom slot."""
    tier = start_replicas(spec, 2, n_clients=2, flush_us=300.0,
                          start_timeout_s=240.0, max_replicas=3)
    yield tier
    tier.stop()


def _wait(pred, timeout_s, tick=0.25):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(tick)
    return pred()


def test_supervisor_respawns_wedged_replica(corpus, service, tier):
    """SIGSTOP leaves the process alive but heartbeat-silent; the
    supervisor detects the wedge, SIGKILLs, respawns into the same slot,
    and the tier keeps answering correctly."""
    graphs, _ = corpus
    want = service.predict_all(graphs)
    sup = ReplicaSupervisor(tier, heartbeat_s=0.25,
                            heartbeat_timeout_s=3.0,
                            restart_backoff_s=0.1,
                            start_timeout_s=240.0).start()
    try:
        client = ReplicaClient(tier.client_handle(0), local_cache=False,
                               timeout_s=2.0, cooldown_s=0.05)
        got = client.predict_all(graphs)
        for t in want:
            np.testing.assert_allclose(got[t], want[t], **PORT_TOL)
        os.kill(tier.procs[1].pid, signal.SIGSTOP)      # wedge, not die
        assert _wait(lambda: any(
            r["replica"] == 1 and r["reason"] == "wedged"
            and "recovered_in_s" in r
            for r in sup.stats()["restart_log"]), 240.0)
        st = sup.stats()
        assert st["restarts_total"] >= 1
        assert st["restarts_recovered"] >= 1
        assert st["recovery_s_max"] > 0.0
        assert st["inbox_resets"] >= 1
        assert all(tier.alive()[:2])
        time.sleep(0.2)
        got = client.predict_all(graphs)
        for t in want:
            np.testing.assert_allclose(got[t], want[t], **PORT_TOL)
        reg = MetricsRegistry()
        register_supervisor(reg, sup)
        m = reg.snapshot()["metrics"]
        assert m["supervisor.restarts_total"] >= 1
        assert m["supervisor.restarts_recovered"] >= 1
        assert not any(k.startswith("supervisor.restart_log")
                       for k in m)
    finally:
        sup.stop()


def test_supervisor_stats_keys_match_reference(tier):
    """The supervisor's stats (what the registry and the chaos gate
    read) carry the reference's keys."""
    ours = ReplicaSupervisor(tier).stats()
    theirs = R_SUP.ReplicaSupervisor(tier).stats()
    assert set(ours) == set(theirs)


def test_supervisor_scales_up_then_down(corpus, service, tier):
    """Pressure grows the tier into the pre-allocated slot (published
    only after the newcomer warms), and quiet shrinks it back; a live
    client's ring follows both moves."""
    graphs, _ = corpus
    want = service.predict_all(graphs)
    client = ReplicaClient(tier.client_handle(1), local_cache=False,
                           timeout_s=5.0)
    assert client.ring.n_replicas == 2
    hot = ScalePolicy(min_replicas=2, max_replicas=3,
                      high_queue_depth=-1.0)
    sup = ReplicaSupervisor(tier, heartbeat_s=0.25,
                            heartbeat_timeout_s=30.0, scale=hot,
                            scale_interval_s=0.5,
                            start_timeout_s=240.0).start()
    try:
        assert _wait(lambda: tier.active.value == 3, 240.0)
        assert sup.stats()["scale_ups"] >= 1
    finally:
        sup.stop()
    got = client.predict_all(graphs)
    assert client.ring.n_replicas == 3
    for t in want:
        np.testing.assert_allclose(got[t], want[t], **PORT_TOL)
    quiet = ScalePolicy(min_replicas=2, max_replicas=3,
                        high_queue_depth=1e9, low_rate_per_s=1e9,
                        settle_ticks=2)
    sup = ReplicaSupervisor(tier, heartbeat_s=0.25,
                            heartbeat_timeout_s=30.0, scale=quiet,
                            scale_interval_s=0.3,
                            start_timeout_s=240.0).start()
    try:
        assert _wait(lambda: tier.active.value == 2, 120.0)
        assert sup.stats()["scale_downs"] >= 1
        assert _wait(lambda: not tier.procs[2].is_alive(), 60.0)
    finally:
        sup.stop()
    got = client.predict_all(graphs)
    assert client.ring.n_replicas == 2
    for t in want:
        np.testing.assert_allclose(got[t], want[t], **PORT_TOL)
    assert client.shed_count == 0
