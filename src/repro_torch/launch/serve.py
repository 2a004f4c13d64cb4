"""Async micro-batching inference gateway for the deployed cost model.

Simulates the DL-compiler's real usage pattern: many concurrent clients
(one per compile thread doing fusion/unroll/recompile search), each
issuing bursts of small prediction requests. The CostModelServer merges
them into coalesced per-bucket batches (flush on full batch or a
deadline), answers LRU-cached repeats at submit time, and runs every
(bucket x batch-ladder) shape once at startup (the kernel library's
build or load, cuDNN and cuBLAS plans, the allocator's growth). One
multi-head service predicts every hardware characteristic — register
pressure, vALU utilization, latency — from a single encoder forward
pass.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 2000 \
        --concurrency 16 --flush-us 2000
    PYTHONPATH=src python -m repro_torch.launch.serve --kernel \
        --replicas 2 --supervise --obs

Training and serving run on the card unless ``--device cpu``; with
``--kernel`` every served batch is one launch of the fused conv forward
(its plain PyTorch version on the CPU). ``main`` returns the in-process
server's metrics snapshot, or the replicas' stats with ``--replicas``.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import augment as AUG
from repro_torch.core import models as CM
from repro_torch.core import trainer as TR
from repro_torch.core.server import CostModelServer
from repro_torch.core.service import (CostModelService, FusionAdvisor,
                                      RecompileAdvisor, UnrollAdvisor)
from repro_torch.ir import dataset as DS
from repro_torch.ir import samplers


def run_clients(server: CostModelServer, graphs, concurrency: int) -> float:
    """Closed-loop clients: each thread owns a slice of the request
    stream and submits its next request as soon as the previous one
    resolves. Returns wall seconds for the whole stream."""
    slices = [graphs[i::concurrency] for i in range(concurrency)]
    errs = []

    def client(gs):
        try:
            for g in gs:
                server.predict_all([g])
        except Exception as e:          # surface, don't hang the driver
            errs.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in slices]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return dt


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a small multi-target cost model, then serve it "
                    "through the async micro-batching CostModelServer "
                    "under closed-loop concurrent clients.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--requests", type=int, default=500,
                    help="total prediction requests across all clients "
                         "(stream has ~50%% repeated graphs, like a "
                         "compiler re-querying modified candidates)")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop client threads submitting "
                         "concurrently; their requests coalesce into "
                         "shared batched forward passes")
    ap.add_argument("--flush-us", type=float, default=2000.0,
                    help="micro-batch flush deadline in microseconds: a "
                         "partially-filled bucket queue is flushed once "
                         "its oldest request has waited this long")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="flush a bucket queue as soon as it holds this "
                         "many unique requests (full-batch path)")
    ap.add_argument("--max-queue", type=int, default=4096,
                    help="bound on queued entries across all buckets; "
                         "beyond it submits fail fast with "
                         "ServerOverloadedError (load shed)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip running every (bucket x batch-ladder) "
                         "shape once at startup (kernel library, cuDNN "
                         "and cuBLAS plans, allocator growth)")
    ap.add_argument("--train-steps", type=int, default=400,
                    help="training steps for the demo model")
    ap.add_argument("--n-graphs", type=int, default=1500,
                    help="synthetic training-set size")
    ap.add_argument("--cache-size", type=int, default=4096,
                    help="LRU prediction-cache bound (unique graphs)")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="serving precision: bf16 casts the baked params "
                         "once and runs quantized forward passes (the "
                         "denormalize path stays float32-exact; drift vs "
                         "f32 is gated in tests at Spearman >= 0.99)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through N replica processes behind the "
                         "struct-key consistent-hash router instead of "
                         "one in-process server (0 = in-process); each "
                         "replica owns its params, warmup, LRU and an "
                         "adaptive flush deadline, with a shared "
                         "cross-replica cache tier behind them")
    ap.add_argument("--kernel", action="store_true",
                    help="serve through the fused CUDA forward "
                         "(repro_torch.kernels.ops): one launch of the "
                         "ids-in/predictions-out conv kernel a batch "
                         "(its plain PyTorch version on the CPU). "
                         "Composes with --dtype bf16 (bf16 params, f32 "
                         "in-kernel accumulation)")
    ap.add_argument("--supervise", action="store_true",
                    help="replicated tier only: run the "
                         "ReplicaSupervisor (heartbeat liveness, "
                         "in-slot respawn of crashed/wedged replicas "
                         "with crash-loop budgets, arrival-rate-driven "
                         "scale up/down within --max-replicas)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="pre-allocated replica slot ceiling for "
                         "supervisor scale-up (default: --replicas, "
                         "i.e. no headroom)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline budget in the router "
                         "(retries included); a blown deadline sheds "
                         "or, with --degrade, falls back to the "
                         "analyzer oracle")
    ap.add_argument("--degrade", action="store_true",
                    help="replicated tier only: when the tier is "
                         "exhausted (all replicas shedding/cooling or "
                         "the deadline blown), answer from the "
                         "analyzer-oracle static cost model instead of "
                         "raising; degraded replies are counted in "
                         "phase_stats/router stats and the obs "
                         "registry")
    ap.add_argument("--obs", action="store_true",
                    help="unified telemetry: head-sampled request "
                         "tracing (spans cross the replica wire), one "
                         "metrics-registry JSONL stream, and the online "
                         "accuracy/drift sentinel. Inspect with "
                         "`python -m repro_torch.launch.obs report "
                         "<jsonl>`")
    ap.add_argument("--obs-jsonl", default="obs_telemetry.jsonl",
                    help="telemetry stream path (JSONL: interleaved "
                         "metrics snapshots + span records)")
    ap.add_argument("--obs-sample", type=int, default=16,
                    help="trace 1 in N requests (errors/sheds are "
                         "always traced)")
    ap.add_argument("--obs-prom-port", type=int, default=None,
                    help="also serve a Prometheus-style /metrics "
                         "endpoint on this port (0 = ephemeral)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to train and serve on (default: "
                         "the CUDA card; 'cpu' off the card, replicas "
                         "included)")
    args = ap.parse_args(argv)

    cfg = CostModelConfig(name="serve", vocab_size=4096, max_seq=160,
                          embed_dim=64, conv_channels=(64,) * 6,
                          fc_dims=(256, 64))
    ds = DS.build_dataset(args.n_graphs, mode="ops", max_seq=160,
                          vocab_size=4096, augment_factor=2, seed=args.seed)
    tr, te = ds.split(0.1)
    print(f"training joint multi-target cost model "
          f"({', '.join(CM.DEFAULT_HEADS)})...")
    engine = TR.TrainEngine("conv1d", cfg, CM.DEFAULT_HEADS,
                            steps=args.train_steps, batch_size=128,
                            lr=2e-3, seed=args.seed, device=args.device)
    res = engine.fit(tr)
    print(f"trained at {res.stats['steps_per_s']:.1f} steps/s "
          f"(bucketed batches)")

    svc = CostModelService("conv1d", cfg, res.params, ds.vocab,
                           res.norm_stats, mode="ops", max_seq=160,
                           cache_size=args.cache_size, dtype=args.dtype,
                           use_kernel=args.kernel, device=args.device)
    if args.replicas > 0:
        return run_replicated(svc, args)
    server = CostModelServer(svc, max_batch=args.max_batch,
                             flush_us=args.flush_us,
                             max_queue=args.max_queue)
    obs = setup_obs(args, server=server, service=svc)
    if obs:
        server.tracer = obs["tracer"]
    t0 = time.perf_counter()
    server.start(warmup=not args.no_warmup)
    try:
        m = run_session(server, svc, args, time.perf_counter() - t0)
    finally:
        server.stop()                  # fail leftover futures on error
        teardown_obs(args, obs)
    print(f"cache after session: {svc.cache_stats()['size']} unique "
          f"entries")
    return m


def setup_obs(args, *, server=None, service=None, router=None,
              shared_cache=None, supervisor=None):
    """Build the unified telemetry stack from CLI flags: one tracer,
    one registry over every tier's existing stats source, the drift
    sentinel on the (featurizer) service, and the JSONL exporter that
    streams it all to disk. Returns the bundle, or None when --obs is
    off — every call site is a no-op then."""
    if not getattr(args, "obs", False):
        return None
    from repro_torch.obs import (JsonlExporter, MetricsRegistry,
                                 PromExporter, Tracer, register_drift,
                                 register_router, register_server,
                                 register_service, register_shared_cache,
                                 register_supervisor, register_tracer)
    from repro_torch.obs.drift import DriftMonitor, attach
    tracer = Tracer(sample_every=max(1, args.obs_sample))
    reg = MetricsRegistry()
    drift = None
    if service is not None:
        drift = attach(service, DriftMonitor())
        register_service(reg, service)
        register_drift(reg, drift)
    if server is not None:
        register_server(reg, server)
    if router is not None:
        register_router(reg, router)
    if shared_cache is not None:
        register_shared_cache(reg, shared_cache)
    if supervisor is not None:
        register_supervisor(reg, supervisor)
    register_tracer(reg, tracer)
    exporter = JsonlExporter(args.obs_jsonl, reg, tracer=tracer,
                             interval_s=0.5).start()
    prom = None
    if args.obs_prom_port is not None:
        prom = PromExporter(reg, args.obs_prom_port).start()
        print(f"obs: /metrics on port {prom.port}")
    print(f"obs: tracing 1/{tracer.sample_every} requests "
          f"-> {args.obs_jsonl}")
    return {"tracer": tracer, "registry": reg, "drift": drift,
            "exporter": exporter, "prom": prom}


def teardown_obs(args, obs) -> None:
    """Flush + stop the telemetry stack and print the trace digest the
    session just produced (the same numbers `launch/obs.py report`
    computes offline from the JSONL)."""
    if not obs:
        return
    import json

    from repro_torch.obs import assemble, completeness
    if obs["drift"] is not None:
        obs["drift"].stop()            # drains + scores the queue
    obs["exporter"].stop()             # final tick: snapshot + spans
    if obs["prom"] is not None:
        obs["prom"].stop()
    spans = []
    try:
        with open(args.obs_jsonl, encoding="utf-8") as f:
            spans = [json.loads(ln) for ln in f if '"kind": "span"' in ln]
    except OSError:
        pass
    trees = assemble(spans)
    if trees:
        print(f"obs: {len(spans)} spans across {len(trees)} traces, "
              f"completeness={completeness(trees):.1%}; inspect with "
              f"`python -m repro_torch.launch.obs report "
              f"{args.obs_jsonl}`")


def run_replicated(svc: CostModelService, args) -> list:
    """Serve the trained model through N replica processes behind the
    struct-key router; the client is duck-typed, so the same closed-loop
    driver and advisors run unchanged. With --supervise the tier is
    self-healing: a ReplicaSupervisor heartbeats every replica,
    respawns crashed/wedged ones into their ring slot, and scales the
    fleet from arrival-rate/health signals. The replicas run on the
    service's device (the spec carries it); a card spec with --kernel
    has its library built here before the spawn. Returns the replicas'
    stats after the session."""
    from repro_torch.serving import (ReplicaClient, ReplicaSupervisor,
                                     ScalePolicy, ServiceSpec,
                                     start_replicas)

    spec = ServiceSpec.from_service(svc)
    t0 = time.perf_counter()
    tier = start_replicas(spec, args.replicas, n_clients=1,
                          warmup=not args.no_warmup,
                          max_batch=args.max_batch,
                          flush_us=args.flush_us,
                          max_queue=args.max_queue,
                          obs_trace=args.obs,
                          max_replicas=args.max_replicas)
    obs = None
    sup = None
    try:
        client = ReplicaClient(
            tier.client_handle(0),
            deadline_s=args.deadline_ms / 1e3
            if args.deadline_ms else None,
            oracle_fallback=args.degrade)
        if args.supervise:
            sup = ReplicaSupervisor(
                tier,
                scale=ScalePolicy(min_replicas=1,
                                  max_replicas=tier.max_replicas),
                router_stats_fn=client.stats).start()
        obs = setup_obs(args, router=client, service=client.fsvc,
                        shared_cache=tier.shared_cache, supervisor=sup)
        if obs:
            client.tracer = obs["tracer"]
        run_session(client, client.fsvc, args, time.perf_counter() - t0)
        replica_stats = client.replica_stats()
        for payload in replica_stats:
            if payload is None:
                continue
            s, c = payload["server"], payload["cache"]
            print(f"  replica {payload['replica_id']}: "
                  f"requests={s['requests']} "
                  f"batches={s['batches']} "
                  f"occupancy={s['batch_occupancy']:.1f} "
                  f"lru_hit={c['hit_rate']:.1%} "
                  f"shared_hits={payload['shared_hits']}")
        h = client.stats()["health"]
        print(f"  router: sent={[h[r]['sent'] for r in sorted(h)]} "
              f"shed={client.shed_count} "
              f"degraded={client.degraded_count}")
        if sup is not None:
            ss = sup.stats()
            print(f"  supervisor: active={ss['active']} "
                  f"restarts={ss['restarts_total']} "
                  f"scale_ups={ss['scale_ups']} "
                  f"scale_downs={ss['scale_downs']}")
    finally:
        if sup is not None:
            sup.stop()
        tier.stop()
        teardown_obs(args, obs)
    return replica_stats


def run_session(server: CostModelServer, svc: CostModelService, args,
                warmup_s: float):
    """The closed-loop request stream and the three advisors; returns
    the in-process server's metrics snapshot (None for a replica
    client, whose replicas report their own)."""
    print(f"server up: heads={list(svc.heads)} buckets={list(svc.buckets)} "
          f"batch_ladder={list(svc.batch_ladder)} warmup={warmup_s:.2f}s")

    rng = np.random.default_rng(args.seed + 1)
    graphs = [samplers.sample_graph(rng) for _ in range(args.requests // 2)]
    # compiler sessions re-query slightly-modified graphs: 50% cache hits
    graphs = graphs + [g for g in graphs]
    rng.shuffle(graphs)

    dt = run_clients(server, graphs, args.concurrency)
    n_targets = len(svc.heads)
    print(f"served {len(graphs)} requests x {n_targets} targets in "
          f"{dt:.2f}s ({len(graphs) / dt:.0f} req/s, "
          f"{len(graphs) * n_targets / dt:.0f} predictions/s) "
          f"at concurrency {args.concurrency}")
    m = None
    if hasattr(server, "metrics_snapshot"):   # in-process gateway only:
        m = server.metrics_snapshot()         # replicas report their own
        print(f"  batches={m['batches']} "
              f"occupancy={m['batch_occupancy']:.1f} "
              f"full={m['full_flushes']} "
              f"deadline={m['deadline_flushes']}")
        print(f"  latency p50={m['latency_p50_us'] / 1e3:.2f}ms "
              f"p95={m['latency_p95_us'] / 1e3:.2f}ms "
              f"p99={m['latency_p99_us'] / 1e3:.2f}ms")
        print(f"  cache_hit_rate={m['cache_hit_rate']:.1%} "
              f"coalesced={m['coalesced']} shed={m['shed']} "
              f"max_queue_depth={m['max_queue_depth']}")

    # the advisors drive the SAME gateway (duck-typed service API)
    fusion = FusionAdvisor(server)
    unroll = UnrollAdvisor(server, register_budget=64)
    recompile = RecompileAdvisor(server)

    g = samplers.sample_graph(rng, "resnet")
    do_fuse, c0, c1 = fusion.advise(g)
    print(f"fusion advisor: fuse={do_fuse} "
          f"(unfused={c0:.1f}us fused={c1:.1f}us)")
    adv = unroll.advise(g)
    per_iter = {k: round(v, 1) for k, v in adv['per_iter_latency'].items()}
    print(f"unroll advisor: best_factor={adv['best_factor']} "
          f"per-iter latency={per_iter}")
    g2 = AUG.jitter_shapes(g, rng)
    dec = recompile.advise(g, g2)
    print(f"recompile advisor: recompile={dec['recompile']} "
          f"shift={dec['shift']:.1%}")
    return m


if __name__ == "__main__":
    main()
