"""Cost-model-guided graph optimization driver (the repro_torch.opt CLI).

The paper's deployment loop, end to end: train (or resume) a joint
multi-target cost model on a rewrite-augmented corpus, stand it up
behind the async micro-batching CostModelServer, then beam-search
rewrite sequences (fusion / CSE / DCE / recompute / bf16-narrowing /
unroll) over sampled graphs from all five model families — every
frontier expansion costed in ONE batched ``predict_all`` — and judge
the chosen sequences against the ``ir/analyzers`` ground-truth oracle.

    PYTHONPATH=src python -m repro_torch.launch.optimize \
        --eval-graphs 20 --beam 4 --depth 5 --register-budget 64 --kernel

Training and serving run on the card unless ``--device cpu``; with
``--kernel`` every forward is one launch of the fused conv forward (its
plain PyTorch version on the CPU). ``--ckpt-dir`` resumes a run written
by either package's trainer, as the checkpoints share a layout.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import models as CM
from repro_torch.core import trainer as TR
from repro_torch.core.server import CostModelServer
from repro_torch.core.service import CostModelService
from repro_torch.ir import dataset as DS
from repro_torch.ir import samplers
from repro_torch.opt import evaluate as OE
from repro_torch.opt import search as OPT


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train-or-load a cost model, serve it, and run "
                    "model-guided beam search over rewrite sequences.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--n-graphs", type=int, default=1200,
                    help="base training graphs (each also contributes a "
                         "rewrite-augmented variant)")
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint dir: resume/load the model from "
                         "here instead of retraining from scratch")
    ap.add_argument("--eval-graphs", type=int, default=20,
                    help="graphs to optimize, round-robin over families")
    ap.add_argument("--families", default=",".join(sorted(
        samplers.SAMPLERS)))
    ap.add_argument("--beam", type=int, default=4)
    ap.add_argument("--depth", type=int, default=5,
                    help="max rewrite-sequence length (search steps)")
    ap.add_argument("--max-candidates", type=int, default=64,
                    help="candidate cap per frontier expansion")
    ap.add_argument("--eval-budget", type=int, default=256,
                    help="total candidates costed per search")
    ap.add_argument("--register-budget", type=float, default=float("inf"),
                    help="hard register-pressure constraint on candidates")
    ap.add_argument("--greedy", action="store_true",
                    help="cheap mode: beam 1, stop on first non-improving "
                         "step")
    ap.add_argument("--direct", action="store_true",
                    help="query the service directly instead of through "
                         "the async micro-batching server")
    ap.add_argument("--flush-us", type=float, default=1000.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="serving precision for candidate costing: bf16 "
                         "runs quantized forward passes (params cast "
                         "once; denormalize stays float32-exact)")
    ap.add_argument("--kernel", action="store_true",
                    help="cost candidates through the fused CUDA "
                         "serving forward (repro_torch.kernels.ops), one "
                         "launch a batch; composes with --dtype bf16")
    ap.add_argument("--obs", action="store_true",
                    help="unified telemetry on the serving gateway: "
                         "head-sampled tracing, metrics-registry JSONL "
                         "stream, and the drift sentinel (see "
                         "`python -m repro_torch.launch.obs report`)")
    ap.add_argument("--obs-jsonl", default="obs_optimize.jsonl",
                    help="telemetry stream path for --obs")
    ap.add_argument("--obs-sample", type=int, default=64,
                    help="trace 1 in N predict_all calls")
    ap.add_argument("--obs-prom-port", type=int, default=None,
                    help="optional Prometheus /metrics port (0 = "
                         "ephemeral)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to train and serve on (default: "
                         "the CUDA card; 'cpu' off the card)")
    args = ap.parse_args(argv)

    cfg = CostModelConfig(name="optimize", vocab_size=4096, max_seq=160,
                          embed_dim=64, conv_channels=(64,) * 6,
                          fc_dims=(256, 64))
    ds = DS.build_dataset(args.n_graphs, mode="ops", max_seq=160,
                          vocab_size=4096, augment_factor=1,
                          rewrite_factor=1, seed=args.seed)
    tr, te = ds.split(0.1)
    print(f"training joint cost model on rewrite-augmented corpus "
          f"({len(tr)} rows, vocab={ds.vocab.size})...")
    engine = TR.TrainEngine("conv1d", cfg, CM.DEFAULT_HEADS,
                            steps=args.train_steps, batch_size=128,
                            lr=2e-3, seed=args.seed,
                            ckpt_dir=args.ckpt_dir, device=args.device)
    res = engine.fit(tr)
    if res.stats.get("steps"):
        print(f"trained {res.stats['steps']:.0f} steps at "
              f"{res.stats['steps_per_s']:.1f} steps/s")
    else:
        print(f"resumed completed run from {args.ckpt_dir}")
    for t, m in TR.evaluate("conv1d", cfg, res, te).items():
        print(f"  eval[{t}]: rmse_rel={m['rmse_rel_pct']:.1f}% "
              f"mape={m['mape_pct']:.1f}%")

    svc = CostModelService("conv1d", cfg, res.params, ds.vocab,
                           res.norm_stats, mode="ops", max_seq=160,
                           dtype=args.dtype, use_kernel=args.kernel,
                           device=args.device)
    rng = np.random.default_rng(args.seed + 1)
    fams = [f for f in args.families.split(",") if f]
    graphs = [samplers.sample_graph(rng, fams[i % len(fams)])
              for i in range(args.eval_graphs)]
    objective = OPT.Objective(register_budget=args.register_budget)

    server = None
    backend = svc
    if not args.direct:
        server = CostModelServer(svc, max_batch=args.max_batch,
                                 flush_us=args.flush_us)
    from repro_torch.launch.serve import setup_obs, teardown_obs
    obs = setup_obs(args, server=server, service=svc)
    if obs and server is not None:
        server.tracer = obs["tracer"]
    if server is not None:
        server.start()
        backend = server
    try:
        t0 = time.perf_counter()
        report = OE.evaluate_search(
            backend, graphs, objective=objective, beam_width=args.beam,
            max_steps=args.depth, max_candidates=args.max_candidates,
            eval_budget=args.eval_budget, greedy=args.greedy)
        dt = time.perf_counter() - t0
    finally:
        if server is not None:
            m = server.metrics.snapshot()
            server.stop()
        teardown_obs(args, obs)

    for r in report["per_graph"]:
        arrow = "↓" if r["oracle_best"] < r["oracle_root"] else "="
        print(f"  {r['graph']:<12} oracle {r['oracle_root']:9.1f}us "
              f"{arrow} {r['oracle_best']:9.1f}us  "
              f"steps={r['steps']} [{' '.join(r['seq']) or 'no-op'}]")
    s = report["summary"]
    print(f"optimized {s['n_graphs']} graphs in {dt:.2f}s "
          f"({s['n_graphs'] / dt:.2f} graphs/s, "
          f"{s['candidates_costed']} candidates costed in "
          f"{s['predict_calls']} batched predict_all calls)")
    print(f"  oracle latency improvement: mean "
          f"{s['oracle_improvement_mean']:.1%} "
          f"(one-shot fusion baseline "
          f"{s['baseline_oracle_improvement_mean']:.1%}); "
          f"improved on {s['frac_improved_vs_root']:.0%} of graphs")
    print(f"  predicted improvement {s['pred_improvement_mean']:.1%}; "
          f"pred-vs-oracle rank corr "
          f"rho={s['spearman_pred_oracle_pooled']:.3f} pooled / "
          f"{s['spearman_pred_oracle']:.3f} within-search")
    if server is not None:
        print(f"  server: {m['requests']} requests in {m['batches']} "
              f"batches (occupancy {m['batch_occupancy']:.1f}, "
              f"cache_hit_rate={m['cache_hit_rate']:.1%})")
    return report


if __name__ == "__main__":
    main()
