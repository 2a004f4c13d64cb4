"""Compiler-in-the-loop demo on the PyTorch port: ONE deployed
multi-target cost model drives fusion, unroll and recompile decisions,
served through the async micro-batching ``CostModelServer`` — on the
card, every forward is one launch of the fused Conv1D kernel (K1).

Every advisor shares the same gateway: one encoder forward per candidate
graph gives register pressure, vALU utilization and latency together;
requests from concurrent compile threads coalesce into shared batched
forwards; and the LRU cache behind the server is shared across advisors.
The finale is the ``repro_torch.opt`` beam search across the whole
rewrite registry, judged against the analyzer oracle.

    PYTHONPATH=src python examples/compiler_advisors_torch.py
    PYTHONPATH=src python examples/compiler_advisors_torch.py --device cpu

Off the card (``--device cpu``) the service runs the kernel's plain
PyTorch version.
"""
import argparse

import numpy as np

from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import augment as AUG
from repro_torch.core import models as CM
from repro_torch.core import trainer as TR
from repro_torch.core.server import CostModelServer
from repro_torch.core.service import (CostModelService, FusionAdvisor,
                                      RecompileAdvisor, UnrollAdvisor)
from repro_torch.ir import analyzers, samplers
from repro_torch.ir import dataset as DS
from repro_torch.opt import evaluate as OE
from repro_torch.opt import search as OPT


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' off the card)")
    ap.add_argument("--n-graphs", type=int, default=900)
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    seed = args.seed
    cfg = CostModelConfig(name="advisors", vocab_size=4096, max_seq=160,
                          embed_dim=64, conv_channels=(64,) * 6,
                          fc_dims=(256, 64))
    # rewrite_factor puts fused/bf16 IR text in the corpus (and vocab),
    # so the model can rank the optimizer's candidates
    ds = DS.build_dataset(args.n_graphs, mode="ops", max_seq=160,
                          vocab_size=4096, augment_factor=1,
                          rewrite_factor=1, seed=seed)
    tr, te = ds.split(0.1)
    print(f"training one model for all targets: {list(CM.DEFAULT_HEADS)}")
    res = TR.TrainEngine("conv1d", cfg, CM.DEFAULT_HEADS,
                         steps=args.train_steps, batch_size=128, lr=2e-3,
                         seed=seed, device=args.device).fit(tr)
    for t, m in TR.evaluate("conv1d", cfg, res, te).items():
        print(f"  eval[{t}]: rmse_rel={m['rmse_rel_pct']:.1f}% "
              f"mape={m['mape_pct']:.1f}%")

    svc = CostModelService("conv1d", cfg, res.params, ds.vocab,
                           res.norm_stats, mode="ops", max_seq=160,
                           use_kernel=True, device=args.device)
    with CostModelServer(svc, max_batch=32, flush_us=2000) as server:
        fusion = FusionAdvisor(server)
        unroll = UnrollAdvisor(server, register_budget=64)
        recompile = RecompileAdvisor(server)

        rng = np.random.default_rng(seed + 1)
        g = samplers.sample_graph(rng, "resnet")
        costs = server.predict_all([g])
        print("one forward pass, all characteristics:",
              {t: round(float(v[0]), 2) for t, v in costs.items()})

        do_fuse, c0, c1 = fusion.advise(g)
        print(f"fusion advisor: fuse={do_fuse} "
              f"(unfused={c0:.1f}us fused={c1:.1f}us)")
        adv = unroll.advise(g)
        per_iter = {k: round(v, 1)
                    for k, v in adv['per_iter_latency'].items()}
        print(f"unroll advisor: best_factor={adv['best_factor']} "
              f"per-iter latency={per_iter}")
        g2 = AUG.jitter_shapes(g, rng)
        dec = recompile.advise(g, g2)
        print(f"recompile advisor: recompile={dec['recompile']} "
              f"shift={dec['shift']:.1%}")

        # the full engine: beam search over the whole rewrite registry
        gb = samplers.sample_graph(rng, "bert")
        found = OPT.beam_search(server, gb, beam_width=3, max_steps=4)
        final = OE.replay(found)
        print(f"beam search [{gb.name}]: {found.describe()}")
        print(f"  predicted latency {found.root_preds['latency_us']:.1f}us "
              f"-> {found.best_preds['latency_us']:.1f}us in "
              f"{found.expansions} expansions "
              f"({found.evaluated} candidates, "
              f"{found.predict_calls} batched predict_all calls)")
        print(f"  oracle latency    {analyzers.latency_us(gb):.1f}us "
              f"-> {analyzers.latency_us(final):.1f}us")
        m = server.metrics.snapshot()
        print(f"server session: {m['requests']} requests, "
              f"{m['batches']} batched forward passes "
              f"(occupancy {m['batch_occupancy']:.1f}), "
              f"cache_hit_rate={m['cache_hit_rate']:.1%}")
    print(f"cache after session: {svc.cache_stats()['size']} entries "
          f"(bound {svc.cache_size})")
    return {"costs": costs, "fuse": do_fuse, "unroll": adv,
            "recompile": dec, "search": found, "server": m}


if __name__ == "__main__":
    main()
