"""Production training CLI — a thin argparse layer over TrainEngine.

The engine (core/trainer.py) owns the step loop and wires every substrate
layer: bucketed dataset build (or load), the bucket-aware pipeline,
AdamW, int8 error-feedback grad compression, fault-tolerant supervisor
(atomic checkpoints, resume with the loader cursor, preemption
handling), and evaluation. Checkpoints have the reference package's
layout, so either package's CLI resumes or evaluates the other's run.

    PYTHONPATH=src python -m repro_torch.launch.train --preset small \\
        --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --model xformer --target all --steps 100 --ckpt-dir /tmp/ck

Training runs on the card unless ``--device cpu``. With
``--mesh-data``/``--mesh-model`` whose product n is above 1 and no
process group yet, the CLI spawns n ranks (``torch.multiprocessing``,
their group's store a file in a temporary directory): NCCL ranks, one a
card, on the card (it raises naming the card count when there are fewer
cards than ranks), gloo ranks with ``--device cpu``. Every rank trains
its part of the mesh; rank 0 prints the reference's lines and its
metrics are ``main``'s return value.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --mesh-data 2 --steps 50 --n-graphs 300 --ckpt-dir /tmp/ckm
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import torch
import torch.distributed as dist

from repro_torch import params as P
from repro_torch.configs.costmodel import (COSTMODEL_100M, COSTMODEL_BASE,
                                           COSTMODEL_SMALL)
from repro_torch.core import models as CM
from repro_torch.core import trainer as TR
from repro_torch.ir import dataset as DS
from repro_torch.optim import adamw, compress
from repro_torch.runtime import fault

PRESETS = {"small": COSTMODEL_SMALL, "base": COSTMODEL_BASE,
           "100m": COSTMODEL_100M}


def build_or_load_dataset(args, cfg) -> DS.CostDataset:
    path = args.dataset
    if path and os.path.exists(path):
        return DS.CostDataset.load(path)
    ds = DS.build_dataset(args.n_graphs, mode=args.mode,
                          max_seq=cfg.max_seq, vocab_size=cfg.vocab_size,
                          augment_factor=2, seed=args.seed,
                          layout=args.layout)
    if path:
        ds.save(path)
    return ds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--model", default="conv1d",
                    choices=sorted(CM.MODELS))
    ap.add_argument("--target", default="register_pressure",
                    help="target name, comma-separated list for a joint "
                         "multi-head model, or 'all'")
    ap.add_argument("--mode", default="ops",
                    choices=["ops", "ops_operands"])
    ap.add_argument("--layout", default="bucketed",
                    choices=["bucketed", "dense"],
                    help="id storage: per-bucket arrays (RAM-proportional "
                         "to real tokens) or one (N, max_seq) array")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--n-graphs", type=int, default=2000)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--ckpt-dir", default="checkpoints/costmodel")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-bucketing", action="store_true",
                    help="pad every batch to max_seq instead of per-bucket")
    ap.add_argument("--no-check-treedef", action="store_true",
                    help="resume although the checkpoint's leaf paths "
                         "differ from this model's (a benign renaming "
                         "between versions)")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to train and evaluate on "
                         "(default: the CUDA card; 'cpu' off the card)")
    args = ap.parse_args(argv)
    n_ranks = args.mesh_data * args.mesh_model
    if n_ranks > 1 and not dist.is_initialized():
        return spawn_ranks(n_ranks, args,
                           list(sys.argv[1:] if argv is None else argv))

    cfg = PRESETS[args.preset]
    ds = build_or_load_dataset(args, cfg)
    train, test = ds.split(0.1, seed=args.seed)
    print(f"dataset: {len(train)} train / {len(test)} test, "
          f"vocab={ds.vocab.size}, mode={ds.mode}, layout="
          f"{'dense' if ds.ids is not None else 'bucketed'}")

    if args.target == "all":
        heads = tuple(sorted(train.targets))
    else:
        heads = tuple(t for t in args.target.split(",") if t)
    unknown = sorted(set(heads) - set(train.targets))
    if not heads or unknown:
        ap.error(f"unknown target(s) {unknown or [args.target]}; "
                 f"available: {sorted(train.targets)} or 'all'")
    target = heads if len(heads) > 1 else heads[0]

    engine = TR.TrainEngine(
        args.model, cfg, target,
        steps=args.steps, batch_size=args.batch, lr=args.lr,
        seed=args.seed, log_every=50, verbose=True,
        bucketed=not args.no_bucketing,
        mesh_data=args.mesh_data, mesh_model=args.mesh_model,
        compress_grads=args.compress_grads,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every,
        check_treedef=not args.no_check_treedef, install_sigterm=True,
        device=args.device)

    if args.eval_only:
        init_kw = {"heads": engine.heads} if engine.heads else {}
        params = P.from_numpy(engine.init_fn(
            cfg, generator=torch.Generator().manual_seed(args.seed),
            **init_kw), engine.device)
        like = (params, adamw.init_state(params),
                compress.init_error_state(params)
                if args.compress_grads else None)
        sup = fault.TrainSupervisor(args.ckpt_dir)
        state, start, extra = sup.try_restore(
            like, check_treedef=not args.no_check_treedef)
        if not start:
            ap.error(f"--eval-only: no checkpoint under {args.ckpt_dir}")
        result = TR.TrainResult(params=state[0], stats={},
                                norm_stats=extra["norm_stats"],
                                heads=engine.heads)
    else:
        result = engine.fit(train)
        if result.stats["steps"]:
            print(f"trained {result.stats['steps']:.0f} steps in "
                  f"{result.stats['wall_time_s']:.1f}s "
                  f"({result.stats['steps_per_s']:.1f} steps/s)")
        else:
            print(f"run already complete in {args.ckpt_dir}; evaluating")

    if engine.heads:
        metrics = TR.evaluate(args.model, cfg, result, test)
        for t, m in metrics.items():
            print(f"eval[{t}]:",
                  json.dumps({k: round(v, 3) for k, v in m.items()}))
    else:
        metrics = TR.evaluate(args.model, cfg, result, test, target)
        print("eval:",
              json.dumps({k: round(v, 3) for k, v in metrics.items()}))
    return metrics


def spawn_ranks(n: int, args, argv):
    """Run ``main(argv)`` in n spawned ranks of one process group and
    return rank 0's metrics."""
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards < n:
            raise RuntimeError(
                f"--mesh-data {args.mesh_data} --mesh-model "
                f"{args.mesh_model} needs {n} ranks, one a CUDA card, and "
                f"there are {cards} cards; pass --device cpu for gloo "
                f"ranks on the CPU")
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        mp.spawn(_rank_main, args=(n, tmp, argv, dev.type), nprocs=n,
                 join=True)
        with open(os.path.join(tmp, "metrics.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, n: int, tmp: str, argv, dev_type: str):
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        # the machine's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        backend = "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), n),
        rank=rank, world_size=n)
    try:
        if rank:
            sys.stdout = open(os.devnull, "w")
        metrics = main(argv)
        if rank == 0:
            with open(os.path.join(tmp, "metrics.json"), "w") as f:
                json.dump(metrics, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
