"""Quickstart on the PyTorch port: build an MLIR corpus, train the
paper's Conv1D cost model, predict hardware characteristics for an
unseen graph. Runs on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import trainer as TR
from repro_torch.core.service import CostModelService
from repro_torch.ir import analyzers, printer, samplers
from repro_torch.ir import dataset as DS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' off the card)")
    ap.add_argument("--n-graphs", type=int, default=1200)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    cfg = CostModelConfig(name="quickstart", vocab_size=2048, max_seq=128,
                          embed_dim=64, conv_channels=(64,) * 6,
                          fc_dims=(256, 64))

    print(f"1) sampling {args.n_graphs} dataflow graphs "
          f"(resnet/bert/unet/ssd/yolo) ...")
    ds = DS.build_dataset(args.n_graphs, mode="ops", max_seq=128,
                          vocab_size=2048, augment_factor=2, seed=0)
    train, test = ds.split(0.1)

    print("2) training the Conv1D+MaxPool+FC regressor on register "
          "pressure ...")
    engine = TR.TrainEngine("conv1d", cfg, "register_pressure",
                            steps=args.steps, batch_size=args.batch,
                            lr=2e-3, verbose=True, log_every=100,
                            device=args.device)
    res = engine.fit(train)
    print(f"   {res.stats['steps_per_s']:.1f} steps/s (bucketed batches)")
    metrics = TR.evaluate("conv1d", cfg, res, test, "register_pressure")
    print("   test metrics:", {k: round(v, 2) for k, v in metrics.items()})

    print("3) predicting an unseen graph ...")
    rng = np.random.default_rng(123)
    g = samplers.sample_graph(rng, "bert")
    print(printer.to_mlir(g).splitlines()[0], "...")
    svc = CostModelService("conv1d", cfg, res.params, ds.vocab,
                           res.norm_stats, mode="ops", max_seq=128,
                           device=args.device)
    pred = svc.predict(g)
    true = analyzers.register_pressure(g)
    print(f"   predicted register pressure: {pred:.1f}  "
          f"(ground truth: {true})")
    return {"metrics": metrics, "pred": pred, "true": true}


if __name__ == "__main__":
    main()
