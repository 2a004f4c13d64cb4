"""Real-MLIR front-door CLI: lowered text in, cost predictions out.

Demonstrates the tolerant ingestion path end to end: train a small
multi-target cost model on synthetic graphs, extend its vocabulary
with the OOV machinery (hash-bucketed ``<unk#k>`` shards + byte
fallback), then feed it *genuine* compiler IR — the per-layer StableHLO
subgraphs of real architectures from ``repro_torch.configs.ARCHS``
(traced by PyTorch on fake tensors and printed by
:mod:`repro_torch.ir.stablehlo`), a user file, or a seeded fuzz corpus
of mutated/truncated/dialect-mixed texts. Every input produces either a
TextPrediction or a structured IngestError; nothing raises.

    PYTHONPATH=src python -m repro_torch.launch.ingest --fuzz 50 --kernel
    PYTHONPATH=src python -m repro_torch.launch.ingest --arch all
    PYTHONPATH=src python -m repro_torch.launch.ingest --file my_module.mlir
    PYTHONPATH=src python -m repro_torch.launch.ingest --device cpu

Training and serving run on the card unless ``--device cpu``; with
``--kernel`` every forward is one launch of the fused conv forward (its
plain PyTorch version on the CPU), and on the card every (bucket x
batch-ladder) shape runs once before the first text.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import params as P
from repro_torch.configs.costmodel import CostModelConfig
from repro_torch.core import models as CM
from repro_torch.core import trainer as TR
from repro_torch.core.service import CostModelService
from repro_torch.core.tokenizer import extend_vocab_oov
from repro_torch.ir import dataset as DS
from repro_torch.ir import frontdoor as FD
from repro_torch.ir import stablehlo as SH

DEFAULT_ARCHS = ("qwen3-0.6b", "xlstm-125m", "whisper-small",
                 "granite-moe-1b-a400m", "starcoder2-3b")


def build_service(args) -> CostModelService:
    """Small trained conv model whose vocab carries the OOV machinery.

    The dataset vocab is fit below ``cfg.vocab_size`` on purpose: the
    spare id space holds the unk shards and the 256 byte tokens, so
    every extended id still fits the embedding table."""
    cfg = CostModelConfig(name="ingest", vocab_size=2048, max_seq=192,
                          embed_dim=32, conv_channels=(32,) * 3,
                          fc_dims=(64,))
    ds = DS.build_dataset(args.n_graphs, mode="ops", max_seq=192,
                          vocab_size=1500, seed=args.seed)
    vocab = extend_vocab_oov(ds.vocab, n_unk_buckets=32,
                             byte_fallback=True,
                             max_size=cfg.vocab_size)
    if args.train_steps > 0:
        engine = TR.TrainEngine("conv1d", cfg, CM.DEFAULT_HEADS,
                                steps=args.train_steps, batch_size=64,
                                lr=2e-3, seed=args.seed,
                                device=args.device)
        res = engine.fit(ds)
        params, stats = res.params, res.norm_stats
    else:                              # untrained demo: path, not accuracy
        params = P.conv_init(cfg, CM.DEFAULT_HEADS,
                             generator=torch.Generator().manual_seed(
                                 args.seed))
        stats = {t: {"mu": 0.0, "sigma": 1.0} for t in CM.DEFAULT_HEADS}
    return CostModelService("conv1d", cfg, params, vocab, stats,
                            mode="ops", max_seq=192,
                            use_kernel=args.kernel, device=args.device)


def show(tag: str, out) -> None:
    """One result line per ingested text, prediction or error alike."""
    if isinstance(out, FD.IngestError):
        print(f"  {tag:40s} ERROR stage={out.stage} "
              f"reason={out.reason}")
        return
    preds = " ".join(f"{t}={v:.3g}" for t, v in
                     sorted(out.predictions.items()))
    print(f"  {tag:40s} n_ops={out.n_ops:3d} "
          f"tokens={out.n_tokens:4d} oov={out.oov_rate:.2f} "
          f"unk={out.unk_rate:.2f} {preds}")


def main(argv=None):
    """Run the CLI; returns the service, every arch-corpus result as
    ``(arch, layer, text, result)``, and the fuzz pass's counts."""
    ap = argparse.ArgumentParser(
        description="Ingest lowered MLIR text (StableHLO/affine) through "
                    "the tolerant front door and print cost predictions.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--arch", default=",".join(DEFAULT_ARCHS),
                    help="comma-separated architecture names from "
                         "repro_torch.configs.ARCHS to lower per-layer "
                         "and ingest ('all' = every registered arch, "
                         "'none' = skip the arch corpus)")
    ap.add_argument("--file", default=None,
                    help="path to an MLIR text file to ingest (e.g. "
                         "StableHLO a compiler printed)")
    ap.add_argument("--fuzz", type=int, default=0,
                    help="additionally push N seeded mutations "
                         "(truncations, byte flips, dialect splices) "
                         "of the corpus through predict_text; every "
                         "one must yield a prediction or a structured "
                         "IngestError, never an exception")
    ap.add_argument("--seq", type=int, default=8,
                    help="sequence length for the lowered subgraphs")
    ap.add_argument("--train-steps", type=int, default=150,
                    help="training steps for the demo model (0 = "
                         "untrained params: exercises the path only)")
    ap.add_argument("--n-graphs", type=int, default=400,
                    help="synthetic training-set size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", action="store_true",
                    help="serve through the fused CUDA forward "
                         "(repro_torch.kernels.ops): one launch of the "
                         "ids-in/predictions-out conv kernel a batch "
                         "(its plain PyTorch version on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device to train and serve on (default: "
                         "the CUDA card; 'cpu' off the card)")
    args = ap.parse_args(argv)

    svc = build_service(args)
    if args.kernel and torch.device(args.device or "cuda").type == "cuda":
        svc.warmup()
    print(f"service up: heads={list(svc.heads)} "
          f"vocab={len(svc.vocab.token_to_id)} ids "
          f"(unk_buckets={svc.vocab.n_unk_buckets} "
          f"byte_fallback={svc.vocab.byte_fallback})")

    texts, arch_rows = [], []
    if args.arch != "none":
        names = None if args.arch == "all" else args.arch.split(",")
        t0 = time.perf_counter()
        corpus = SH.lower_arch_corpus(names, seq=args.seq)
        print(f"lowered {len(corpus)} per-layer subgraphs of "
              f"{len({a for a, _, _ in corpus})} archs in "
              f"{time.perf_counter() - t0:.2f}s")
        for arch, layer, text in corpus:
            texts.append(text)
            out = svc.predict_text(text)
            arch_rows.append((arch, layer, text, out))
            show(f"{arch}/{layer}", out)

    if args.file:
        with open(args.file, "rb") as f:
            raw = f.read()
        texts.append(raw.decode("utf-8", "replace"))
        show(args.file, svc.predict_text(raw))

    fuzz = None
    if args.fuzz > 0:
        seeds = texts or [FD.AFFINE_EXAMPLE]
        corpus = FD.fuzz_corpus(seeds, args.fuzz,
                                np.random.default_rng(args.seed))
        ok = err = uncaught = 0
        for t in corpus:
            try:
                out = svc.predict_text(t)
                if isinstance(out, FD.IngestError):
                    err += 1
                else:
                    ok += 1
            except Exception as e:     # contract violation: report loudly
                uncaught += 1
                print(f"  UNCAUGHT {type(e).__name__}: {e!r}")
        print(f"fuzz: {len(corpus)} mutated inputs -> "
              f"{ok} predictions, {err} structured errors, "
              f"{uncaught} uncaught exceptions")
        fuzz = {"inputs": len(corpus), "predictions": ok,
                "errors": err, "uncaught": uncaught}

    ps = svc.phase_stats()
    print(f"ingested_texts={ps['ingested_texts']:.0f} "
          f"ingest_errors={ps['ingest_errors']:.0f} "
          f"oov_rate={ps['oov_rate']:.3f} "
          f"encode_s={ps.get('encode_s', 0.0):.3f}")
    return {"service": svc, "arch_rows": arch_rows, "fuzz": fuzz}


if __name__ == "__main__":
    main()
