"""Train a reduced registered-architecture LM end to end on synthetic
data with the PyTorch port — the model zoo, AdamW, the data pipeline and
checkpointing together. Runs on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_smoke_torch.py \\
        --arch qwen3-0.6b --steps 30
"""
import argparse
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data import pipeline as PIPE
from repro_torch.models import model as MODEL
from repro_torch.models import steps as STEPS
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="checkpoints/lm_smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' off the card)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_arch(args.arch).reduced()
    with dev:
        params = MODEL.init_params(
            torch.Generator(dev).manual_seed(0), cfg)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=args.steps,
                                warmup_steps=5)
    train_step = STEPS.make_train_step(cfg, opt_cfg)
    opt_state = adamw.init_state(params)
    data = PIPE.synthetic_lm_batches(cfg.vocab, args.batch, args.seq)

    print(f"training reduced {args.arch} for {args.steps} steps on "
          f"{dev} ...")
    t0 = time.time()
    losses = []
    for step in range(1, args.steps + 1):
        b = next(data)
        batch = {"tokens": torch.from_numpy(b["tokens"]).to(dev),
                 "labels": torch.from_numpy(b["labels"]).to(dev)}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = torch.zeros(
                (args.batch, cfg.vision_patches, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        if cfg.frontend == "audio":
            batch["frame_embeds"] = torch.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        params, opt_state, m = train_step(params, opt_state, batch)
        losses.append(m["loss"])
        if step % 10 == 0 or step == 1:
            print(f"  step {step}: loss={float(m['loss']):.4f} "
                  f"grad_norm={float(m['grad_norm']):.3f}")
    ckpt.save(args.ckpt_dir, args.steps, params)
    print(f"done in {time.time()-t0:.1f}s; checkpoint saved to "
          f"{args.ckpt_dir}")
    return {"losses": [float(v) for v in losses], "params": params}


if __name__ == "__main__":
    main()
