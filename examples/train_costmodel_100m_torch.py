"""End-to-end driver on the PyTorch port: train the cost model for a few
hundred steps with the full substrate (bucketed data pipeline, AdamW,
int8 error-feedback grad compression, atomic checkpoints + resume),
through ``repro_torch.launch.train``. Trains on the CUDA card unless
``--device cpu``; the other flags are the train CLI's.

    # demo scale:
    PYTHONPATH=src python examples/train_costmodel_100m_torch.py \\
        --steps 300

    # the ~100M config:
    PYTHONPATH=src python examples/train_costmodel_100m_torch.py \\
        --preset 100m --steps 200
"""
import sys

from repro_torch.launch import train


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--preset") for a in args):
        args = ["--preset", "base"] + args
    if not any(a.startswith("--steps") for a in args):
        args += ["--steps", "300"]
    return train.main(["--compress-grads", "--target",
                       "register_pressure"] + args)


if __name__ == "__main__":
    main()
