"""The benchmark of the cost model's PyTorch and CUDA port: see run.py."""
