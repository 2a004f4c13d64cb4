"""PyTorch/CUDA port of the MLIR cost-model system.

Mirrors the reference package's layout module for module: each module
here sits at the same relative path as its counterpart. Plain tensor
code is PyTorch; the serving forward runs a hand-written CUDA kernel
(``kernels/csrc``) on an NVIDIA Hopper card. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
