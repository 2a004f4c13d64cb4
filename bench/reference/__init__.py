"""The plain reference the benchmark holds the port against.

Plain PyTorch and NumPy. It imports neither JAX, nor the JAX package,
nor anything of the port: it reads each graph's fields (``values``,
``n_args``, ``ops``, ``outputs``) and is handed the vocabulary and the
weights that the benchmark made.
"""
