"""Numeric ops: resizes, metrics; hand-written CUDA kernels in ``cuda/``."""
