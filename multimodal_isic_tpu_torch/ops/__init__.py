"""Tensor ops and the hand-written CUDA kernels (``csrc/``) that replace the
JAX package's Pallas kernels, and the colour jitter's, which replaces plain
code."""
