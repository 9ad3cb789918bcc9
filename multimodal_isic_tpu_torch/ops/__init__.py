"""Tensor ops and the hand-written CUDA kernels (``csrc/``) that replace the
JAX package's Pallas kernels."""
