"""PyTorch + CUDA port of ``multimodal_isic_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; every module here names
its JAX counterpart.  Subpackages mirror the JAX layout (``core``, ``data``,
``models``, ``ops``, ``train``, ``utils``) and import nothing eagerly: the
CUDA kernels under ``csrc/`` are built with nvcc at their first launch.
"""
