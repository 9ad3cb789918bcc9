"""Full float32 products whatever the global TF32 flags say.

The JAX package runs its distance and solver products at
``Precision.HIGHEST`` (``analysis/ann.py:50-55``, ``analysis/kmeans.py:
27-31``, ``analysis/embed.py:40-44``): a reduced-precision ``‖x‖² −
2x·yᵀ + ‖y‖²`` loses the in-cluster distance differences (kNN recall@15
fell from 0.998 to 0.18 on the TPU).  TF32 on the card is the same
hazard.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """Matrix products and convolutions in full float32 (no TF32) inside
    the block, whatever the global flags; restored after.  The products'
    setting is read and written through cuBLAS's own flag
    (``torch.backends.cuda.matmul.fp32_precision``): the process-wide
    ``get_float32_matmul_precision`` raises once a caller has mixed the
    legacy ``allow_tf32`` flag with the newer setters."""
    matmul = torch.backends.cuda.matmul.fp32_precision
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.fp32_precision = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
