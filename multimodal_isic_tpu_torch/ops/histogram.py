"""Joint histograms of code pairs, batched over rows.

Counterpart of ``multimodal_isic_tpu/ops/pallas_hist.py::
joint_histogram_pallas`` (the Pallas kernel at :81): codes in 1..n, 0 = skip
→ P[a−1, b−1] = #{k : codes_a[k] = a ∧ codes_b[k] = b}.  Here it is batched:
``codes_a``, ``codes_b`` [B, N] int32 → [B, na, nb] float32; a pair counts
only when 1 ≤ a ≤ na and 1 ≤ b ≤ nb (the one-hot rows of the Pallas kernel
drop every other code).  On the radiomics path the rows are map × angle and
the pairs are (gray, run length) at the run starts: the GLRLM matrix.
(``firstorder_accumulate_pallas``, the other kernel of that file, has no
caller on the path and is not ported yet.)

- On a CUDA tensor :func:`joint_histogram` launches ``csrc/histogram.cu`` or
  raises: there is no fallback.
- On a CPU tensor it runs :func:`joint_histogram_reference`: one count over
  the key row·na·nb + (a−1)·nb + (b−1).

Counts are integers, exact in float32 below 2²⁴: the kernel equals the plain
version bit for bit.  The wrapper counts its kernel launches in
``joint_histogram.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .texture import bincount

SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
_MAX_ROWS = 65535     # gridDim.y


def joint_histogram_reference(codes_a: torch.Tensor, codes_b: torch.Tensor,
                              na: int, nb: int) -> torch.Tensor:
    """Plain version of :func:`joint_histogram`."""
    rows = codes_a.shape[0]
    ok = (codes_a >= 1) & (codes_a <= na) & (codes_b >= 1) & (codes_b <= nb)
    row = torch.arange(rows, device=codes_a.device)[:, None] * (na * nb)
    key = row + (codes_a.long() - 1) * nb + codes_b.long() - 1
    key = torch.where(ok, key, rows * na * nb)
    return bincount(key, rows * na * nb).view(rows, na, nb)


def library_joint_histogram(codes_a: torch.Tensor, codes_b: torch.Tensor,
                            na: int, nb: int) -> torch.Tensor:
    """The same function as one ``torch.bincount`` over the packed key
    row·na·nb + (a−1)·nb + (b−1) of the counted pairs (the key is built and
    the skipped pairs dropped here too).  Not used by the port: the
    yardstick of the card's smoke run."""
    rows = codes_a.shape[0]
    ok = (codes_a >= 1) & (codes_a <= na) & (codes_b >= 1) & (codes_b <= nb)
    row = torch.arange(rows, device=codes_a.device)[:, None] * (na * nb)
    key = (row + (codes_a.long() - 1) * nb + codes_b.long() - 1)[ok]
    return torch.bincount(key, minlength=rows * na * nb).view(
        rows, na, nb).float()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("histogram")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.joint_histogram.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.joint_histogram.restype = i32
    lib.joint_histogram_error_string.argtypes = [i32]
    lib.joint_histogram_error_string.restype = ctypes.c_char_p
    return lib


def joint_histogram(codes_a: torch.Tensor, codes_b: torch.Tensor, na: int,
                    nb: int) -> torch.Tensor:
    """[B, N] int32 code pairs → [B, na, nb] float32 counts (module
    docstring)."""
    if codes_a.dim() != 2 or codes_a.dtype != torch.int32:
        raise ValueError(f"joint_histogram: codes_a must be int32 [B, N], "
                         f"got {codes_a.dtype} {tuple(codes_a.shape)}")
    if codes_b.shape != codes_a.shape or codes_b.dtype != torch.int32:
        raise ValueError(f"joint_histogram: codes_b must be int32 "
                         f"{tuple(codes_a.shape)}, got {codes_b.dtype} "
                         f"{tuple(codes_b.shape)}")
    if codes_b.device != codes_a.device:
        raise ValueError("joint_histogram: codes must be on one device")
    if na < 1 or nb < 1:
        raise ValueError(f"joint_histogram: na, nb must be >= 1, got {na}, {nb}")
    if codes_a.device.type == "cpu":
        return joint_histogram_reference(codes_a, codes_b, na, nb)
    if codes_a.device.type != "cuda":
        raise ValueError(f"joint_histogram: tensors must be on the CPU or a "
                         f"CUDA device, got {codes_a.device}")
    for name, t in (("codes_a", codes_a), ("codes_b", codes_b)):
        if not t.is_contiguous():
            raise ValueError(f"joint_histogram: {name} must be contiguous")
    if na * nb * 4 > SMEM_LIMIT:
        raise ValueError(f"joint_histogram: a {na}x{nb} int32 histogram "
                         f"exceeds one block's {SMEM_LIMIT} B of shared memory")
    rows, n = codes_a.shape
    if rows > _MAX_ROWS:
        raise ValueError(f"joint_histogram: {rows} rows > {_MAX_ROWS}")
    out = torch.zeros((rows, na, nb), dtype=torch.float32,
                      device=codes_a.device)
    if rows == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(codes_a.device):
        stream = torch.cuda.current_stream(codes_a.device).cuda_stream
        rc = lib.joint_histogram(codes_a.data_ptr(), codes_b.data_ptr(),
                                 out.data_ptr(), rows, n, na, nb, stream)
    if rc != 0:
        raise RuntimeError("joint_histogram launch failed: "
                           f"{lib.joint_histogram_error_string(rc).decode()}")
    joint_histogram.launches += 1
    return out


joint_histogram.launches = 0
