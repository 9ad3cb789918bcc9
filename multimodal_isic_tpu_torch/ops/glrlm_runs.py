"""GLRLM run bookkeeping for the 4 angles of a batch of masked maps.

Counterpart of ``multimodal_isic_tpu/ops/pallas_glrlm.py::glrlm_runs_pallas``
(the Pallas kernel at :105) and ``unpack_runs`` (:118-123).  ``levels``
[M, H, W] int32 + ``inside`` [M, H, W] bool → packed [M, 4, H, W] int32, per
angle (dy, dx) of ``texture.ANGLES_2D`` and per inside cell
``start << 18 | gray << 11 | length``: the run-start flag (the previous cell
along the angle is outside the frame, outside the ROI or of another level),
the gray level, and the distance to the run's end along the angle + 1
(clipped to 11 bits); 0 outside the ROI.  The same bit layout (:32-34) and
the same asserts (:93-99) as the JAX package.

- On a CUDA tensor :func:`glrlm_runs` launches ``csrc/glrlm_runs.cu`` or
  raises: there is no fallback.
- On a CPU tensor it runs :func:`glrlm_runs_reference`, the doubling
  reverse-cummin formulation (``texture.run_starts_and_lengths``).

Integers only: the kernel equals the plain version bit for bit.  The wrapper
counts its kernel launches in ``glrlm_runs.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .glcm import check_maps
from .texture import ANGLES_2D, NG, run_starts_and_lengths

LEN_BITS = 11
GRAY_SHIFT = LEN_BITS
START_SHIFT = LEN_BITS + 7


def _check_sizes(h: int, w: int):
    # packed-run layout invariants: 11 length bits (runs < 2048) and 7 gray
    # bits (levels <= 127) -- fail loudly rather than corrupt features
    if h >= (1 << LEN_BITS) or w >= (1 << LEN_BITS):
        raise ValueError(f"glrlm_runs packs run lengths into {LEN_BITS} "
                         f"bits; {h}x{w} images can have longer runs")
    if NG > 127:
        raise ValueError(f"gray levels must fit 7 bits, NG={NG}")


def glrlm_runs_reference(levels: torch.Tensor,
                         inside: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`glrlm_runs`."""
    _check_sizes(*levels.shape[-2:])
    inside = inside.bool()
    lv = levels.to(torch.int32)
    out = []
    for dy, dx in ANGLES_2D:
        start, _, length = run_starts_and_lengths(lv, inside, dy, dx)
        length = torch.clamp(length, 0, (1 << LEN_BITS) - 1)
        packed = (torch.where(start, 1 << START_SHIFT, 0)
                  | (lv << GRAY_SHIFT) | length)
        out.append(torch.where(inside, packed, 0))
    return torch.stack(out, dim=1).to(torch.int32)


def unpack_runs(packed: torch.Tensor):
    """packed [..., H, W] → (start bool, gray int32, length int32)."""
    start = (packed >> START_SHIFT) > 0
    gray = (packed >> GRAY_SHIFT) & 0x7F
    length = packed & ((1 << LEN_BITS) - 1)
    return start, gray, length


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("glrlm_runs")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.glrlm_runs.argtypes = [vp, vp, vp, i32, i32, i32, vp]
    lib.glrlm_runs.restype = i32
    lib.glrlm_runs_error_string.argtypes = [i32]
    lib.glrlm_runs_error_string.restype = ctypes.c_char_p
    return lib


def glrlm_runs(levels: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """[M, H, W] int32 levels + bool inside → packed [M, 4, H, W] int32
    (module docstring)."""
    check_maps("glrlm_runs", levels, inside)
    _check_sizes(*levels.shape[-2:])
    if levels.device.type == "cpu":
        return glrlm_runs_reference(levels, inside)
    m, h, w = levels.shape
    out = torch.empty((m, 4, h, w), dtype=torch.int32, device=levels.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(levels.device):
        stream = torch.cuda.current_stream(levels.device).cuda_stream
        rc = lib.glrlm_runs(levels.data_ptr(), inside.data_ptr(),
                            out.data_ptr(), m, h, w, stream)
    if rc != 0:
        raise RuntimeError("glrlm_runs launch failed: "
                           f"{lib.glrlm_runs_error_string(rc).decode()}")
    glrlm_runs.launches += 1
    return out


glrlm_runs.launches = 0
