"""Gray-level co-occurrence matrices of a batch of masked maps.

Counterpart of ``multimodal_isic_tpu/ops/pallas_glcm.py::
glcm_matrices_pallas`` (the Pallas kernel at :95) and of the XLA form it
replaced, ``texture.glcm_matrices``.  ``levels`` [M, H, W] int32 (1..NG
inside, 0 outside) and ``mask`` [M, H, W] (inside where > 0) → [M, 4, NG, NG]
float32 symmetric counts: for each of the 4 force2D angles (dy, dx), the
pair (centre, centre + (dy, dx)) counts when the centre is inside and the
neighbour is in the frame and inside (``_neighbor_columns``, :64-78), and
the mirror pair is added (P + Pᵀ).

- On a CUDA tensor :func:`glcm_matrices` launches ``csrc/glcm.cu`` or
  raises: there is no fallback.  One thread-block cluster counts a map,
  each block a band of rows in 16-bit counters of the bins (min, max), and
  the cluster writes P + Pᵀ through distributed shared memory: one device
  launch a call, no memset, every output word written once.  The wrapper owns the launch
  plan (:func:`glcm_plan`); the library recomputes its own and refuses any
  other.
- On a CPU tensor it runs :func:`glcm_matrices_reference`: one count over
  the packed key (map, angle, centre, neighbour).

The counts are integers, so the kernel equals the plain version bit for bit.
The wrapper counts its kernel launches in ``glcm_matrices.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .texture import ANGLES_2D, NG, bincount, map_offsets, shift2d

_MAX_MAPS = 65535  # gridDim.y

# The card's kernel (csrc/glcm.cu; its constants of the same names)
CLUSTER = 8             # blocks a map: a thread-block cluster
THREADS = 256
MAX_BAND_PX = 65535     # pixels a band: its counters are 16 bits
MAX_SMEM = 232448       # shared memory a block may have on the H100
TRI = NG * (NG + 1) // 2            # counted bins an angle: (min, max)
SLICE = 4 * TRI // CLUSTER          # counted bins a block sums
RING, SLOT = 4, 128 * 5 + 16        # a warp's row slots, bytes a slot
# the packed histogram (two 16-bit counters a word), the slice totals
# (int32), the warps' row rings
SMEM = 4 * TRI * 2 + SLICE * 4 + THREADS // 32 * RING * SLOT


@functools.cache
def glcm_plan(m: int, h: int, w: int) -> dict:
    """The card's launch plan for [m, h, w] maps: a cluster of ``cluster``
    blocks a map, block r counting the centres of band ``round * cluster +
    r`` of ``band_h`` rows (the H rows split evenly over the cluster, cut
    to at most ``MAX_BAND_PX`` pixels a band so that no 16-bit counter can
    overflow), ``rounds`` rounds of bands to cover H; ``threads`` and
    shared memory (``smem``: the packed histogram, the slice totals, the
    warps' rings of rows) a block.  The library refuses
    any other plan.  Raises ``ValueError`` for maps the kernel cannot
    take."""
    if m < 1 or m > _MAX_MAPS or h < 1 or w < 1 or w > MAX_BAND_PX:
        raise ValueError(f"glcm_matrices: no plan for {m} maps of {h}x{w}")
    band_h = min(-(-h // CLUSTER), MAX_BAND_PX // w)
    return {"cluster": CLUSTER, "band_h": band_h,
            "rounds": -(-h // (CLUSTER * band_h)), "threads": THREADS,
            "smem": SMEM}


def glcm_matrices_reference(levels: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`glcm_matrices`."""
    m = levels.shape[0]
    lv = torch.where(mask > 0, levels, 0)
    ok_c = (lv >= 1) & (lv <= NG)
    base = map_offsets(m, 4 * NG * NG, levels.device)
    keys = []
    for a, (dy, dx) in enumerate(ANGLES_2D):
        nbr = shift2d(lv, -dy, -dx, 0)      # nbr[p] = lv[p + (dy, dx)]
        ok = ok_c & (nbr >= 1) & (nbr <= NG)
        key = base + (a * NG + lv - 1) * NG + nbr - 1
        keys.append(torch.where(ok, key, m * 4 * NG * NG))
    p = bincount(torch.stack(keys), m * 4 * NG * NG).view(m, 4, NG, NG)
    return p + p.transpose(-1, -2)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("glcm")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.glcm_counts.argtypes = [vp, vp, vp] + [i32] * 8 + [vp]
    lib.glcm_counts.restype = i32
    lib.glcm_error_string.argtypes = [i32]
    lib.glcm_error_string.restype = ctypes.c_char_p
    return lib


def check_maps(name: str, levels: torch.Tensor, mask: torch.Tensor):
    """Shared argument check of the radiomics kernels: int32 [M, H, W]
    levels and a mask of the same shape (bool or uint8), one device."""
    if levels.dim() != 3 or levels.dtype != torch.int32:
        raise ValueError(f"{name}: levels must be int32 [M, H, W], got "
                         f"{levels.dtype} {tuple(levels.shape)}")
    if mask.shape != levels.shape or mask.dtype not in (torch.bool,
                                                        torch.uint8):
        raise ValueError(f"{name}: mask must be bool or uint8 "
                         f"{tuple(levels.shape)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if mask.device != levels.device:
        raise ValueError(f"{name}: levels and mask must be on one device")
    if levels.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA "
                         f"device, got {levels.device}")
    if levels.device.type == "cuda":
        for what, t in (("levels", levels), ("mask", mask)):
            if not t.is_contiguous():
                raise ValueError(f"{name}: {what} must be contiguous")
        if levels.shape[0] > _MAX_MAPS:
            raise ValueError(f"{name}: {levels.shape[0]} maps > {_MAX_MAPS}")


def glcm_matrices(levels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[M, H, W] int32 levels + mask → [M, 4, NG, NG] float32 symmetric
    co-occurrence counts (module docstring)."""
    check_maps("glcm_matrices", levels, mask)
    if levels.device.type == "cpu":
        return glcm_matrices_reference(levels, mask)
    m, h, w = levels.shape
    if m == 0 or h * w == 0:
        return torch.zeros((m, 4, NG, NG), dtype=torch.float32,
                           device=levels.device)
    p = glcm_plan(m, h, w)
    out = torch.empty((m, 4, NG, NG), dtype=torch.float32,
                      device=levels.device)
    lib = _lib()
    with torch.cuda.device(levels.device):
        stream = torch.cuda.current_stream(levels.device).cuda_stream
        rc = lib.glcm_counts(levels.data_ptr(), mask.data_ptr(),
                             out.data_ptr(), m, h, w, p["cluster"],
                             p["band_h"], p["rounds"], p["threads"],
                             p["smem"], stream)
    if rc != 0:
        raise RuntimeError("glcm_matrices launch failed: "
                           f"{lib.glcm_error_string(rc).decode()}")
    glcm_matrices.launches += 1
    return out


glcm_matrices.launches = 0
