"""Batched affine image warp: bilinear, REFLECT_101 borders (ShiftScaleRotate).

Counterpart of ``multimodal_isic_tpu/ops/pallas_warp.py::affine_warp_batch``
and of the resampler it was held against,
``multimodal_isic_tpu/data/augment.py::_mirror_coord/_warp_taps``.  The
public function keeps the JAX signature (``imgs`` [B, H, W, C] float32 on the
0..255 scale, ``inv`` [B, 6] float32, ``out_hw``) and adds ``apply``, the
policy's per-image flags: an image whose flag is False comes through
unchanged, in the same launch.  There is no ``pad``, band, row-block or
``compute_dtype`` argument: the CUDA kernel reflects coordinates in place
(no padded copy, no band, exact for any affine map and image size) and
computes in float32 only.

- On a CUDA tensor :func:`affine_warp_batch` launches the hand-written kernel
  in ``csrc/affine_warp.cu`` (built with nvcc at first use, see ``_build``),
  or raises: there is no fallback.  A warp writes a strip of 128 output
  pixels of a row, four a lane, through a row buffer in shared memory with
  16-byte stores; the wrapper owns the launch plan (:func:`warp_plan`) and
  the library refuses any other.
- On a CPU tensor it runs :func:`affine_warp_batch_reference`, the batched
  ``_warp_taps`` gather (order 1) at the same coordinates, which the tests
  hold against the JAX package and which the card's smoke run holds the
  kernel against.

:func:`affine_warp_grid_sample` computes the same function with one
PyTorch library call.  Nothing on the training path calls it: it is the
independent oracle and the library yardstick of the tests and the smoke run.

The wrapper counts its kernel launches in ``affine_warp_batch.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# The card's kernel (csrc/affine_warp.cu; its constants of the same names)
THREADS = 256
WARPS = THREADS // 32
PX_LANE = 4                 # output pixels a lane
STRIP = 32 * PX_LANE        # output pixels a warp's task: one row's strip
MAX_C = 56                  # channels the row buffers of a block hold
MAX_SMEM = 232448           # shared memory a block may have on the H100


@functools.cache
def warp_plan(b: int, h: int, w: int, c: int, oh: int, ow: int) -> dict:
    """The card's launch plan: ``px_lane`` output pixels a lane (pixels j,
    j + 32, ... of a warp's strip of ``strip`` pixels of one output row),
    ``threads`` a block (a warp a strip), ``blocks`` to cover the B·OH rows'
    strips once, no source stage (``stage`` 0 bytes: the taps come from
    device memory through L1) and ``smem``: a row buffer of strip·C + 4
    floats a warp, through which a strip goes out in 16-byte stores.  The
    library refuses any other plan.  Raises ``ValueError`` for what the
    kernel cannot take."""
    if min(b, h, w, c, oh, ow) < 1 or c > MAX_C:
        raise ValueError(f"affine_warp_batch: no plan for [{b}, {h}, {w}, "
                         f"{c}] → {oh}x{ow}")
    tasks = b * oh * -(-ow // STRIP)
    if tasks >= 2 ** 31:
        raise ValueError(f"affine_warp_batch: {tasks} strips > 2^31 - 1")
    return {"px_lane": PX_LANE, "strip": STRIP, "threads": THREADS,
            "tasks": tasks, "blocks": -(-tasks // WARPS), "stage": 0,
            "smem": WARPS * (STRIP * c + 4) * 4}


# ----------------------------------------------------------- plain versions

def mirror_coord(c: torch.Tensor, n: int) -> torch.Tensor:
    """Continuous coordinate reflected into [0, n-1], REFLECT_101 (period
    2n-2, no edge repeat: scipy ``mode='mirror'``, cv2 BORDER_REFLECT_101).
    ``fmod`` is exact, as the JAX ``%`` of a non-negative value is."""
    if n == 1:
        return torch.zeros_like(c)
    period = 2.0 * (n - 1)
    m = torch.fmod(c.abs(), period)
    return torch.minimum(m, period - m)


def warp_taps(x: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor,
              order: int) -> torch.Tensor:
    """Bilinear (order 1) or nearest (order 0) resample of a batch ``x``
    [B, H, W(, C)] at per-pixel source coordinates [B, ...], REFLECT_101
    borders: the JAX ``_warp_taps`` for every image of the batch.  The +1
    taps are clamped to the last row/column, where the reflected coordinate
    gives them weight exactly 0 (the JAX edge duplicates)."""
    b, h, w = x.shape[:3]
    sy = mirror_coord(src_y, h)
    sx = mirror_coord(src_x, w)
    x3 = x if x.dim() == 4 else x[..., None]
    flat = x3.reshape(b, h * w, x3.shape[-1])

    def take(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, flat.shape[-1])
        return torch.gather(flat, 1, idx).reshape(*src_y.shape, flat.shape[-1])

    if order == 0:
        out = take(torch.round(sy).long(), torch.round(sx).long())
    else:
        y0, x0 = torch.floor(sy), torch.floor(sx)
        fy, fx = (sy - y0)[..., None], (sx - x0)[..., None]
        y0, x0 = y0.long(), x0.long()
        y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
        out = (take(y0, x0) * (1 - fy) * (1 - fx)
               + take(y0, x1) * (1 - fy) * fx
               + take(y1, x0) * fy * (1 - fx)
               + take(y1, x1) * fy * fx)
    return out if x.dim() == 4 else out[..., 0]


def affine_coords(inv: torch.Tensor, out_hw: Tuple[int, int]):
    """(src_y, src_x) [B, oh, ow] of every output pixel under the inverse
    affines ``inv`` [B, 6]: sx = i11·x + i12·y + i13, sy = i21·x + i22·y +
    i23, in float32 and in the JAX order of operations."""
    oh, ow = out_hw
    ys = torch.arange(oh, dtype=torch.float32, device=inv.device)[:, None]
    xs = torch.arange(ow, dtype=torch.float32, device=inv.device)[None, :]
    p = inv.float()[:, :, None, None]
    return p[:, 3] * xs + p[:, 4] * ys + p[:, 5], p[:, 0] * xs + p[:, 1] * ys + p[:, 2]


def affine_warp_batch_reference(imgs: torch.Tensor, inv: torch.Tensor,
                                out_hw: Tuple[int, int] = (380, 380),
                                apply: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain version of :func:`affine_warp_batch`: :func:`warp_taps`
    (order 1) at :func:`affine_coords`, then the per-image select."""
    src_y, src_x = affine_coords(inv, out_hw)
    warped = warp_taps(imgs, src_y, src_x, 1)
    if apply is None:
        return warped
    return torch.where(apply[:, None, None, None], warped, imgs)


def affine_warp_grid_sample(imgs: torch.Tensor, inv: torch.Tensor,
                            out_hw: Tuple[int, int] = (380, 380)
                            ) -> torch.Tensor:
    """The same warp as one library call: ``F.grid_sample`` (bilinear,
    reflection, ``align_corners=True``, whose reflection about the extreme
    pixel centres is REFLECT_101) on the pixel-space affine conjugated by
    the normalisation x_n = 2x/(n-1) - 1.  Not used by the port."""
    b, h, w, _ = imgs.shape
    oh, ow = out_hw
    p = inv.double()
    sx_o, sy_o = (ow - 1) / 2.0, (oh - 1) / 2.0  # d(pixel)/d(normalised)
    theta = torch.stack([
        torch.stack([p[:, 0] * sx_o, p[:, 1] * sy_o,
                     p[:, 0] * sx_o + p[:, 1] * sy_o + p[:, 2]], 1)
        / ((w - 1) / 2.0),
        torch.stack([p[:, 3] * sx_o, p[:, 4] * sy_o,
                     p[:, 3] * sx_o + p[:, 4] * sy_o + p[:, 5]], 1)
        / ((h - 1) / 2.0)], 1)
    theta[:, :, 2] -= 1.0
    grid = F.affine_grid(theta.float(), (b, imgs.shape[-1], oh, ow),
                         align_corners=True)
    out = F.grid_sample(imgs.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="reflection", align_corners=True)
    return out.permute(0, 2, 3, 1)


# -------------------------------------------------------------- the kernel

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("affine_warp")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.affine_warp_f32.argtypes = [vp] * 4 + [i32] * 11 + [vp]
    lib.affine_warp_f32.restype = i32
    lib.affine_warp_error_string.argtypes = [i32]
    lib.affine_warp_error_string.restype = ctypes.c_char_p
    return lib


def _check(imgs: torch.Tensor, inv: torch.Tensor, out_hw, apply):
    if imgs.dim() != 4 or imgs.dtype != torch.float32:
        raise ValueError(f"imgs must be float32 [B, H, W, C], got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    bsz = imgs.shape[0]
    if tuple(inv.shape) != (bsz, 6) or inv.dtype != torch.float32:
        raise ValueError(f"inv must be float32 [{bsz}, 6], got "
                         f"{inv.dtype} {tuple(inv.shape)}")
    if len(out_hw) != 2 or min(out_hw) < 1:
        raise ValueError(f"out_hw must be two positive sizes, got {out_hw}")
    if apply is not None:
        if tuple(apply.shape) != (bsz,) or apply.dtype != torch.bool:
            raise ValueError(f"apply must be bool [{bsz}], got "
                             f"{apply.dtype} {tuple(apply.shape)}")
        if tuple(out_hw) != tuple(imgs.shape[1:3]):
            raise ValueError("apply needs out_hw == the input size: an image "
                             "not drawn comes through unchanged")
    for t in (inv, apply):
        if t is not None and t.device != imgs.device:
            raise ValueError(f"all tensors must be on {imgs.device}")


def affine_warp_batch(imgs: torch.Tensor, inv: torch.Tensor,
                      out_hw: Tuple[int, int] = (380, 380),
                      apply: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp [B, H, W, C] float32 by per-image inverse affines [B, 6] →
    [B, oh, ow, C] float32.

    ``inv`` rows are (i11, i12, i13, i21, i22, i23) mapping output pixel
    (x, y) to source coordinates sx = i11·x + i12·y + i13,
    sy = i21·x + i22·y + i23, the matrix ``data.augment.ssr_inverse``
    builds.  ``apply`` (bool [B], optional; needs ``out_hw`` equal to the
    input size) leaves the images whose flag is False unchanged.
    """
    _check(imgs, inv, out_hw, apply)
    if imgs.device.type == "cpu":
        return affine_warp_batch_reference(imgs, inv, out_hw, apply)
    if imgs.device.type != "cuda":
        raise ValueError(f"affine_warp_batch: tensors must be on the CPU or a "
                         f"CUDA device, got {imgs.device}")
    for name, t in (("imgs", imgs), ("inv", inv), ("apply", apply)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"affine_warp_batch: {name} must be contiguous")
    bsz, h, w, c = imgs.shape
    if imgs.data_ptr() % 16:
        raise ValueError("affine_warp_batch: imgs must be 16-byte aligned")
    oh, ow = out_hw
    out = torch.empty((bsz, oh, ow, c), dtype=torch.float32, device=imgs.device)
    if out.numel() == 0:
        return out
    p = warp_plan(bsz, h, w, c, oh, ow)
    lib = _lib()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        rc = lib.affine_warp_f32(
            imgs.data_ptr(), inv.data_ptr(),
            None if apply is None else apply.data_ptr(), out.data_ptr(),
            bsz, h, w, c, oh, ow, p["px_lane"], p["threads"], p["blocks"],
            p["stage"], p["smem"], stream)
    if rc != 0:
        raise RuntimeError("affine_warp_batch launch failed: "
                           f"{lib.affine_warp_error_string(rc).decode()}")
    affine_warp_batch.launches += 1
    return out


affine_warp_batch.launches = 0
