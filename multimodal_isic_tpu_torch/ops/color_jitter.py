"""Colour jitter: brightness, contrast, saturation and hue, each image in its
own order (torchvision ColorJitter), on [B, H, W, 3] float32 on the 0..255
scale.

Counterpart of ``multimodal_isic_tpu/data/augment.py::color_jitter``
(:331-423), which is plain jnp: no ``pallas_call`` stands behind it.  The
draws (``data/augment.py::color_jitter_draw``) give, per image, ``apply``
(bool), the factors ``brightness``, ``contrast``, ``saturation`` and ``hue``
(float32) and ``perm`` (int64 [4]), the order of the adjustments
(brightness 0, contrast 1, saturation 2, hue 3).

- On a CUDA tensor :func:`color_jitter_batch` launches the hand-written
  kernel in ``csrc/color_jitter.cu`` (built with nvcc at first use, see
  ``_build``), or raises: there is no fallback.  One launch, a thread-block
  cluster an image: the order's prefix before contrast and the gray mean in
  one pass, then the whole order in a second pass over the image, from L2
  where it is still there.  The wrapper owns the launch plan
  (:func:`jitter_plan`) and the library refuses any other.
- On a CPU tensor it runs :func:`color_jitter_reference`, which the tests
  hold against the JAX package and the card's tests hold the kernel
  against.

The wrapper counts its kernel launches in ``color_jitter_batch.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import _build

LUMA = (0.299, 0.587, 0.114)

# The card's kernel (csrc/color_jitter.cu; its constants of the same names)
CLUSTER = 8        # blocks an image: one thread-block cluster
THREADS = 512
CHUNK = 128        # pixels a warp's step
MAX_BATCH = 65535  # the grid's second dimension


@functools.cache
def jitter_plan(b: int, h: int, w: int) -> dict:
    """The card's launch plan: a cluster of ``cluster`` blocks of
    ``threads`` an image (``blocks`` = cluster · b in all), block r taking
    the image's pixels [r·slice, (r + 1)·slice), ``slice`` an eighth of the
    H·W pixels rounded up to whole chunks of ``chunk``.  It depends on the
    image size alone, so an image's result does not depend on its batch.
    The library refuses any other plan.  Raises ``ValueError`` for what the
    kernel cannot take."""
    n = h * w
    if min(b, h, w) < 1 or b > MAX_BATCH or 3 * n + 3 * CHUNK >= 2 ** 31:
        raise ValueError(f"color_jitter_batch: no plan for [{b}, {h}, {w}, 3]")
    per = -(-n // CLUSTER)
    return {"cluster": CLUSTER, "threads": THREADS, "chunk": CHUNK,
            "slice": -(-per // CHUNK) * CHUNK, "blocks": CLUSTER * b}


# ----------------------------------------------------------- plain versions

def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12),
                    torch.zeros_like(maxc))
    safe = delta.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0),
                    torch.zeros_like(h))
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)

    def pick(opts):
        out = opts[5]
        for idx in range(4, -1, -1):
            out = torch.where(i == idx, opts[idx], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-1)


def color_jitter_reference(imgs: torch.Tensor, draws: Dict[str, torch.Tensor]
                           ) -> torch.Tensor:
    """Plain version of :func:`color_jitter_batch`: the four adjustments in
    each image's own order ``perm``.  Step i computes the four adjustments
    of the batch and selects per image the one ``perm[:, i]`` names, which
    is the JAX ``lax.switch`` order exactly."""
    lum = torch.tensor(LUMA, dtype=imgs.dtype, device=imgs.device)
    f = {k: draws[k].to(imgs.dtype).view(-1, 1, 1, 1)
         for k in ("brightness", "contrast", "saturation")}
    fh = draws["hue"].to(imgs.dtype).view(-1, 1, 1)

    def adj_brightness(x):
        return x * f["brightness"]

    def adj_contrast(x):
        mean = (x.clamp(0, 255) @ lum).mean(dim=(1, 2)).view(-1, 1, 1, 1)
        return mean + f["contrast"] * (x - mean)

    def adj_saturation(x):
        gray = (x.clamp(0, 255) @ lum)[..., None]
        return gray + f["saturation"] * (x - gray)

    def adj_hue(x):
        hsv = _rgb_to_hsv(x.clamp(0, 255) / 255.0)
        shifted = torch.stack([torch.remainder(hsv[..., 0] + fh, 1.0),
                               hsv[..., 1], hsv[..., 2]], dim=-1)
        return _hsv_to_rgb(shifted) * 255.0

    adjust = (adj_brightness, adj_contrast, adj_saturation, adj_hue)
    out = imgs
    for step in range(4):
        which = draws["perm"][:, step]
        cands = [fn(out) for fn in adjust]
        new = cands[3]
        for j in (2, 1, 0):
            new = torch.where((which == j).view(-1, 1, 1, 1), cands[j], new)
        out = new
    out = out.clamp(0.0, 255.0)
    return torch.where(draws["apply"].view(-1, 1, 1, 1), out, imgs)


# -------------------------------------------------------------- the kernel

FACTORS = ("brightness", "contrast", "saturation", "hue")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("color_jitter")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.color_jitter_f32.argtypes = [vp] * 8 + [i32] * 5 + [vp]
    lib.color_jitter_f32.restype = i32
    lib.color_jitter_error_string.argtypes = [i32]
    lib.color_jitter_error_string.restype = ctypes.c_char_p
    return lib


def _check(imgs: torch.Tensor, args: Dict[str, torch.Tensor]):
    if imgs.dim() != 4 or imgs.shape[-1] != 3 or imgs.dtype != torch.float32:
        raise ValueError(f"imgs must be float32 [B, H, W, 3], got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    bsz = imgs.shape[0]
    want = {"apply": ((bsz,), torch.bool), "perm": ((bsz, 4), torch.int64),
            **{k: ((bsz,), torch.float32) for k in FACTORS}}
    for name, (shape, dtype) in want.items():
        t = args[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != imgs.device:
            raise ValueError(f"all tensors must be on {imgs.device}, {name} "
                             f"is on {t.device}")


def color_jitter_batch(imgs: torch.Tensor, apply: torch.Tensor,
                       brightness: torch.Tensor, contrast: torch.Tensor,
                       saturation: torch.Tensor, hue: torch.Tensor,
                       perm: torch.Tensor) -> torch.Tensor:
    """ColorJitter on [B, H, W, 3] float32 (0..255) → a new [B, H, W, 3]
    float32.

    ``apply`` bool [B] (an image whose flag is False comes out equal to its
    input, bit for bit), the factors float32 [B] and ``perm`` int64 [B, 4],
    as ``data.augment.color_jitter_draw`` gives them.  Each row of ``perm``
    must be a permutation of 0..3: neither path checks it, and for another
    row the kernel's result and the plain version's differ.
    """
    args = {"apply": apply, "brightness": brightness, "contrast": contrast,
            "saturation": saturation, "hue": hue, "perm": perm}
    _check(imgs, args)
    if imgs.device.type == "cpu":
        return color_jitter_reference(imgs, args)
    if imgs.device.type != "cuda":
        raise ValueError(f"color_jitter_batch: tensors must be on the CPU or "
                         f"a CUDA device, got {imgs.device}")
    for name, t in (("imgs", imgs), *args.items()):
        if not t.is_contiguous():
            raise ValueError(f"color_jitter_batch: {name} must be contiguous")
    bsz, h, w, _ = imgs.shape
    out = torch.empty_like(imgs)
    if out.numel() == 0:
        return out
    p = jitter_plan(bsz, h, w)
    lib = _lib()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        rc = lib.color_jitter_f32(
            imgs.data_ptr(), apply.data_ptr(),
            *(args[k].data_ptr() for k in FACTORS), perm.data_ptr(),
            out.data_ptr(), bsz, h * w, p["cluster"], p["threads"],
            p["slice"], stream)
    if rc != 0:
        raise RuntimeError("color_jitter_batch launch failed: "
                           f"{lib.color_jitter_error_string(rc).decode()}")
    color_jitter_batch.launches += 1
    return out


color_jitter_batch.launches = 0
