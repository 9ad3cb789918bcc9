"""Device-side preprocessing and the fusion train-time augmentations.

Counterpart of ``multimodal_isic_tpu/data/augment.py`` (:22-130 eval
preprocess and ``crop_and_resize``, :132-326 geometric, :331-423 colour,
:428-554 the fusion and MAE policies).

Eval preprocess: the separable half-pixel-centre bilinear resize
(cv2.INTER_LINEAR, no antialias) written as two dense banded matmuls,
``A_h @ X @ A_wᵀ``, which cuBLAS runs on the tensor cores in bf16 for the
serving path; in float32 it is the JAX ``resize_bilinear`` too, which the
per-image policy uses (the fusion and MAE eval policies).

Augmentations work on whole batches [B, H, W, C] (float32, 0..255) and are
split in two, because ``jax.random`` and ``torch.Generator`` give different
numbers from one seed:

- a *draw* function (generator, batch size) → a dict of tensors on the
  generator's device: flip flags and ``rot_k``; SSR ``apply``, ``dx``,
  ``dy``, ``scale``, ``angle``; jitter ``apply``, factors and ``perm``; noise
  ``apply``, ``var`` and the standard-normal ``noise`` field; the resized
  crop's ``y0``, ``x0``, ``crop_h``, ``crop_w``;
- an *apply* function (images, draws) that is deterministic, so the tests
  feed it the JAX package's own draws.

Per-image choices (a flip, a rotation, the order of the jitter adjustments)
become per-image selects over the batch: no host round trip, no sync.
Nothing here reads torch's global RNG.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# the JAX module's _mirror_coord and _warp_taps live in ops/affine_warp.py
# (mirror_coord, warp_taps), beside the kernel whose plain version they are
from ..ops.affine_warp import (affine_coords, affine_warp_batch,
                               affine_warp_batch_reference, warp_taps)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)

Draws = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- basic ops

@functools.lru_cache(maxsize=32)
def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense [n_out, n_in] float32 matrix of the half-pixel-centre 2-tap
    bilinear weights (edge-clamped), so ``W @ x`` is the 1-D resize.  The
    cached array is read-only."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    # clamp the raw tap indices independently: for src < 0 both taps land on
    # pixel 0 with total weight 1 (cv2's edge-replicate rule)
    lo_raw = np.floor(src).astype(np.int64)
    lo = np.clip(lo_raw, 0, n_in - 1)
    hi = np.clip(lo_raw + 1, 0, n_in - 1)
    frac = src - lo_raw
    w = np.zeros((n_out, n_in), np.float64)
    w[np.arange(n_out), lo] += 1.0 - frac
    w[np.arange(n_out), hi] += frac
    out = np.asarray(w, np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=32)
def _resize_weights(n_in: int, n_out: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """:func:`_bilinear_matrix` on ``device``, uploaded once per shape (a
    host→device copy per batch would stall the serving stream)."""
    return torch.tensor(_bilinear_matrix(n_in, n_out), dtype=dtype,
                        device=device)


def resize_bilinear_mxu(imgs: torch.Tensor, out_hw: Tuple[int, int],
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched bilinear resize as two matmuls.

    imgs [B, H, W, C] (any real dtype, uint8 included) → [B, h, w, C] in
    ``dtype``.  float32 runs in full float32 (no TF32: cuBLAS's default);
    bfloat16 rounds like the JAX serving path's bf16 matmuls.
    """
    h_out, w_out = out_hw
    _, h_in, w_in, _ = imgs.shape
    wh = _resize_weights(h_in, h_out, dtype, imgs.device)
    ww = _resize_weights(w_in, w_out, dtype, imgs.device)
    x = imgs.to(dtype)
    t = torch.einsum("oh,bhwc->bowc", wh, x)       # contract H
    return torch.einsum("ow,bhwc->bhoc", ww, t)    # contract W


@functools.lru_cache(maxsize=32)
def _nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``jax.image.resize(method='nearest')`` source indices, computed in
    float32 as JAX computes them."""
    src = (np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out
    return torch.from_numpy(np.floor(src.astype(np.float32)).astype(np.int64)
                            ).to(device)


def resize_nearest(masks: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of a batch of masks [B, H, W] → [B, h, w]."""
    yi = _nearest_index(masks.shape[1], out_hw[0], masks.device)
    xi = _nearest_index(masks.shape[2], out_hw[1], masks.device)
    return masks.index_select(1, yi).index_select(2, xi)


def normalize_imagenet(img: torch.Tensor,
                       mean: Tuple[float, ...] = IMAGENET_MEAN,
                       std: Tuple[float, ...] = IMAGENET_STD) -> torch.Tensor:
    """albumentations.Normalize: (img - 255*mean) / (255*std), in img.dtype."""
    m = torch.tensor(mean, dtype=img.dtype, device=img.device) * 255.0
    s = torch.tensor(std, dtype=img.dtype, device=img.device) * 255.0
    return (img - m) / s


def preprocess_eval_batch(imgs_u8: torch.Tensor, out_hw: Tuple[int, int],
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 batch [B, H, W, 3] → resize → ImageNet normalize, in ``dtype``,
    contiguous NHWC (the reference's deterministic eval transform,
    ``main.py:88-94``)."""
    return normalize_imagenet(resize_bilinear_mxu(imgs_u8, out_hw, dtype)
                              ).contiguous()


def _per_image(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B] → [B, 1, ..., 1] broadcasting against ``like``."""
    return t.view(-1, *[1] * (like.dim() - 1))


def _uniform(gen: torch.Generator, n: int, bsz: int) -> torch.Tensor:
    return torch.rand(n, bsz, generator=gen, device=gen.device)


# ----------------------------------------------------------- geometric augs

def flips_rot90_draw(gen: torch.Generator, bsz: int, p: float = 0.5) -> Draws:
    """HorizontalFlip(p), VerticalFlip(p), RandomRotate90(p) draws."""
    u = _uniform(gen, 3, bsz)
    k = torch.randint(0, 4, (bsz,), generator=gen, device=gen.device)
    return {"hflip": u[0] < p, "vflip": u[1] < p,
            "rot_k": torch.where(u[2] < p, k, torch.zeros_like(k))}


def random_flips_rot90(imgs: torch.Tensor, masks: Optional[torch.Tensor],
                       draws: Draws):
    """Apply the flips and the rotation by ``rot_k`` quarter turns jointly to
    images [B, H, W, C] and masks [B, H, W] (the reference's shared
    transform), in the JAX order: h-flip, v-flip, rotate.  A rotation needs
    square images, as in JAX (``lax.switch`` branches share one shape).
    The outputs are contiguous (the selects over transposed views are
    not)."""
    def apply(x):
        sel = lambda flag, a, b: torch.where(_per_image(flag, x), a, b)
        x = sel(draws["hflip"], x.flip(2), x)
        x = sel(draws["vflip"], x.flip(1), x)
        k = draws["rot_k"]
        t = x.transpose(1, 2)
        out = sel(k == 1, t.flip(1), x)
        out = sel(k == 2, x.flip((1, 2)), out)
        return sel(k == 3, t.flip(2), out).contiguous()

    return apply(imgs), (None if masks is None else apply(masks))


def ssr_draw(gen: torch.Generator, bsz: int, shift_limit: float = 0.05,
             scale_limit: float = 0.1, rotate_limit: float = 15.0,
             p: float = 0.5) -> Draws:
    """ShiftScaleRotate's draws (``_ssr_draw``): apply flag, shifts as a
    fraction of the size, scale and angle in degrees."""
    u = _uniform(gen, 5, bsz)
    span = lambda v, lim: (2.0 * v - 1.0) * lim
    return {"apply": u[0] < p, "dx": span(u[1], shift_limit),
            "dy": span(u[2], shift_limit), "scale": 1.0 + span(u[3], scale_limit),
            "angle": span(u[4], rotate_limit)}


def ssr_inverse(h: int, w: int, dx, dy, scale, angle) -> torch.Tensor:
    """Inverse affines [B, 6] (dst pixel → src coordinate) of cv2-convention
    shift/scale/rotate about the image centre, in float32 as the JAX
    ``_ssr_inverse``: rows (i11, i12, i13, i21, i22, i23) with
    sx = i11·x + i12·y + i13, sy = i21·x + i22·y + i23."""
    theta = torch.deg2rad(angle.float())
    alpha = scale.float() * torch.cos(theta)
    beta = scale.float() * torch.sin(theta)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    a13 = (1 - alpha) * cx - beta * cy + dx.float() * w
    a23 = beta * cx + (1 - alpha) * cy + dy.float() * h
    det = alpha * alpha + beta * beta
    i11, i12 = alpha / det, -beta / det
    i21, i22 = beta / det, alpha / det
    i13 = -(i11 * a13 + i12 * a23)
    i23 = -(i21 * a13 + i22 * a23)
    return torch.stack([i11, i12, i13, i21, i22, i23], dim=1)


def shift_scale_rotate(imgs: torch.Tensor, masks: Optional[torch.Tensor],
                       draws: Draws):
    """Affine warp with cv2 conventions, REFLECT_101 borders, bilinear for
    the images and nearest for the masks (albumentations ShiftScaleRotate
    defaults), through the plain gather; images not drawn pass unchanged."""
    h, w = imgs.shape[1:3]
    inv = ssr_inverse(h, w, draws["dx"], draws["dy"], draws["scale"],
                      draws["angle"])
    imgs = affine_warp_batch_reference(imgs, inv, (h, w), draws["apply"])
    if masks is not None:
        src_y, src_x = affine_coords(inv, (h, w))
        mf = masks.float()
        warped = warp_taps(mf, src_y, src_x, 0)
        masks = torch.where(_per_image(draws["apply"], mf), warped, mf
                            ).to(masks.dtype)
    return imgs, masks


def scale_translate_weights(n_in: int, n_out: int, scale: torch.Tensor,
                            translation: torch.Tensor) -> torch.Tensor:
    """Per-image [B, n_out, n_in] float32 weights of
    ``jax.image.scale_and_translate`` along one axis, linear (triangle)
    kernel without antialiasing (``compute_weight_mat``): output pixel o
    samples ``s = (o + 0.5)/scale − translation/scale − 0.5``; the taps
    ``max(0, 1 − |s − i|)`` are renormalised to sum 1 (zero where the sum is
    below 1000 float32 eps), and rows whose ``s`` lies outside
    [−0.5, n_in − 0.5] are zero.  ``scale``/``translation`` [B] float32."""
    dev = scale.device
    inv = 1.0 / scale.float()
    out = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5
    sample = out[None, :] * inv[:, None] - (translation.float() * inv)[:, None] - 0.5
    taps = torch.arange(n_in, dtype=torch.float32, device=dev)
    w = (1.0 - (sample[:, None, :] - taps[None, :, None]).abs()).clamp_min(0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = torch.where(inside[:, None, :], w, torch.zeros_like(w))
    return w.transpose(1, 2)


def crop_and_resize(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                    crop_h: torch.Tensor, crop_w: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Each image's window (y0, x0, crop_h, crop_w) [B] resized to
    ``out_hw`` with ``jax.image.scale_and_translate``'s linear weights
    (``augment.py:119-129``): imgs [B, H, W, C] float32 → [B, oh, ow, C],
    the two axes as per-image [out, in] weight matrices."""
    oh, ow = out_hw
    sh = oh / crop_h.float()
    sw = ow / crop_w.float()
    wh = scale_translate_weights(imgs.shape[1], oh, sh, -y0.float() * sh)
    ww = scale_translate_weights(imgs.shape[2], ow, sw, -x0.float() * sw)
    t = torch.einsum("boh,bhwc->bowc", wh, imgs)
    return torch.einsum("bpw,bowc->bopc", ww, t)


def random_resized_crop_draw(gen: torch.Generator, bsz: int,
                             hw: Tuple[int, int],
                             scale: Tuple[float, float] = (0.5, 1.0),
                             ratio: Tuple[float, float] = (0.75, 4.0 / 3.0),
                             attempts: int = 10) -> Draws:
    """torchvision RandomResizedCrop's draws (the reference MAE train crop,
    ``train_ae.py:90``) for images of size ``hw``, as the JAX
    ``random_resized_crop`` makes them (:286-309): ``attempts`` (area,
    log-aspect) pairs, the first whose rounded size fits wins, else the
    centred square of side min(H, W); the offsets are integers uniform in
    range.  → float32 [B] ``y0``, ``x0``, ``crop_h``, ``crop_w``."""
    h, w = hw
    dev = gen.device
    u = torch.rand(2, bsz, attempts, generator=gen, device=dev)
    target = (scale[0] + (scale[1] - scale[0]) * u[0]) * float(h * w)
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    ar = torch.exp(lo + (hi - lo) * u[1])
    ws = torch.round(torch.sqrt(target * ar))
    hs = torch.round(torch.sqrt(target / ar))
    valid = (ws > 0) & (ws <= w) & (hs > 0) & (hs <= h)
    first = valid.int().argmax(dim=1, keepdim=True)  # the first valid attempt
    found = valid.any(dim=1)
    side = torch.full((bsz,), float(min(h, w)), device=dev)
    crop_w = torch.where(found, ws.gather(1, first)[:, 0], side)
    crop_h = torch.where(found, hs.gather(1, first)[:, 0], side)
    span_i, span_j = h - crop_h, w - crop_w
    v = torch.rand(2, bsz, generator=gen, device=dev)
    rnd_i = torch.minimum(torch.floor(v[0] * (span_i + 1)), span_i)
    rnd_j = torch.minimum(torch.floor(v[1] * (span_j + 1)), span_j)
    return {"y0": torch.where(found, rnd_i, torch.floor(span_i / 2)),
            "x0": torch.where(found, rnd_j, torch.floor(span_j / 2)),
            "crop_h": crop_h, "crop_w": crop_w}


def random_resized_crop(imgs: torch.Tensor, masks: Optional[torch.Tensor],
                        draws: Draws, out_hw: Tuple[int, int]):
    """Apply the resized crop: images through :func:`crop_and_resize`;
    each mask linear-resized the same way and thresholded at half its
    maximum (at least 1), the JAX rule (:318-325)."""
    args = (draws["y0"], draws["x0"], draws["crop_h"], draws["crop_w"], out_hw)
    out = crop_and_resize(imgs, *args)
    if masks is None:
        return out, None
    mf = masks.float()
    soft = crop_and_resize(mf[..., None], *args)[..., 0]
    top = _per_image(mf.amax(dim=(1, 2)).clamp_min(1.0), soft)
    return out, (soft > 0.5 * top).float() * top


# ------------------------------------------------------------- colour augs

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


def color_jitter_draw(gen: torch.Generator, bsz: int, brightness: float = 0.2,
                      contrast: float = 0.2, saturation: float = 0.2,
                      hue: float = 0.1, p: float = 0.5) -> Draws:
    """ColorJitter's draws: apply flag, the four factors, and ``perm``
    [B, 4], a uniform permutation of the adjustments (brightness 0,
    contrast 1, saturation 2, hue 3) per image."""
    u = _uniform(gen, 5, bsz)
    perm = torch.rand(bsz, 4, generator=gen, device=gen.device).argsort(dim=1)
    return {"apply": u[0] < p,
            "brightness": 1 - brightness + 2 * brightness * u[1],
            "contrast": 1 - contrast + 2 * contrast * u[2],
            "saturation": 1 - saturation + 2 * saturation * u[3],
            "hue": -hue + 2 * hue * u[4], "perm": perm}


def color_jitter(imgs: torch.Tensor, draws: Draws) -> torch.Tensor:
    """torchvision-order ColorJitter on [B, H, W, 3]: the four adjustments
    run in each image's own order ``perm``.  Step i computes the four
    adjustments of the batch and selects per image the one ``perm[:, i]``
    names, which is the JAX ``lax.switch`` order exactly."""
    lum = torch.tensor(LUMA, dtype=imgs.dtype, device=imgs.device)
    f = {k: _per_image(draws[k].to(imgs.dtype), imgs)
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
            new = torch.where(_per_image(which == j, out), cands[j], new)
        out = new
    out = out.clamp(0.0, 255.0)
    return torch.where(_per_image(draws["apply"], imgs), out, imgs)


def gauss_noise_draw(gen: torch.Generator, shape: Tuple[int, ...],
                     var_limit: Tuple[float, float] = (10.0, 50.0),
                     p: float = 0.3) -> Draws:
    """GaussNoise's draws for images of ``shape`` [B, H, W, C]: apply flag,
    variance, and the standard-normal field."""
    u = _uniform(gen, 2, shape[0])
    noise = torch.randn(shape, generator=gen, device=gen.device)
    return {"apply": u[0] < p,
            "var": var_limit[0] + (var_limit[1] - var_limit[0]) * u[1],
            "noise": noise}


def gauss_noise(imgs: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Additive gaussian noise on the 0..255 scale (albumentations
    GaussNoise)."""
    noise = draws["noise"] * _per_image(torch.sqrt(draws["var"]), imgs)
    noisy = (imgs + noise).clamp(0.0, 255.0)
    return torch.where(_per_image(draws["apply"], imgs), noisy, imgs)


# ------------------------------------------------------------- policies

def fusion_train_draws(gen: torch.Generator, bsz: int,
                       out_hw: Tuple[int, int] = (380, 380),
                       channels: int = 3) -> Dict[str, Draws]:
    """Every draw of one batch of the fusion train policy, from ``gen`` in
    the policy's order: flips, SSR, jitter, noise."""
    return {"flips": flips_rot90_draw(gen, bsz),
            "ssr": ssr_draw(gen, bsz),
            "jitter": color_jitter_draw(gen, bsz),
            "noise": gauss_noise_draw(gen, (bsz, *out_hw, channels))}


def _train_transform(images, masks, draws, out_hw, fast: bool):
    imgs = resize_bilinear_mxu(images, out_hw)
    if not fast:
        masks = resize_nearest(masks.float(), out_hw)
    imgs, warp_masks = random_flips_rot90(imgs, None if fast else masks,
                                          draws["flips"])
    if fast:
        ssr = draws["ssr"]
        inv = ssr_inverse(*out_hw, ssr["dx"], ssr["dy"], ssr["scale"],
                          ssr["angle"])
        imgs = affine_warp_batch(imgs, inv, out_hw, apply=ssr["apply"])
    else:
        imgs, masks = shift_scale_rotate(imgs, warp_masks, draws["ssr"])
    imgs = color_jitter(imgs, draws["jitter"])
    imgs = gauss_noise(imgs, draws["noise"])
    return normalize_imagenet(imgs), masks


def fusion_train_transform(images: torch.Tensor, masks: torch.Tensor,
                           draws: Dict[str, Draws],
                           out_hw: Tuple[int, int] = (380, 380)):
    """Reference fusion train policy (``main.py:76-87``) on a batch:
    Resize(380) → flips/rot90 → ShiftScaleRotate → ColorJitter →
    GaussNoise → Normalize, images and masks (float32) transformed together,
    the warp through the plain gather."""
    return _train_transform(images, masks, draws, out_hw, fast=False)


def fusion_train_fast_transform(images: torch.Tensor,
                                masks: Optional[torch.Tensor],
                                draws: Dict[str, Draws],
                                out_hw: Tuple[int, int] = (380, 380)):
    """The fast fusion train policy on a batch: the same augmentations and
    draws as :func:`fusion_train_transform`, the SSR warp through the warp
    kernel (one launch per batch), masks passed through untransformed (the
    fusion step never reads them)."""
    return _train_transform(images, masks, draws, out_hw, fast=True)


def fusion_train_batch(images: torch.Tensor, masks: torch.Tensor,
                       gen: torch.Generator,
                       out_hw: Tuple[int, int] = (380, 380)):
    """uint8 images [B, H, W, 3] and masks [B, H, W] → the faithful policy,
    its draws taken from ``gen``."""
    draws = fusion_train_draws(gen, images.shape[0], out_hw, images.shape[-1])
    return fusion_train_transform(images, masks, draws, out_hw)


def fusion_eval_batch(images: torch.Tensor, masks: torch.Tensor,
                      out_hw: Tuple[int, int] = (380, 380)):
    """Reference fusion eval policy (``main.py:89-94``)."""
    return (preprocess_eval_batch(images, out_hw),
            resize_nearest(masks.float(), out_hw))


def mae_eval_batch(images: torch.Tensor, masks: torch.Tensor,
                   out_hw: Tuple[int, int] = (224, 224)):
    """Reference MAE eval / latent-extraction policy (``train_ae.py:102-105``,
    ``save_latent.py:26-30``; JAX ``augment.py:457-460,479``): uint8
    images resized bilinearly and ImageNet-normalised in float32, masks
    resized nearest, both to 224²."""
    return fusion_eval_batch(images, masks, out_hw)


def mae_train_draws(gen: torch.Generator, bsz: int, hw: Tuple[int, int]
                    ) -> Dict[str, Draws]:
    """Every draw of one batch of the MAE train policy, from ``gen`` in the
    policy's order: the resized crop of ``hw`` images, then the flips."""
    return {"crop": random_resized_crop_draw(gen, bsz, hw),
            "flips": flips_rot90_draw(gen, bsz)}


def mae_train_transform(images: torch.Tensor, masks: Optional[torch.Tensor],
                        draws: Dict[str, Draws],
                        out_hw: Tuple[int, int] = (224, 224)):
    """Reference MAE train policy (``train_ae.py:88-100``; JAX
    ``augment.py:447-454``) on a batch: RandomResizedCrop (scale 0.5-1,
    ratio 0.75-1.33) → flips/rot90 → Normalize, images and masks (float32)
    transformed together."""
    imgs = images.float()
    imgs, masks = random_resized_crop(
        imgs, None if masks is None else masks.float(), draws["crop"], out_hw)
    imgs, masks = random_flips_rot90(imgs, masks, draws["flips"])
    return normalize_imagenet(imgs), masks


def mae_train_batch(images: torch.Tensor, masks: Optional[torch.Tensor],
                    gen: torch.Generator,
                    out_hw: Tuple[int, int] = (224, 224)):
    """uint8 images [B, H, W, 3] and masks [B, H, W] → the MAE train
    policy, its draws taken from ``gen``."""
    draws = mae_train_draws(gen, images.shape[0], tuple(images.shape[1:3]))
    return mae_train_transform(images, masks, draws, out_hw)


def make_fusion_train_fast(out_hw: Tuple[int, int] = (380, 380)
                           ) -> Callable:
    """(images, masks, gen) → the fast policy, its draws from ``gen``.

    On the card the warp is the hand-written kernel.  Its REFLECT_101 is
    computed in place, so unlike the JAX policy there is no pad budget and
    the fast policy equals the faithful one at every size.
    """
    def batched(images, masks, gen):
        draws = fusion_train_draws(gen, images.shape[0], out_hw,
                                   images.shape[-1])
        return fusion_train_fast_transform(images, masks, draws, out_hw)

    return batched


POLICIES = {
    "fusion_train": fusion_train_batch,
    "fusion_eval": fusion_eval_batch,
    "mae_train": mae_train_batch,
    "mae_eval": mae_eval_batch,
    "fusion_train_fast": make_fusion_train_fast(),
}
