"""Plain float32 preprocessing and train-time augmentation, the semantics
the port's ``data/augment.py`` implements, written again without it.

- eval: bilinear resize with half-pixel centres and edge clamp
  (cv2.INTER_LINEAR, no antialias), one tap matrix an axis → ImageNet
  normalisation;
- the fusion train policy (Resize → flips/rot90 → ShiftScaleRotate with
  REFLECT_101 borders → ColorJitter in a per-image order → GaussNoise →
  Normalize), its draws made from the generator in the policy's order;
- the MAE train policy (RandomResizedCrop with ``scale_and_translate``'s
  linear weights → flips/rot90 → Normalize).

The draw functions make the same calls on the generator as the policies
do, so one seed gives both sides the same draws.  Imports nothing of the
port.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)


def _taps(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] float32 weights of the 1-D resize: output o samples
    s = (o + 0.5)·n_in/n_out − 0.5 between its two neighbours, each tap
    index clamped to the edge (computed in float64)."""
    s = (torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5
    lo = torch.floor(s)
    frac = s - lo
    w = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    w.index_put_((rows, lo.long().clamp(0, n_in - 1)), 1.0 - frac,
                 accumulate=True)
    w.index_put_((rows, (lo.long() + 1).clamp(0, n_in - 1)), frac,
                 accumulate=True)
    return w.float().to(device)


def resize(imgs: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] any dtype → [B, h, w, C] float32: the separable
    resize as a product with each axis's tap matrix."""
    _, h, w, _ = imgs.shape
    x = imgs.float()
    x = torch.einsum("oh,bhwc->bowc", _taps(h, out_hw[0], x.device), x)
    return torch.einsum("pw,bowc->bopc", _taps(w, out_hw[1], x.device), x)


def normalize(x: torch.Tensor) -> torch.Tensor:
    m = torch.tensor(MEAN, device=x.device) * 255.0
    s = torch.tensor(STD, device=x.device) * 255.0
    return (x - m) / s


def eval_batch(imgs_u8: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    return normalize(resize(imgs_u8, out_hw))


def _col(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.view(-1, *[1] * (like.dim() - 1))


# ----------------------------------------------------------------- draws

def flips_draw(gen, b):
    u = torch.rand(3, b, generator=gen, device=gen.device)
    k = torch.randint(0, 4, (b,), generator=gen, device=gen.device)
    return {"hflip": u[0] < 0.5, "vflip": u[1] < 0.5,
            "rot_k": torch.where(u[2] < 0.5, k, torch.zeros_like(k))}


def fusion_draws(gen, b: int, out_hw, channels: int = 3) -> Dict:
    flips = flips_draw(gen, b)
    u = torch.rand(5, b, generator=gen, device=gen.device)
    span = lambda v, lim: (2.0 * v - 1.0) * lim
    ssr = {"apply": u[0] < 0.5, "dx": span(u[1], 0.05), "dy": span(u[2], 0.05),
           "scale": 1.0 + span(u[3], 0.1), "angle": span(u[4], 15.0)}
    u = torch.rand(5, b, generator=gen, device=gen.device)
    perm = torch.rand(b, 4, generator=gen, device=gen.device).argsort(dim=1)
    jitter = {"apply": u[0] < 0.5, "brightness": 0.8 + 0.4 * u[1],
              "contrast": 0.8 + 0.4 * u[2], "saturation": 0.8 + 0.4 * u[3],
              "hue": -0.1 + 0.2 * u[4], "perm": perm}
    u = torch.rand(2, b, generator=gen, device=gen.device)
    noise = torch.randn((b, *out_hw, channels), generator=gen,
                        device=gen.device)
    return {"flips": flips, "ssr": ssr, "jitter": jitter,
            "noise": {"apply": u[0] < 0.3, "var": 10.0 + 40.0 * u[1],
                      "noise": noise}}


def mae_draws(gen, b: int, hw) -> Dict:
    """RandomResizedCrop (scale 0.5-1, ratio 3/4-4/3, 10 attempts, the
    centred square as fall-back), then the flips."""
    h, w = hw
    dev = gen.device
    u = torch.rand(2, b, 10, generator=gen, device=dev)
    target = (0.5 + 0.5 * u[0]) * float(h * w)
    lo, hi = math.log(0.75), math.log(4.0 / 3.0)
    ar = torch.exp(lo + (hi - lo) * u[1])
    ws = torch.round(torch.sqrt(target * ar))
    hs = torch.round(torch.sqrt(target / ar))
    ok = (ws > 0) & (ws <= w) & (hs > 0) & (hs <= h)
    first = ok.int().argmax(dim=1, keepdim=True)
    found = ok.any(dim=1)
    side = torch.full((b,), float(min(h, w)), device=dev)
    cw = torch.where(found, ws.gather(1, first)[:, 0], side)
    ch = torch.where(found, hs.gather(1, first)[:, 0], side)
    si, sj = h - ch, w - cw
    v = torch.rand(2, b, generator=gen, device=dev)
    y0 = torch.where(found, torch.minimum(torch.floor(v[0] * (si + 1)), si),
                     torch.floor(si / 2))
    x0 = torch.where(found, torch.minimum(torch.floor(v[1] * (sj + 1)), sj),
                     torch.floor(sj / 2))
    return {"crop": {"y0": y0, "x0": x0, "h": ch, "w": cw},
            "flips": flips_draw(gen, b)}


# ------------------------------------------------------------- transforms

def flips(x: torch.Tensor, d: Dict) -> torch.Tensor:
    """h-flip, v-flip, then ``rot_k`` counter-clockwise quarter turns."""
    sel = lambda flag, a, b: torch.where(_col(flag, x), a, b)
    x = sel(d["hflip"], x.flip(2), x)
    x = sel(d["vflip"], x.flip(1), x)
    out = x
    for k in (1, 2, 3):
        out = sel(d["rot_k"] == k, torch.rot90(x, k, dims=(1, 2)), out)
    return out


def ssr_inverse(h, w, d) -> torch.Tensor:
    """[B, 6] destination pixel → source coordinate of cv2's
    shift/scale/rotate about the centre."""
    th = torch.deg2rad(d["angle"])
    a = d["scale"] * torch.cos(th)
    b = d["scale"] * torch.sin(th)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    a13 = (1 - a) * cx - b * cy + d["dx"] * w
    a23 = b * cx + (1 - a) * cy + d["dy"] * h
    det = a * a + b * b
    i11, i12, i21, i22 = a / det, -b / det, b / det, a / det
    return torch.stack([i11, i12, -(i11 * a13 + i12 * a23),
                        i21, i22, -(i21 * a13 + i22 * a23)], dim=1)


def _reflect101(c: torch.Tensor, n: int) -> torch.Tensor:
    period = 2.0 * (n - 1)
    m = torch.fmod(c.abs(), period)
    return torch.minimum(m, period - m)


def warp(x: torch.Tensor, d: Dict) -> torch.Tensor:
    """Bilinear affine warp, REFLECT_101 borders, of the drawn images."""
    b, h, w, c = x.shape
    inv = ssr_inverse(h, w, d)[:, :, None, None]
    ys = torch.arange(h, device=x.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=x.device, dtype=torch.float32)[None, :]
    sx = _reflect101(inv[:, 0] * xs + inv[:, 1] * ys + inv[:, 2], w)
    sy = _reflect101(inv[:, 3] * xs + inv[:, 4] * ys + inv[:, 5], h)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    flat = x.reshape(b, h * w, c)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return flat.gather(1, idx).reshape(b, h, w, c)

    out = (tap(y0, x0) * (1 - fy) * (1 - fx) + tap(y0, x1) * (1 - fy) * fx
           + tap(y1, x0) * fy * (1 - fx) + tap(y1, x1) * fy * fx)
    return torch.where(_col(d["apply"], x), out, x)


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12),
                    torch.zeros_like(maxc))
    safe = delta.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    hue = torch.where(r == maxc, bc - gc,
                      torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    hue = torch.where(delta > 0, torch.remainder(hue / 6.0, 1.0),
                      torch.zeros_like(hue))
    return torch.stack([hue, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)

    def pick(opts):
        out = opts[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, opts[k], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-1)


def color_jitter(x: torch.Tensor, d: Dict) -> torch.Tensor:
    """Brightness, contrast, saturation and hue, each image in its own
    order ``perm``; then clamp to 0..255."""
    lum = torch.tensor(LUMA, device=x.device)
    fb, fc, fs = (_col(d[k], x) for k in ("brightness", "contrast",
                                          "saturation"))
    fh = d["hue"].view(-1, 1, 1)

    def contrast(y):
        m = (y.clamp(0, 255) @ lum).mean(dim=(1, 2)).view(-1, 1, 1, 1)
        return m + fc * (y - m)

    def saturation(y):
        gray = (y.clamp(0, 255) @ lum)[..., None]
        return gray + fs * (y - gray)

    def hue(y):
        hsv = _rgb_to_hsv(y.clamp(0, 255) / 255.0)
        hsv = torch.stack([torch.remainder(hsv[..., 0] + fh, 1.0),
                           hsv[..., 1], hsv[..., 2]], dim=-1)
        return _hsv_to_rgb(hsv) * 255.0

    ops = (lambda y: y * fb, contrast, saturation, hue)
    out = x
    for step in range(4):
        which = d["perm"][:, step]
        cands = [op(out) for op in ops]
        new = cands[3]
        for j in (2, 1, 0):
            new = torch.where(_col(which == j, out), cands[j], new)
        out = new
    return torch.where(_col(d["apply"], x), out.clamp(0.0, 255.0), x)


def gauss_noise(x: torch.Tensor, d: Dict) -> torch.Tensor:
    noisy = (x + d["noise"] * _col(torch.sqrt(d["var"]), x)).clamp(0.0, 255.0)
    return torch.where(_col(d["apply"], x), noisy, x)


def fusion_train(imgs_u8: torch.Tensor, gen, out_hw) -> torch.Tensor:
    """The fusion train policy on a uint8 batch, draws from ``gen``."""
    d = fusion_draws(gen, imgs_u8.shape[0], out_hw, imgs_u8.shape[-1])
    x = flips(resize(imgs_u8, out_hw), d["flips"])
    x = warp(x, d["ssr"])
    x = gauss_noise(color_jitter(x, d["jitter"]), d["noise"])
    return normalize(x)


def _linear_weights(n_in, n_out, scale, shift):
    """[B, n_out, n_in] linear-kernel resampling weights of
    ``scale_and_translate`` (no antialias): output o samples
    s = (o + 0.5 − shift)/scale − 0.5; taps max(0, 1 − |s − i|)
    renormalised to sum 1; rows with s outside [−0.5, n_in − 0.5] zero."""
    dev = scale.device
    o = torch.arange(n_out, device=dev, dtype=torch.float32) + 0.5
    s = o[None, :] / scale[:, None] - (shift / scale)[:, None] - 0.5
    i = torch.arange(n_in, device=dev, dtype=torch.float32)
    wts = (1.0 - (s[:, :, None] - i[None, None, :]).abs()).clamp_min(0.0)
    tot = wts.sum(dim=2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(tot.abs() > eps,
                      wts / torch.where(tot != 0, tot, torch.ones_like(tot)),
                      torch.zeros_like(wts))
    inside = (s >= -0.5) & (s <= n_in - 0.5)
    return torch.where(inside[:, :, None], wts, torch.zeros_like(wts))


def mae_train(imgs_u8: torch.Tensor, gen, out_hw) -> torch.Tensor:
    """The MAE train policy on a uint8 batch, draws from ``gen``."""
    b, h, w, _ = imgs_u8.shape
    d = mae_draws(gen, b, (h, w))
    c = d["crop"]
    oh, ow = out_hw
    sh, sw = oh / c["h"], ow / c["w"]
    wh = _linear_weights(h, oh, sh, -c["y0"] * sh)
    ww = _linear_weights(w, ow, sw, -c["x0"] * sw)
    x = torch.einsum("boh,bhwc->bowc", wh, imgs_u8.float())
    x = torch.einsum("bpw,bowc->bopc", ww, x)
    return normalize(flips(x, d["flips"]))
