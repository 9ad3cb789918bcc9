"""Plain float32 ConvMAE (Gao et al. 2022, arXiv:2205.03892): the
ConvViT encoder (two convolutional stages and a transformer stage over
16×16 patches), random masking at the patch grid with the visibility
upsampled into the conv stages, the decoder and the norm-pix loss.

Functional: the parameters are a dict keyed as the port's state dict (the
upstream checkpoint's names).  Activations are NHWC; every LayerNorm has
eps 1e-6; GELU is the exact one.  ``lowp`` rounds both operands of every
product and convolution: the lower precision control.  Imports nothing of
the port.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
PATCH = 16
Params = Dict[str, torch.Tensor]


def masking(gen: torch.Generator, b: int, n: int, ratio: float):
    """MAE's noise-argsort masking → (ids_keep, mask [B, N] 1 = masked,
    ids_restore); the noise is one uniform draw [B, N] from ``gen``."""
    keep = int(round(n * (1.0 - ratio)))
    noise = torch.rand((b, n), generator=gen, device=gen.device)
    shuffle = torch.argsort(noise, dim=1, stable=True)
    restore = torch.argsort(shuffle, dim=1, stable=True)
    mask = torch.ones(b, n, device=gen.device)
    mask[:, :keep] = 0.0
    return shuffle[:, :keep], torch.gather(mask, 1, restore), restore


def sincos_table(dim: int, grid: int, device) -> torch.Tensor:
    """The fixed 2-D sin-cos positional table [grid², dim]: the first half
    of the channels encodes the row, the second the column."""
    pos = torch.arange(grid, dtype=torch.float32, device=device)
    omega = 1.0 / 10000.0 ** (torch.arange(dim // 4, dtype=torch.float32,
                                           device=device) / (dim / 4.0))
    ang = pos[:, None] * omega[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    rows = emb[:, None, :].expand(grid, grid, dim // 2)
    cols = emb[None, :, :].expand(grid, grid, dim // 2)
    return torch.cat([rows, cols], dim=-1).reshape(grid * grid, dim)


class Net:
    def __init__(self, cfg: Dict, params: Params,
                 lowp: Optional[Callable] = None):
        self.cfg, self.p = cfg, params
        self.q = lowp or (lambda t: t)

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], LN_EPS)

    def dense(self, x, name):
        """A Linear or a 1×1 conv over the last dim."""
        w = self.p[f"{name}.weight"]
        return F.linear(self.q(x), self.q(w.reshape(w.shape[0], -1)),
                        self.p[f"{name}.bias"])

    def patch_embed(self, x, name, k):
        y = F.conv2d(self.q(x.permute(0, 3, 1, 2)),
                     self.q(self.p[f"{name}.proj.weight"]),
                     self.p[f"{name}.proj.bias"], stride=k)
        return self.ln(y.permute(0, 2, 3, 1), f"{name}.norm")

    def conv_block(self, x, name, keep):
        h = self.dense(self.ln(x, f"{name}.norm1"), f"{name}.conv1")
        if keep is not None:
            h = h * keep
        h = F.conv2d(self.q(h.permute(0, 3, 1, 2)),
                     self.q(self.p[f"{name}.attn.weight"]),
                     self.p[f"{name}.attn.bias"], padding=2,
                     groups=h.shape[-1]).permute(0, 2, 3, 1)
        x = x + self.dense(F.gelu(h), f"{name}.conv2")
        h = F.gelu(self.dense(self.ln(x, f"{name}.norm2"), f"{name}.mlp.fc1"))
        return x + self.dense(h, f"{name}.mlp.fc2")

    def vit_block(self, x, name, heads):
        b, n, d = x.shape
        hd = d // heads
        qkv = self.dense(self.ln(x, f"{name}.norm1"), f"{name}.attn.qkv")
        q, k, v = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(self.q(q) @ self.q(k).transpose(-1, -2)
                            / math.sqrt(hd), dim=-1)
        out = (self.q(att) @ self.q(v)).transpose(1, 2).reshape(b, n, d)
        x = x + self.dense(out, f"{name}.attn.proj")
        h = F.gelu(self.dense(self.ln(x, f"{name}.norm2"), f"{name}.mlp.fc1"))
        return x + self.dense(h, f"{name}.mlp.fc2")

    def encode(self, imgs: torch.Tensor, masks: Optional[Tuple] = None):
        """imgs [B, S, S, 3] float32 → latent [B, kept, D]; ``masks`` is
        (ids_keep, mask, ids_restore) or None for every token."""
        cfg = self.cfg
        b = imgs.shape[0]
        g = cfg["img_size"] // PATCH
        keep1 = keep2 = None
        if masks is not None:
            vis = (1.0 - masks[1]).reshape(b, g, g, 1)
            keep1 = vis.repeat_interleave(4, 1).repeat_interleave(4, 2)
            keep2 = vis.repeat_interleave(2, 1).repeat_interleave(2, 2)
        x = self.patch_embed(imgs, "patch_embed1", 4)
        for i in range(cfg["depths"][0]):
            x = self.conv_block(x, f"blocks1.{i}", keep1)
        x = self.patch_embed(x, "patch_embed2", 2)
        for i in range(cfg["depths"][1]):
            x = self.conv_block(x, f"blocks2.{i}", keep2)
        x = self.patch_embed(x, "patch_embed3", 2)
        x = x.reshape(b, g * g, -1) + self.p["pos_embed"]
        if masks is not None:
            ids = masks[0]
            x = torch.gather(x, 1, ids[:, :, None].expand(-1, -1, x.shape[-1]))
        for i in range(cfg["depths"][2]):
            x = self.vit_block(x, f"blocks3.{i}", cfg["num_heads"])
        return self.ln(x, "norm")

    def decode(self, latent, restore):
        b, kept, _ = latent.shape
        n = restore.shape[1]
        x = self.dense(latent, "decoder_embed")
        x = torch.cat([x, self.p["mask_token"].expand(b, n - kept, -1)], dim=1)
        x = torch.gather(x, 1, restore[:, :, None].expand(-1, -1, x.shape[-1]))
        x = x + sincos_table(x.shape[-1], int(round(n ** 0.5)), x.device)
        for i in range(self.cfg["decoder_depth"]):
            x = self.vit_block(x, f"decoder_blocks.{i}",
                               self.cfg["decoder_heads"])
        return self.dense(self.ln(x, "decoder_norm"), "decoder_pred")

    def loss(self, imgs: torch.Tensor, masks: Tuple) -> torch.Tensor:
        """Masked norm-pix reconstruction loss of one batch."""
        pred = self.decode(self.encode(imgs, masks), masks[2])
        b, s = imgs.shape[0], imgs.shape[1]
        g = s // PATCH
        t = imgs.reshape(b, g, PATCH, g, PATCH, 3).permute(0, 1, 3, 2, 4, 5)
        t = t.reshape(b, g * g, PATCH * PATCH * 3)
        if self.cfg["norm_pix_loss"]:
            t = (t - t.mean(dim=-1, keepdim=True)) / torch.sqrt(
                t.var(dim=-1, keepdim=True, correction=0) + 1e-6)
        per = ((pred - t) ** 2).mean(dim=-1)
        return (per * masks[1]).sum() / masks[1].sum()
