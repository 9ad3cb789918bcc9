"""ConvMAE: the hybrid convolutional / ViT masked autoencoder.

Counterpart of ``multimodal_isic_tpu/models/convmae.py``: a 3-stage
conv → conv → transformer encoder over 224² crops (56² → 28² → 14² grids,
dims 256 → 384 → 768), random masking at the 196-token granularity with the
visibility mask upsampled into the conv stages, an encoder-only mode
(``with_decoder=False``), the decoder (512 × 8 blocks, 16 heads) and the
norm-pix reconstruction loss.  Activations are NHWC, as in the JAX package.

Parameters carry the upstream ConvMAE checkpoint naming
(``patch_embed{1,2,3}.proj/norm``, ``blocks{1,2}.i.{norm1,conv1,attn,conv2,
norm2,mlp.fc1,mlp.fc2}``, ``blocks3.i.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2}``, ``norm``, ``pos_embed`` [1, N, D], ``decoder_*``,
``mask_token``), with 1×1 convs as ``[out, in, 1, 1]`` conv weights, so an
upstream ``checkpoint.pth`` state dict loads directly
(:func:`load_pretrained`).  Parameters stay float32; ``dtype`` is the
compute dtype.

The plain path follows flax's bf16 semantics step by step, because that is
where the rounding happens: a Dense or Conv multiplies in the compute dtype
and adds its bias after the product is rounded; LayerNorm (eps 1e-6) takes
float32 fast-variance statistics and rounds its output; attention scales q
in the compute dtype, takes the softmax in float32 and rounds it; the
encoder's and the decoder's outputs come out in float32, and the loss is
computed on the float32 input images.

Three flags route blocks to the hand-written kernels, as in the JAX model:
``use_fused_mlp`` (ConvBlock's second half → ``ops.fused_mlp``, only where
C and 4C are multiples of 128, decided from the dims), ``use_fused_front``
(ConvBlock's first half → ``ops.fused_convblock``) and
``use_flash_attention`` (every encoder and decoder attention →
``ops.attention``).  ``remat_blocks`` (JAX :274,291-292) recomputes every
conv, ViT and decoder block in the backward pass
(``torch.utils.checkpoint``) instead of keeping its activations; no block
draws randomness, so the recomputation gives the same values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.rng import batch_rand
from ..ops.attention import flash_attention
from ..ops.depthwise import conv2d_nhwc
from ..ops.fused_convblock import fused_front
from ..ops.fused_mlp import fused_ln_mlp, ln_rows
from ..ops.patches import patch_overlap_mask, patchify
from ..utils import trace

LN_EPS = 1e-6  # flax's default (torch's is 1e-5)
PATCH = 16
Masking = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def sincos_pos_embed(dim: int, grid: int,
                     device: torch.device = torch.device("cpu")
                     ) -> torch.Tensor:
    """Fixed 2-D sin-cos positional embedding, [grid*grid, dim] float32,
    computed in float32 in the JAX order."""
    assert dim % 4 == 0
    coords = torch.arange(grid, dtype=torch.float32, device=device)
    omega = (torch.arange(dim // 4, dtype=torch.float32, device=device)
             / (dim / 4.0))
    omega = 1.0 / (10000.0 ** omega)
    out = coords[:, None] * omega[None, :]
    emb_1d = torch.cat([torch.sin(out), torch.cos(out)], dim=1)  # [g, dim/2]
    emb_h = emb_1d[:, None, :].expand(grid, grid, dim // 2)
    emb_w = emb_1d[None, :, :].expand(grid, grid, dim // 2)
    return torch.cat([emb_h, emb_w], dim=-1).reshape(grid * grid, dim)


def _round_scalar(v: float, dtype: torch.dtype) -> float:
    """A Python float as JAX's weakly typed scalar meets a ``dtype`` array:
    rounded to that dtype."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: float32 fast-variance statistics
    (``E[x²] − mean²`` clipped at 0), eps 1e-6, output in the compute
    dtype.  ``weight``/``bias`` are torch's names for flax's
    ``scale``/``bias``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_rows(x.float(), self.weight, self.bias,
                       LN_EPS).to(self.dtype)


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: product in ``dtype``, bias added after
    the rounding."""
    y = torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
    return y + lin.bias.to(dtype)


def conv1x1(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype
            ) -> torch.Tensor:
    """flax 1×1 ``nn.Conv(dtype=...)`` of an NHWC tensor."""
    w = conv.weight.reshape(conv.weight.shape[0], -1)
    return torch.matmul(x.to(dtype), w.to(dtype).t()) + conv.bias.to(dtype)


def _w1x1(conv: nn.Conv2d) -> torch.Tensor:
    """A 1×1 conv weight [out, in, 1, 1] as the JAX kernel's [in, out]."""
    return conv.weight.reshape(conv.weight.shape[0], -1).t()


class PatchEmbed(nn.Module):
    """Non-overlapping ``k×k`` stride-``k`` conv (flax ``nn.Conv``, SAME
    padding, which is none here) → LayerNorm."""

    def __init__(self, k: int, cin: int, dim: int, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, k, stride=k)
        self.norm = LayerNorm(dim, dtype)
        self.k = k
        self.dtype = dtype

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, Cin] → [B, H/k, W/k, dim] in the compute dtype: the
        stride-k conv as one product over (k, k, Cin) patches."""
        b, h, w, c = x.shape
        k = self.k
        p = x.reshape(b, h // k, k, w // k, k, c).permute(0, 1, 3, 2, 4, 5)
        p = p.reshape(b, h // k, w // k, k * k * c).to(self.dtype)
        wt = self.proj.weight.permute(0, 2, 3, 1).reshape(-1, k * k * c)
        return torch.matmul(p, wt.to(self.dtype).t()) + \
            self.proj.bias.to(self.dtype)


class CMlp(nn.Module):
    """The conv-stage MLP: 1×1 C → 4C → GELU → 1×1 4C → C."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, dim, 1)


class ConvBlock(nn.Module):
    """LN → 1×1 → ``keep`` → depthwise 5×5 SAME → GELU → 1×1 → residual,
    then LN → 1×1 C → 4C → GELU → 1×1 → residual.  ``keep`` ([B, H, W, 1],
    1 = visible) zeroes masked positions at the depthwise input."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32,
                 use_fused_mlp: bool = False, use_fused_front: bool = False):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, dtype)
        self.conv1 = nn.Conv2d(dim, dim, 1)
        self.attn = nn.Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.conv2 = nn.Conv2d(dim, dim, 1)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = CMlp(dim, hidden)
        self.dtype = dtype
        self.use_fused_front = use_fused_front
        # the kernel's lane alignment, decided from the dims (config.py:92-94)
        self.use_fused_mlp = (use_fused_mlp and dim % 128 == 0
                              and hidden % 128 == 0)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        if self.use_fused_front:
            x = fused_front(
                x.to(dt), self.norm1.weight.to(dt), self.norm1.bias.to(dt),
                _w1x1(self.conv1).to(dt), self.conv1.bias.to(dt),
                self.attn.weight[:, 0].permute(1, 2, 0).to(dt),
                self.attn.bias.to(dt), _w1x1(self.conv2).to(dt),
                self.conv2.bias.to(dt), keep)
        else:
            h = conv1x1(self.norm1(x), self.conv1, dt)
            if keep is not None:
                h = h * keep.to(h.dtype)
            h = conv2d_nhwc(h, self.attn.weight.to(dt), None,
                            groups=h.shape[-1]) + self.attn.bias.to(dt)
            h = F.gelu(h, approximate="none")
            x = x + conv1x1(h, self.conv2, dt)
        if self.use_fused_mlp:
            b, hh, ww, c = x.shape
            out = fused_ln_mlp(
                x.reshape(-1, c).to(dt), self.norm2.weight, self.norm2.bias,
                _w1x1(self.mlp.fc1).to(dt), self.mlp.fc1.bias.to(dt),
                _w1x1(self.mlp.fc2).to(dt), self.mlp.fc2.bias.to(dt))
            return out.reshape(b, hh, ww, c)
        h = conv1x1(self.norm2(x), self.mlp.fc1, dt)
        h = F.gelu(h, approximate="none")
        return x + conv1x1(h, self.mlp.fc2, dt)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.num_heads = num_heads


class Block(nn.Module):
    """Pre-LN transformer block (ViT stage, decoder)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.dtype = dtype
        self.use_flash = use_flash

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b, n, d = x.shape
        heads = self.attn.num_heads
        hd = d // heads
        qkv = dense(x, self.attn.qkv, dt).reshape(b, n, 3, heads, hd)
        q, k, v = qkv.unbind(2)  # [b, n, h, hd] views
        if self.use_flash:
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))
            out = out.transpose(1, 2).reshape(b, n, d)
        else:
            q = q * _round_scalar(1.0 / math.sqrt(hd), dt)
            attn = torch.einsum("bqhd,bkhd->bhqk", q, k)
            attn = torch.softmax(attn.float(), dim=-1).to(dt)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, d)
        return dense(out, self.attn.proj, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x + self.attention(self.norm1(x))
        h = dense(self.norm2(x), self.mlp.fc1, dt)
        h = F.gelu(h, approximate="none")
        return x + dense(h, self.mlp.fc2, dt)


def random_masking(generator: torch.Generator, batch: int, num_patches: int,
                   mask_ratio: float,
                   lesion_overlap: Optional[torch.Tensor] = None,
                   lesion_bias: float = 1.0) -> Masking:
    """MAE noise-argsort masking with optional lesion guidance →
    (ids_keep [B, len_keep], mask [B, N] float32 1 = masked,
    ids_restore [B, N]).  Noise is uniform from ``generator`` (on its
    device; a ``ShardedGenerator`` draws the global batch's noise and keeps
    the rank's rows); the sorts are stable, as ``jnp.argsort``.  Lesion patches
    (``lesion_overlap`` [B, N] bool) get a noise bias, so they are masked
    first."""
    dev = generator.device
    len_keep = int(round(num_patches * (1.0 - mask_ratio)))
    if len_keep == num_patches:  # no masking: identity order, not a shuffle
        ids = torch.arange(num_patches, device=dev).expand(batch, -1)
        return ids, torch.zeros(batch, num_patches, device=dev), ids
    noise = batch_rand(generator, (batch, num_patches), dev)
    if lesion_overlap is not None:
        noise = noise + lesion_bias * lesion_overlap.to(noise.dtype)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask = torch.ones(batch, num_patches, device=dev)
    mask[:, :len_keep] = 0.0
    return (ids_shuffle[:, :len_keep], torch.gather(mask, 1, ids_restore),
            ids_restore)


class ConvMAE(nn.Module):
    """ConvViT-Base masked autoencoder (dims 256/384/768, depths 2/2/11,
    12 heads, decoder 512 × 8 with 16 heads): the configuration of the
    reference's ``convmae_convvit_base_patch16_dec512d8b``."""

    def __init__(self, img_size: int = 224,
                 embed_dims: Sequence[int] = (256, 384, 768),
                 depths: Sequence[int] = (2, 2, 11), num_heads: int = 12,
                 decoder_dim: int = 512, decoder_depth: int = 8,
                 decoder_heads: int = 16, norm_pix_loss: bool = False,
                 with_decoder: bool = True,
                 use_flash_attention: bool = False,
                 use_fused_mlp: bool = False, use_fused_front: bool = False,
                 dtype: torch.dtype = torch.float32,
                 remat_blocks: bool = False):
        super().__init__()
        d0, d1, d2 = embed_dims
        self.remat_blocks = remat_blocks
        self.img_size = img_size
        self.embed_dims = tuple(embed_dims)
        self.depths = tuple(depths)
        self.decoder_dim = decoder_dim
        self.decoder_depth = decoder_depth
        self.norm_pix_loss = norm_pix_loss
        self.with_decoder = with_decoder
        self.dtype = dtype
        dt = dtype
        cb = dict(dtype=dt, use_fused_mlp=use_fused_mlp,
                  use_fused_front=use_fused_front)
        self.patch_embed1 = PatchEmbed(4, 3, d0, dt)
        self.blocks1 = nn.ModuleList(ConvBlock(d0, **cb)
                                     for _ in range(depths[0]))
        self.patch_embed2 = PatchEmbed(2, d0, d1, dt)
        self.blocks2 = nn.ModuleList(ConvBlock(d1, **cb)
                                     for _ in range(depths[1]))
        self.patch_embed3 = PatchEmbed(2, d1, d2, dt)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches, d2))
        self.blocks3 = nn.ModuleList(
            Block(d2, num_heads, dtype=dt, use_flash=use_flash_attention)
            for _ in range(depths[2]))
        self.norm = LayerNorm(d2, dt)
        if with_decoder:
            self.decoder_embed = nn.Linear(d2, decoder_dim)
            self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_dim))
            self.decoder_blocks = nn.ModuleList(
                Block(decoder_dim, decoder_heads, dtype=dt,
                      use_flash=use_flash_attention)
                for _ in range(decoder_depth))
            self.decoder_norm = LayerNorm(decoder_dim, dt)
            self.decoder_pred = nn.Linear(decoder_dim, PATCH * PATCH * 3)

    @property
    def grid(self) -> int:
        return self.img_size // PATCH

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    def _block(self, blk: nn.Module, *args) -> torch.Tensor:
        """``blk(*args)``, recomputed in the backward pass under
        ``remat_blocks`` when gradients are recorded."""
        if self.remat_blocks and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    # ------------------------------------------------------------- encoder
    def masking(self, batch: int, mask_ratio: float,
                generator: Optional[torch.Generator] = None,
                lesion_mask: Optional[torch.Tensor] = None,
                device: Optional[torch.device] = None) -> Masking:
        """The (ids_keep, mask, ids_restore) draws of one forward."""
        n = self.num_patches
        if mask_ratio <= 0.0:
            ids = torch.arange(n, device=device).expand(batch, -1)
            return ids, torch.zeros(batch, n, device=device), ids
        if generator is None:
            raise ValueError("mask_ratio > 0 needs a generator or the draws")
        overlap = (patch_overlap_mask(lesion_mask, PATCH)
                   if lesion_mask is not None else None)
        return random_masking(generator, batch, n, mask_ratio, overlap)

    @trace.spanned("convmae.encode")
    def encode(self, imgs: torch.Tensor, mask_ratio: float = 0.0,
               generator: Optional[torch.Generator] = None,
               lesion_mask: Optional[torch.Tensor] = None,
               masking: Optional[Masking] = None):
        """imgs [B, H, W, 3] float32 → (latent [B, len_keep, D] float32,
        mask [B, N], ids_restore [B, N]).  ``masking`` gives the draws
        (ids_keep, mask, ids_restore) instead of drawing them."""
        b = imgs.shape[0]
        g = self.grid
        if masking is None:
            masking = self.masking(b, mask_ratio, generator, lesion_mask,
                                   imgs.device)
        ids_keep, mask, ids_restore = masking
        if ids_keep.shape[1] < self.num_patches:
            keep3 = (1.0 - mask).reshape(b, g, g, 1)  # stage-3 visibility
            keep1 = keep3.repeat_interleave(4, 1).repeat_interleave(4, 2)
            keep2 = keep3.repeat_interleave(2, 1).repeat_interleave(2, 2)
        else:
            keep1 = keep2 = None

        pe = self.patch_embed1
        x = pe.norm(pe.project(imgs))                        # 56×56×256
        for blk in self.blocks1:
            x = self._block(blk, x, keep1)
        x = self.patch_embed2.norm(self.patch_embed2.project(x))  # 28²×384
        for blk in self.blocks2:
            x = self._block(blk, x, keep2)
        x = self.patch_embed3.project(x)                     # 14×14×768
        x = x.reshape(b, self.num_patches, self.embed_dims[2])
        x = self.patch_embed3.norm(x)
        x = x + self.pos_embed.to(x.dtype)
        with trace.span("convmae.vit"):
            # drop masked tokens before the transformer
            x = torch.gather(x, 1,
                             ids_keep[:, :, None].expand(-1, -1, x.shape[-1]))
            for blk in self.blocks3:
                x = self._block(blk, x)
            x = self.norm(x)
        return x.float(), mask, ids_restore

    forward_encoder = encode

    def decode(self, latent: torch.Tensor, ids_restore: torch.Tensor
               ) -> torch.Tensor:
        """→ predicted patch pixels [B, N, 16·16·3] float32."""
        b, len_keep, _ = latent.shape
        n = ids_restore.shape[1]
        x = dense(latent, self.decoder_embed, self.dtype)
        fills = self.mask_token.to(x.dtype).expand(b, n - len_keep, -1)
        x = torch.cat([x, fills], dim=1)
        x = torch.gather(x, 1, ids_restore[:, :, None].expand(-1, -1,
                                                              x.shape[-1]))
        x = x + sincos_pos_embed(self.decoder_dim, self.grid,
                                 x.device).to(x.dtype)
        for blk in self.decoder_blocks:
            x = self._block(blk, x)
        x = self.decoder_norm(x)
        return dense(x, self.decoder_pred, self.dtype).float()

    def per_patch_loss(self, imgs: torch.Tensor, pred: torch.Tensor
                       ) -> torch.Tensor:
        """Per-patch MSE [B, N] against the (optionally per-patch
        normalised) float32 target."""
        target = patchify(imgs.float(), PATCH)
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, correction=0)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        return ((pred - target) ** 2).mean(dim=-1)

    def loss(self, imgs: torch.Tensor, pred: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """MAE reconstruction loss: per-patch MSE averaged over the masked
        patches."""
        per_patch = self.per_patch_loss(imgs, pred)
        return (per_patch * mask).sum() / mask.sum().clamp_min(1.0)

    def forward(self, imgs: torch.Tensor, mask_ratio: float = 0.75,
                generator: Optional[torch.Generator] = None,
                lesion_mask: Optional[torch.Tensor] = None,
                masking: Optional[Masking] = None):
        """→ (loss, pred, mask); the encoder-only model returns
        (latent, mask, ids_restore) instead."""
        latent, mask, ids_restore = self.encode(imgs, mask_ratio, generator,
                                                lesion_mask, masking)
        if not self.with_decoder:
            return latent, mask, ids_restore
        pred = self.decode(latent, ids_restore)
        return self.loss(imgs, pred, mask), pred, mask


def convmae_convvit_base_patch16_dec512d8b(
        norm_pix_loss: bool = False, with_decoder: bool = True,
        dtype: torch.dtype = torch.float32, use_fused_mlp: bool = True,
        use_fused_front: bool = False,
        use_flash_attention: bool = False,
        remat_blocks: bool = False) -> ConvMAE:
    """The reference's constructor.  ``use_fused_mlp`` defaults to on, as
    the JAX config does (``core/config.py:92``)."""
    return ConvMAE(norm_pix_loss=norm_pix_loss, with_decoder=with_decoder,
                   dtype=dtype, use_fused_mlp=use_fused_mlp,
                   use_fused_front=use_fused_front,
                   use_flash_attention=use_flash_attention,
                   remat_blocks=remat_blocks)


_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def init_convmae(model: ConvMAE, generator: torch.Generator) -> ConvMAE:
    """Initialise ``model`` in place from ``generator`` with the JAX
    initialisers' distributions: ``lecun_normal`` Dense and Conv kernels
    (normal truncated to ±2σ, σ = 1/sqrt(fan_in)/0.8796; fan_in of the
    depthwise kernel is 25), zero biases, LayerNorm ones and zeros,
    ``mask_token`` N(0, 0.02²) and ``pos_embed`` the sin-cos table it is
    initialised to (``convmae.py:305-307``)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            std = 1.0 / math.sqrt(mod.weight[0].numel()) / _TRUNC
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    model.pos_embed.copy_(sincos_pos_embed(model.embed_dims[2], model.grid,
                                           model.pos_embed.device)[None])
    if model.with_decoder:
        nn.init.normal_(model.mask_token, 0.0, 0.02, generator=generator)
    return model


def build_convmae(generator: torch.Generator, **cfg) -> ConvMAE:
    """A ``ConvMAE(**cfg)`` laid out on the meta device, materialised on the
    generator's device and initialised from it by :func:`init_convmae`."""
    with torch.device("meta"):
        model = ConvMAE(**cfg)
    model.to_empty(device=generator.device)
    return init_convmae(model, generator)


# ------------------------------------------------------ pretrained weights

def module_groups(model: ConvMAE) -> Dict[str, List[str]]:
    """The units :func:`load_pretrained` replaces whole, as the JAX
    ``load_pretrained`` does its flax modules: top-level module or block
    prefix → its state-dict keys."""
    groups: Dict[str, List[str]] = {}
    for key in model.state_dict():
        parts = key.split(".")
        if parts[0].startswith(("blocks", "decoder_blocks")) or \
                parts[0].startswith("patch_embed"):
            prefix = ".".join(parts[:2])
        else:
            prefix = parts[0]
        groups.setdefault(prefix, []).append(key)
    return groups


def load_pretrained(model: ConvMAE, state_dict: Dict[str, torch.Tensor],
                    log=print) -> Tuple[List[str], List[str]]:
    """Load an upstream ConvMAE state dict with the reference's
    ``strict=False`` semantics (``train_ae.py:139-141``,
    ``convmae.py:532-553``): each module is replaced only when the
    checkpoint holds all of its tensors with matching shapes; everything
    else keeps its initialisation.  ``pos_embed`` may be [N, D] or
    [1, N, D]; keys the model does not have are ignored.  → (missing,
    shape-mismatched) module names."""
    own = model.state_dict()
    missing, skipped = [], []
    with torch.no_grad():
        for group, keys in module_groups(model).items():
            if any(k not in state_dict for k in keys):
                missing.append(group)
                continue
            vals = {k: torch.as_tensor(state_dict[k]) for k in keys}
            if "pos_embed" in vals and vals["pos_embed"].dim() == 2:
                vals["pos_embed"] = vals["pos_embed"][None]
            if any(vals[k].shape != own[k].shape for k in keys):
                skipped.append(group)
                continue
            for k in keys:
                own[k].copy_(vals[k])
    if (missing or skipped) and log is not None:
        log(f"load_pretrained: kept init for missing={missing} "
            f"shape-mismatched={skipped}")
    return missing, skipped
