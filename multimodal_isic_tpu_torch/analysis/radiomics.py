"""Radiomics extraction: the 13-filter bank × six texture classes + shape2D.

Counterpart of ``multimodal_isic_tpu/analysis/radiomics.py`` on in-memory
arrays.  Per image: the gray (cv2 BT.601, bit-exact), R, G and B channels,
each through the 13 derived images × {firstorder, glcm, glrlm, glszm, gldm,
ngtdm} plus shape2D once per image, 4 × 1218 = 4872 features.  A chunk of
``batch`` images becomes one batch of ``batch``·4 image×channel maps on the
card (the reference's process pool over images, ``RadiomicExtractor.py:
58-71``, as a batch dimension); each derived image is one pass of the six
classes over all maps, and the chunk's features come back in one
device→host copy.

Column names follow pyradiomics, ``{imagetype}_{class}_{Feature}``, in the
JAX package's order (derived images sorted, classes sorted, features
sorted: JAX's sorted-key tree flattening), with the reference's
``_gs/_red/_green/_blue`` channel suffixes.

The extraction computes in full float32 whatever the global TF32 flags say
(:func:`full_float32`).  ``use_kernels`` routes GLCM, the GLRLM runs and
histogram, and GLSZM's connected components through the kernel wrappers (on
a CUDA tensor, the hand-written kernels); off, the plain PyTorch versions
run instead.  Reading images and masks from disk (cv2), the pandas frames,
the CLI and mesh-sharded extraction are not ported here.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops import filters as FB
from ..ops import texture as T
from ..ops import texture_extra as X

CHANNELS = ("grayscale", "red", "green", "blue")
CHANNEL_SUFFIX = {"grayscale": "_gs", "red": "_red", "green": "_green",
                  "blue": "_blue"}


def bt601_gray(r, g, b):
    """cv2 ``COLOR_BGR2GRAY`` bit-exact: fixed-point BT.601 with shift-15
    coefficients summing to 2¹⁵; integers in, integers out (numpy or
    torch)."""
    return (9798 * r + 19235 * g + 3735 * b + 16384) >> 15


@contextlib.contextmanager
def full_float32():
    """Matrix products and convolutions in full float32 (no TF32) inside
    the block, whatever the global flags; restored after."""
    prec = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cudnn.allow_tf32 = cudnn


def texture_bundle(derived: torch.Tensor, mask: torch.Tensor,
                   bin_width: float, glrlm_max_len: int,
                   use_kernels: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """All 6 texture classes of one derived image, [M, H, W] maps →
    {class: {feature: [M]}} (radiomics.py:46-63)."""
    levels, n_levels, _ = T.discretize(derived, mask, bin_width)
    return {
        "firstorder": T.firstorder_features(derived, mask, bin_width),
        "glcm": T.glcm_features(levels, mask, n_levels, use_kernels),
        "glrlm": T.glrlm_features(levels, mask, n_levels, glrlm_max_len,
                                  use_kernels),
        "glszm": X.glszm_features(levels, mask, n_levels, use_kernels),
        "gldm": X.gldm_features(levels, mask, n_levels),
        "ngtdm": X.ngtdm_features(levels, mask, n_levels),
    }


def _stack_sorted(tree: Dict) -> torch.Tensor:
    """Leaves of a nested dict in sorted-key order, stacked on dim 0 (JAX's
    ``tree_leaves`` order)."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            leaves.append(node)
    walk(tree)
    return torch.stack(leaves)


def _sorted_names(tree: Dict, prefix: str = "") -> List[str]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}_{k}" if prefix else k
        out.extend(_sorted_names(v, name) if isinstance(v, dict) else [name])
    return out


class RadiomicsExtractor:
    """Radiomics extraction on the card in chunks of ``batch`` images
    (``RadiomicsExtractor`` of the JAX package, without its path-based
    APIs)."""

    def __init__(self, bin_width: float = 10.0, label: int = 255,
                 glrlm_max_len: int = 640, batch: int = 16,
                 use_kernels: bool = True, device="cuda"):
        self.bin_width = float(bin_width)
        self.label = label
        self.glrlm_max_len = glrlm_max_len
        self.batch = batch
        self.use_kernels = use_kernels
        self.device = torch.device(device)
        # canonical names from a tiny bundle on the CPU (sorted keys)
        z = torch.zeros((1, 8, 8))
        sample = texture_bundle(z, torch.zeros((1, 8, 8), dtype=torch.uint8),
                                self.bin_width, 8)
        self._bundle_names = _sorted_names(sample)
        self._shape_names = sorted(X.shape2d_features(
            torch.zeros((1, 8, 8), dtype=torch.uint8)))
        self._img_types = sorted(FB.filter_bank(z))

    def feature_names(self) -> List[str]:
        """The 1218 per-channel names, in the order of every result dict."""
        return ([f"{t}_{f}" for t in self._img_types
                 for f in self._bundle_names]
                + [f"original_shape2D_{n}" for n in self._shape_names])

    def _prep(self, rgb_u8: torch.Tensor, mask_u8: torch.Tensor):
        """[B, H, W, 3] uint8 + [B, H, W] uint8 on the card → channel maps
        [B·4, H, W] float32 (gray, R, G, B per image), their masks
        [B·4, H, W] uint8 (255 inside) and the image masks [B, H, W]."""
        c = rgb_u8.to(torch.int32)
        gray = bt601_gray(c[..., 0], c[..., 1], c[..., 2])
        bsz, h, w = gray.shape
        chans = torch.stack([gray, c[..., 0], c[..., 1], c[..., 2]],
                            dim=1).float().reshape(bsz * 4, h, w)
        mb = (mask_u8 == self.label).to(torch.uint8) * 255
        m4 = mb[:, None].expand(bsz, 4, h, w).reshape(bsz * 4, h, w)
        return chans, m4.contiguous(), mb

    def _extract(self, rgb: np.ndarray, masks: np.ndarray):
        """→ (features [n_types, B, 4, nf], shape values [n_shape, B]) as
        numpy, from one device→host copy."""
        rgb_t = torch.as_tensor(np.asarray(rgb, dtype=np.uint8)).to(self.device)
        mask_t = torch.as_tensor(np.asarray(masks, dtype=np.uint8)).to(self.device)
        b = rgb_t.shape[0]
        with torch.no_grad(), full_float32():
            chans, m4, mb = self._prep(rgb_t, mask_t)
            bank = FB.filter_bank(chans)
            vecs = [_stack_sorted(texture_bundle(
                bank[t], m4, self.bin_width, self.glrlm_max_len,
                self.use_kernels)) for t in self._img_types]   # [nf, B·4] each
            feats = torch.stack(vecs).transpose(1, 2)           # [n_t, B·4, nf]
            shape = _stack_sorted(X.shape2d_features(mb))       # [ns, B]
            flat = torch.cat([feats.reshape(-1), shape.reshape(-1)]).cpu().numpy()
        nf = len(self._bundle_names)
        n_t = len(self._img_types)
        cut = n_t * b * 4 * nf
        return (flat[:cut].reshape(n_t, b, 4, nf),
                flat[cut:].reshape(len(self._shape_names), b))

    def _assemble(self, stacked: np.ndarray, shape_vals: np.ndarray
                  ) -> List[Dict[str, Dict[str, float]]]:
        """[n_types, B, 4, nf] + [n_shape, B] → B per-channel dicts."""
        names = self.feature_names()
        out = []
        for bi in range(stacked.shape[1]):
            shape = shape_vals[:, bi].tolist()
            out.append({ch: dict(zip(names, stacked[:, bi, ci, :].reshape(-1)
                                     .tolist() + shape))
                        for ci, ch in enumerate(CHANNELS)})
        return out

    def extract_channels(self, rgb: np.ndarray, mask: np.ndarray
                         ) -> Dict[str, Dict[str, float]]:
        """RGB uint8 [H, W, 3] + mask [H, W] → per-channel feature dicts
        keyed grayscale/red/green/blue (``RadiomicExtractor.py:50-55``)."""
        return self.extract_channels_batch(np.asarray(rgb)[None],
                                           np.asarray(mask)[None])[0]

    def extract_channels_batch(self, rgb_batch: np.ndarray, masks: np.ndarray
                               ) -> List[Dict[str, Dict[str, float]]]:
        """[B, H, W, 3] uint8 RGB + [B, H, W] masks → B per-channel feature
        dicts, all B·4 maps in one pass per derived image."""
        return self._assemble(*self._extract(rgb_batch, masks))

    def extract_batches(self, rgb: np.ndarray, masks: np.ndarray
                        ) -> List[Dict[str, Dict[str, float]]]:
        """In-memory images in chunks of ``batch`` (``_batched_extraction``
        without the decoder)."""
        results: List[Dict] = []
        for s in range(0, len(rgb), self.batch):
            results.extend(self.extract_channels_batch(
                rgb[s:s + self.batch], masks[s:s + self.batch]))
        return results


def features_to_frame(results: Sequence[Dict[str, Dict[str, float]]]
                      ) -> Tuple[List[str], np.ndarray]:
    """Per-channel feature dicts → (columns, values float64 [N, 4·1218]):
    the channels side by side with the ``_gs/_red/_green/_blue`` suffixes,
    the JAX ``features_to_frame`` without pandas."""
    columns: List[str] = []
    blocks = []
    for channel in CHANNELS:
        keys = list(results[0][channel]) if results else []
        columns.extend(k + CHANNEL_SUFFIX[channel] for k in keys)
        blocks.append(np.array([[r[channel][k] for k in keys] for r in results],
                               dtype=np.float64).reshape(len(results), len(keys)))
    return columns, np.concatenate(blocks, axis=1)
