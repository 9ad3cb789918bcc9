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
run instead.

The path-based APIs (JAX :166-343) read images and masks from disk:
``extract_radiomics`` one image with cv2, ``parallell_extraction`` a list
of records in chunks of ``batch``, and ``extract_radiomics_frames`` both
manifests into the suffixed pandas frames.  A chunk is decoded with the
native full-frame decoder where ``native/libisic_io.so`` loads, and
otherwise with cv2 image by image under ``extract_radiomics``'s own rule, so
its pixels are the per-image path's (the JAX package extracts image by image
without the native decoder; the port keeps chunks on the card either way).
The decoder is a host choice: it changes neither the device nor a kernel.

Several processes (JAX :86-97 shards a chunk's maps over the mesh's
``data`` axis): one card a process, so the chunks are dealt round-robin to
the data ranks of ``grid`` (``parallel.sharding.Grid``), each rank extracts
its chunks on its card, and the chunks' features are gathered to every
rank in the one-process row order.  cv2 and pandas are imported where they
are used.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.precision import full_float32  # noqa: F401  (re-exported)
from ..ops import filters as FB
from ..ops import texture as T
from ..ops import texture_extra as X

CHANNELS = ("grayscale", "red", "green", "blue")
FEATURE_CLASSES = ("firstorder", "glcm", "glrlm", "glszm", "gldm", "ngtdm")
CHANNEL_SUFFIX = {"grayscale": "_gs", "red": "_red", "green": "_green",
                  "blue": "_blue"}


def bt601_gray(r, g, b):
    """cv2 ``COLOR_BGR2GRAY`` bit-exact: fixed-point BT.601 with shift-15
    coefficients summing to 2¹⁵; integers in, integers out (numpy or
    torch)."""
    return (9798 * r + 19235 * g + 3735 * b + 16384) >> 15


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
    (``RadiomicsExtractor`` of the JAX package)."""

    def __init__(self, bin_width: float = 10.0, label: int = 255,
                 glrlm_max_len: int = 640, batch: int = 16,
                 use_kernels: bool = True, device="cuda", grid=None):
        self.bin_width = float(bin_width)
        self.label = label
        self.glrlm_max_len = glrlm_max_len
        self.batch = batch
        self.use_kernels = use_kernels
        self.device = torch.device(device)
        self.grid = grid  # several processes: the chunks split over data
        # canonical names from a tiny bundle on the CPU (sorted keys)
        z = torch.zeros((1, 8, 8))
        sample = texture_bundle(z, torch.zeros((1, 8, 8), dtype=torch.uint8),
                                self.bin_width, 8)
        self._bundle_names = _sorted_names(sample)
        self._shape_names = sorted(X.shape2d_features(
            torch.zeros((1, 8, 8), dtype=torch.uint8)))
        self._img_types = sorted(FB.filter_bank(z))

    def get_enabled_image_types(self) -> List[str]:
        """``RadiomicExtractor.py:17-21`` introspection (JAX :166-169)."""
        return ["Original", "Wavelet", "LoG", "Square", "SquareRoot",
                "Logarithm", "Exponential", "Gradient"]

    def get_enabled_features(self) -> List[str]:
        return list(FEATURE_CLASSES) + ["shape2D"]

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

    # -- path-based APIs (JAX :221-325) ------------------------------------
    def extract_radiomics(self, record: Dict) -> Dict[str, Dict[str, float]]:
        """One image from disk (``RadiomicExtractor.py:23-55``; JAX
        :221-231): the BGR read, the gray mask, a nearest-neighbour mask
        resize where its size differs, BGR → RGB."""
        return self.extract_channels(*read_image_mask(record))

    def _decode_chunk(self, records: Sequence[Dict], hw: Tuple[int, int],
                      native: bool) -> Tuple[np.ndarray, np.ndarray]:
        """A chunk's full frames at ``hw`` → (RGB [B, H, W, 3], masks
        [B, H, W]) uint8: the native batch decoder, or cv2 image by image
        under :meth:`extract_radiomics`'s rule (a frame of another size
        resized to ``hw``: the image bilinear, the mask nearest, as the
        native decoder does)."""
        from ..data import native_io

        if native:
            return native_io.decode_full_batch(
                [r["image_path"] for r in records],
                [r.get("segmentation_path") for r in records], hw)
        import cv2  # local: host-only dependency

        rgb = np.empty((len(records), *hw, 3), np.uint8)
        masks = np.empty((len(records), *hw), np.uint8)
        for i, r in enumerate(records):
            im, sg = read_image_mask(r)
            if im.shape[:2] != tuple(hw):
                im = cv2.resize(im, hw[::-1], interpolation=cv2.INTER_LINEAR)
                sg = cv2.resize(sg, hw[::-1], interpolation=cv2.INTER_NEAREST)
            rgb[i], masks[i] = im, sg
        return rgb, masks

    def _batched_extraction(self, records: Sequence[Dict],
                            native: Optional[bool] = None) -> List[Dict]:
        """Chunks of ``batch`` records at the first image's size, the last
        padded with its own last record (one shape a chunk), the next chunk
        decoding on a host thread while the card works on this one (JAX
        :258-289).  ``native=None`` takes the native decoder where it
        loads.  With a grid of several data ranks a rank extracts chunks
        ``data_rank``, ``data_rank + n_data``, … and every rank gets all
        the chunks' features, in order."""
        from concurrent.futures import ThreadPoolExecutor

        from ..data import native_io

        if native is None:
            native = native_io.available()
        hw = read_image_mask(records[0])[0].shape[:2]
        bsz = int(self.batch)
        chunks = [list(records[i:i + bsz])
                  for i in range(0, len(records), bsz)]
        grid = self.grid
        world, rank = (grid.n_data, grid.data_rank) if grid else (1, 0)
        mine = list(range(rank, len(chunks), world))

        def decode(ci):
            chunk = chunks[ci]
            padded = chunk + [chunk[-1]] * (bsz - len(chunk))
            return self._decode_chunk(padded, hw, native)

        done = {}
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(decode, mine[0]) if mine else None
            for k, ci in enumerate(mine):
                rgb, masks = fut.result()
                if k + 1 < len(mine):
                    fut = ex.submit(decode, mine[k + 1])
                stacked, shape = self._extract(rgb, masks)
                n = len(chunks[ci])
                done[ci] = (stacked[:, :n], shape[:, :n])
        if world > 1:
            from ..parallel.distributed import all_gather_object
            for part in all_gather_object(done, grid.data_group):
                done.update(part)
        results: List[Dict] = []
        for ci in range(len(chunks)):
            results.extend(self._assemble(*done[ci]))
        return results

    def parallell_extraction(self, list_of_dicts: Sequence[Dict],
                             n_processes=None) -> List[Dict]:
        """Name kept (sic) for API parity (JAX :291-312): chunks of
        ``batch`` on the card through :meth:`_batched_extraction`; prints
        the decoder and the time taken."""
        from ..data import native_io

        start = time.time()
        native = native_io.available()
        print(f"radiomics decoder: {'native' if native else 'cv2'}")
        results = (self._batched_extraction(list_of_dicts, native)
                   if list_of_dicts else [])
        h, m, s = self._convert_time(start, time.time())
        print(f" Time taken: {h}h:{m}m:{s}s")
        return results

    serial_extraction = parallell_extraction

    @staticmethod
    def _convert_time(start_time, end_time):
        dt = end_time - start_time
        return int(dt // 3600), int((dt % 3600) // 60), int(dt % 60)


def read_image_mask(record: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """A record's full frame from disk with cv2 → (RGB [H, W, 3], gray mask
    [H, W]) uint8, the mask resized nearest to the image where their sizes
    differ (``RadiomicExtractor.py:29-35``)."""
    import cv2  # local: host-only dependency

    im = cv2.imread(record["image_path"], cv2.IMREAD_COLOR)  # BGR
    if im is None:
        raise FileNotFoundError(record["image_path"])
    sg = cv2.imread(record["segmentation_path"], cv2.IMREAD_GRAYSCALE)
    if sg is None:
        raise FileNotFoundError(record["segmentation_path"])
    if im.shape[:2] != sg.shape[:2]:
        sg = cv2.resize(sg, (im.shape[1], im.shape[0]),
                        interpolation=cv2.INTER_NEAREST)
    return cv2.cvtColor(im, cv2.COLOR_BGR2RGB), sg


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


def extract_radiomics_frames(config, df_train, df_test,
                             extractor: Optional[RadiomicsExtractor] = None):
    """The ``extract_radiomics.py`` workload (JAX :328-343): both manifests
    extracted and their suffixed frames (the JAX ``features_to_frame``,
    ``extract_radiomics.py:54-71``) pickled to ``dir.radiomics[_test]`` →
    (train frame, test frame).  With the extractor's grid every rank gets
    the frames and rank 0 alone writes them."""
    import pandas as pd  # local: host-only dependency

    extractor = extractor or RadiomicsExtractor()

    def frame(df):
        results = extractor.parallell_extraction(df.to_dict(orient="records"))
        columns, values = features_to_frame(results)
        return pd.DataFrame(values, columns=columns)

    train, test = frame(df_train), frame(df_test)
    d = config["dir"]
    grid = extractor.grid
    if grid is None or grid.rank == 0:  # several processes: rank 0 writes
        if d.get("radiomics"):
            train.to_pickle(d["radiomics"])
        if d.get("radiomics_test"):
            test.to_pickle(d["radiomics_test"])
    return train, test
