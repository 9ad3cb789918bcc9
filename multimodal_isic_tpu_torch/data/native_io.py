"""ctypes binding to the native IO worker (``native/isic_io.cc``).

Counterpart of ``multimodal_isic_tpu/data/native_io.py`` (:26-121): JPEG and
PNG decode, the reference's centroid crop and the staging resize in one C
call, threaded over a batch.  The library is the committed
``native/libisic_io.so``.  Where it does not load (it links
``libjpeg.so.62`` and ``libpng16.so.16``), :func:`available` is False and
``DermRecords`` decodes with cv2, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
COMMITTED_LIB = _ROOT / "native" / "libisic_io.so"

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    single = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
              _U8P, _U8P]
    batch = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, _U8P,
             ctypes.c_int]
    for name, args in (("isic_decode_crop", single),
                       ("isic_decode_full", single),
                       ("isic_decode_crop_batch", batch),
                       ("isic_decode_full_batch", batch)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    """The committed library, or None where it does not load."""
    if not COMMITTED_LIB.exists():
        return None
    try:
        return _declare(ctypes.CDLL(str(COMMITTED_LIB)))
    except OSError:  # a shared library it links is missing here
        return None


def available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable: "
                           "native/libisic_io.so does not load here")
    return lib


def decode_crop(image_path: str, mask_path: Optional[str],
                staging_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """→ (image [H, W, 3] uint8 RGB, mask [H, W] uint8); raises on failure."""
    h, w = staging_hw
    image = np.empty((h, w, 3), np.uint8)
    mask = np.empty((h, w), np.uint8)
    rc = _lib().isic_decode_crop(
        image_path.encode(), (mask_path or "").encode(), h, w,
        image.ctypes.data_as(_U8P), mask.ctypes.data_as(_U8P))
    if rc != 0:
        raise FileNotFoundError(f"native decode failed ({rc}): {image_path}")
    return image, mask


def _batch(fn_name: str, image_paths, mask_paths, staging_hw, n_threads):
    lib = _lib()
    n = len(image_paths)
    h, w = staging_hw
    images = np.empty((n, h, w, 3), np.uint8)
    masks = np.empty((n, h, w), np.uint8)
    img_arr = (ctypes.c_char_p * n)(*[p.encode() for p in image_paths])
    mask_arr = (ctypes.c_char_p * n)(
        *[(m or "").encode() for m in (mask_paths or [""] * n)])
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    rc = getattr(lib, fn_name)(img_arr, mask_arr, n, h, w,
                               images.ctypes.data_as(_U8P),
                               masks.ctypes.data_as(_U8P), n_threads)
    if rc != 0:
        raise FileNotFoundError(
            f"native batch decode: {-rc} samples failed (missing/corrupt "
            "files)")
    return images, masks


def decode_crop_batch(image_paths: Sequence[str],
                      mask_paths: Optional[Sequence[Optional[str]]],
                      staging_hw: Tuple[int, int],
                      n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded decode + centroid crop → (images [N, H, W, 3],
    masks [N, H, W])."""
    return _batch("isic_decode_crop_batch", image_paths, mask_paths,
                  staging_hw, n_threads)


def decode_full_batch(image_paths: Sequence[str],
                      mask_paths: Optional[Sequence[Optional[str]]],
                      staging_hw: Tuple[int, int],
                      n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded decode of the full frame (no centroid crop) resized to
    staging: the radiomics path's input (``RadiomicExtractor.py:29-35``)."""
    return _batch("isic_decode_full_batch", image_paths, mask_paths,
                  staging_hw, n_threads)
