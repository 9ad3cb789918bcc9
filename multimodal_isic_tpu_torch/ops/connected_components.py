"""Same-level 8-connected components of a batch of masked maps.

Counterpart of ``multimodal_isic_tpu/ops/pallas_cc.py::
connected_components_pallas`` (the Pallas kernel at :148) and of the XLA
hooking loop it was held against, ``texture_extra.connected_components``
(:22-83).  ``levels`` [M, H, W] int32 + ``inside`` [M, H, W] bool → labels
[M, H, W] int32: inside the ROI, the minimum linear index (row·W + column,
within the map) of the pixel's component of equal-level 8-neighbours; H·W
outside (the same labels as :67-70 and :132).

- On a CUDA tensor :func:`connected_components` runs ``csrc/
  connected_components.cu`` (up to three launches: a union-find in shared
  memory a tile, the unions across tile borders, the flattening of the
  chains in the tiles they changed; one call counted) or raises: there is
  no fallback.  The wrapper owns the launch plan (:func:`cc_plan`), which
  the library checks against its own layout and refuses otherwise, and the
  int32 scratch of a flag a tile.
- On a CPU tensor it runs :func:`connected_components_reference`, the JAX
  hooking loop: two pointer jumps and a min-hook per round
  (``scatter_reduce_(…, "amin")`` for ``.at[].min``), until no label
  changes (one ``.any()`` per round).

Labels are integers: the kernel equals the plain version bit for bit.  The
wrapper counts its calls in ``connected_components.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .glcm import check_maps
from .texture import shift2d

NEIGH8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def connected_components_reference(levels: torch.Tensor, inside: torch.Tensor,
                                   max_iters: int = 128) -> torch.Tensor:
    """Plain version of :func:`connected_components`: union by min-root
    with pointer jumping, from each pixel's horizontal run start; exact once
    a round changes nothing (``max_iters`` is a safety bound, as in JAX)."""
    m, h, w = levels.shape
    n = h * w
    big = n
    inside = inside.bool()
    dev = levels.device
    lin = torch.arange(n, dtype=torch.int32, device=dev).view(1, h, w)
    # each pixel starts from its horizontal run's start index (a forward
    # cummax over run-start positions): rows collapse at once
    prev_lv = shift2d(levels, 0, 1, -1)
    prev_in = shift2d(inside, 0, 1, False)
    start = inside & (~prev_in | (levels != prev_lv))
    run_start = torch.cummax(torch.where(start, lin, -1), dim=-1).values
    d = torch.where(inside, run_start, big).reshape(m, n)
    big_col = torch.full((m, 1), big, dtype=torch.int32, device=dev)
    same = [inside & (shift2d(levels, dy, dx, -1) == levels)
            for dy, dx in NEIGH8]

    def jump(d):
        ext = torch.cat([d, big_col], dim=1)
        return ext.gather(1, d.clamp(0, big).long())

    def hook_min(d):
        """D[D[p]] ← min(D[D[p]], min same-level neighbour label of p)."""
        lab2 = torch.where(inside, d.view(m, h, w), big)
        best = lab2
        for (dy, dx), ok in zip(NEIGH8, same):
            nl = shift2d(lab2, dy, dx, big)
            best = torch.where(ok, torch.minimum(best, nl), best)
        ext = torch.cat([d, big_col], dim=1)
        ext = ext.scatter_reduce(1, d.clamp(0, big).long(), best.view(m, n),
                                 "amin", include_self=True)
        return ext[:, :-1]

    changed, i = True, 0
    while changed and i < max_iters:
        d2 = hook_min(jump(jump(d)))
        changed = bool((d2 != d).any())
        d, i = d2, i + 1
    label = jump(jump(d)).view(m, h, w)
    return torch.where(inside, label, big)


# The card's kernel (csrc/connected_components.cu; its constants of the same
# names): a tile is at most 32 rows by 128 columns (a quad a lane), its
# columns a multiple of 4; a warp a row, up to 16 warps.
MAX_TILE_H, MAX_TILE_W = 32, 128
MAX_SMEM = 232448  # shared memory a block may have on the H100
SMEM_SHARE = 57344  # a quarter of the SM's 228 KB less 1 KB a block: 4 blocks


def cc_smem_bytes(tile_h: int, tile_w: int) -> int:
    """Shared memory of a tile block: an int32 parent, an int32 level, two
    queued links (uint32) and a 1-byte flag a pixel."""
    return 17 * tile_h * tile_w


@functools.cache
def cc_plan(m: int, h: int, w: int) -> dict:
    """The card's launch plan for [m, h, w] maps: tiles of ``tile_h`` rows
    (at most ``MAX_TILE_H``) by ``tile_w`` columns (a multiple of 4, at most
    ``MAX_TILE_W``), evened out so that ``n_ty`` × ``n_tx`` tiles cover the
    map exactly once, as tall as four blocks of 512 threads an SM allow
    (``SMEM_SHARE``); ``threads`` (a warp a tile row, at most 16 warps) and
    ``smem`` (:func:`cc_smem_bytes`) a block.  The library
    refuses any other plan.  Raises ``ValueError`` for maps the kernel
    cannot take."""
    if m < 1 or h < 1 or w < 1 or m > 65535:
        raise ValueError(f"connected_components: no plan for {m} maps of "
                         f"{h}x{w}")
    if h * w >= 2 ** 31 - 1:
        raise ValueError(f"connected_components: {h}x{w} labels overflow int32")
    n_tx = -(-w // MAX_TILE_W)
    tile_w = -(-w // (4 * n_tx)) * 4
    rows = min(MAX_TILE_H, SMEM_SHARE // (17 * tile_w))
    n_ty = -(-h // rows)
    tile_h = -(-h // n_ty)
    n_ty = -(-h // tile_h)
    if n_ty > 65535:
        raise ValueError(f"connected_components: {n_ty} tile rows > 65535")
    return {"tile_h": tile_h, "tile_w": tile_w, "n_ty": n_ty,
            "n_tx": -(-w // tile_w), "threads": 32 * min(tile_h, 16),
            "smem": cc_smem_bytes(tile_h, tile_w)}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("connected_components")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.connected_components.argtypes = [vp] * 4 + [i32] * 9 + [vp]
    lib.connected_components.restype = i32
    lib.connected_components_error_string.argtypes = [i32]
    lib.connected_components_error_string.restype = ctypes.c_char_p
    return lib


def connected_components(levels: torch.Tensor,
                         inside: torch.Tensor) -> torch.Tensor:
    """[M, H, W] int32 levels + bool inside → [M, H, W] int32 component
    labels (module docstring)."""
    check_maps("connected_components", levels, inside)
    if levels.device.type == "cpu":
        return connected_components_reference(levels, inside)
    m, h, w = levels.shape
    if h * w >= 2 ** 31 - 1:
        raise ValueError(f"connected_components: {h}x{w} labels overflow int32")
    out = torch.empty((m, h, w), dtype=torch.int32, device=levels.device)
    if out.numel() == 0:
        return out
    p = cc_plan(m, h, w)
    dirty = torch.empty(m * p["n_ty"] * p["n_tx"], dtype=torch.int32,
                        device=levels.device)
    lib = _lib()
    with torch.cuda.device(levels.device):
        stream = torch.cuda.current_stream(levels.device).cuda_stream
        rc = lib.connected_components(
            levels.data_ptr(), inside.data_ptr(), out.data_ptr(),
            dirty.data_ptr(), m, h, w,
            p["tile_h"], p["tile_w"], p["n_ty"], p["n_tx"], p["threads"],
            p["smem"], stream)
    if rc != 0:
        raise RuntimeError(
            "connected_components launch failed: "
            f"{lib.connected_components_error_string(rc).decode()}")
    connected_components.launches += 1
    return out


connected_components.launches = 0
