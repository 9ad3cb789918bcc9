"""GLRLM run bookkeeping for the 4 angles of a batch of masked maps.

Counterpart of ``multimodal_isic_tpu/ops/pallas_glrlm.py::glrlm_runs_pallas``
(the Pallas kernel at :105) and ``unpack_runs`` (:118-123).  ``levels``
[M, H, W] int32 + ``inside`` [M, H, W] bool → packed [M, 4, H, W] int32, per
angle (dy, dx) of ``texture.ANGLES_2D`` and per inside cell
``start << 18 | gray << 11 | length``: the run-start flag (the previous cell
along the angle is outside the frame, outside the ROI or of another level),
the gray level, and the distance to the run's end along the angle + 1
(clipped to 11 bits); 0 outside the ROI.  The same bit layout (:32-34) and
the same asserts (:93-99) as the JAX package.

- On a CUDA tensor :func:`glrlm_runs` launches ``csrc/glrlm_runs.cu`` (one
  kernel: each block writes all four angles of a band of rows from shared
  memory, its runs that leave the band resolved from the first run ends
  that the bands below publish; one call counted) or raises: there is no
  fallback.  The wrapper owns the launch plan (:func:`runs_plan`), the
  int16 scratch of the published ends and, per (device, stream), the
  kernel's ticket counter, epoch and ready flags; the library checks the
  plan against its own layout and refuses any other.  A call captured in a
  CUDA graph has state of its own, zeroed at each replay.
- On a CPU tensor it runs :func:`glrlm_runs_reference`, the doubling
  reverse-cummin formulation (``texture.run_starts_and_lengths``).

Integers only: the kernel equals the plain version bit for bit.  The wrapper
counts its kernel launches in ``glrlm_runs.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .glcm import check_maps
from .texture import ANGLES_2D, NG, run_starts_and_lengths

LEN_BITS = 11
GRAY_SHIFT = LEN_BITS
START_SHIFT = LEN_BITS + 7


def _check_sizes(h: int, w: int):
    # packed-run layout invariants: 11 length bits (runs < 2048) and 7 gray
    # bits (levels <= 127) -- fail loudly rather than corrupt features
    if h >= (1 << LEN_BITS) or w >= (1 << LEN_BITS):
        raise ValueError(f"glrlm_runs packs run lengths into {LEN_BITS} "
                         f"bits; {h}x{w} images can have longer runs")
    if NG > 127:
        raise ValueError(f"gray levels must fit 7 bits, NG={NG}")


def glrlm_runs_reference(levels: torch.Tensor,
                         inside: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`glrlm_runs`."""
    _check_sizes(*levels.shape[-2:])
    inside = inside.bool()
    lv = levels.to(torch.int32)
    out = []
    for dy, dx in ANGLES_2D:
        start, _, length = run_starts_and_lengths(lv, inside, dy, dx)
        length = torch.clamp(length, 0, (1 << LEN_BITS) - 1)
        packed = (torch.where(start, 1 << START_SHIFT, 0)
                  | (lv << GRAY_SHIFT) | length)
        out.append(torch.where(inside, packed, 0))
    return torch.stack(out, dim=1).to(torch.int32)


def unpack_runs(packed: torch.Tensor):
    """packed [..., H, W] → (start bool, gray int32, length int32)."""
    start = (packed >> START_SHIFT) > 0
    gray = (packed >> GRAY_SHIFT) & 0x7F
    length = packed & ((1 << LEN_BITS) - 1)
    return start, gray, length


# The card's kernels (csrc/glrlm_runs.cu; its constants of the same names)
MAX_BAND = 32        # rows a band: one 32-bit mask of run ends a line
BAND_ROWS = 16       # the plan's band height where H and W allow
THREADS = 256
MAX_SMEM = 232448    # shared memory a block may have on the H100


def _round(n: int, k: int) -> int:
    return -(-n // k) * k


def band_smem_bytes(band_h: int, w: int) -> int:
    """Shared memory of the band kernel (its ``band_smem``): levels (int32)
    and flags (1 byte) of band_h + 2 rows of W cells (rounded up to 4), the
    run-end masks [3][W + band_h, rounded up, + 4] and the carries [3][W]
    (int32), the block's ticket and epoch."""
    wp = _round(w, 4)
    return ((band_h + 2) * wp * 4 + _round((band_h + 2) * wp, 16)
            + 3 * (_round(w + band_h, 4) + 4) * 4 + 3 * wp * 4 + 16)


@functools.cache
def runs_plan(m: int, h: int, w: int) -> dict:
    """The card's launch plan for [m, h, w] maps: bands of ``band_h`` rows
    (at most ``BAND_ROWS``, fewer where a band of W cells would not fit the
    card's shared memory), evened out so that ``n_bands`` bands cover H
    exactly once; ``threads`` and shared memory (``smem``) a block.  The
    library refuses any other plan.  Raises ``ValueError`` for maps the
    kernel cannot take."""
    if m < 1 or h < 1 or w < 1 or m > 65535:
        raise ValueError(f"glrlm_runs: no plan for {m} maps of {h}x{w}")
    _check_sizes(h, w)
    rows = BAND_ROWS
    while rows > 1 and band_smem_bytes(rows, w) > MAX_SMEM:
        rows -= 1
    if band_smem_bytes(rows, w) > MAX_SMEM:
        raise ValueError(f"glrlm_runs: no band of {w} cells fits "
                         f"{MAX_SMEM} bytes of shared memory")
    n_bands = -(-h // rows)
    band_h = -(-h // n_bands)
    return {"band_h": band_h, "n_bands": -(-h // band_h), "threads": THREADS,
            "smem": band_smem_bytes(band_h, w)}


_STREAM_STATE = {}


def _stream_state(device: torch.device, stream, n: int):
    """The kernel's ticket counter and epoch (int32 [2]) and the bands'
    ready flags (int32, at least ``n``) for one (device, stream), zeroed
    once, at the stream's first call: every launch leaves the counter at 0
    and moves the epoch on, so a flag left from an earlier launch never
    reads as ready.

    A call inside a CUDA-graph capture gets state of its own instead, zeroed
    by the graph at each replay (two memsets in the graph).  Shared state
    would be wrong there: zeroes made inside a capture run only when the
    graph replays, so the stream's eager calls, or another graph's replays
    before this one's first, would read uninitialised tickets; and a graph
    replay that zeroes shared state resets the epoch under flags left by
    others."""
    if torch.cuda.is_current_stream_capturing():
        return (torch.zeros(2, dtype=torch.int32, device=device),
                torch.zeros(n, dtype=torch.int32, device=device))
    key = (device.index, stream)
    state, ready = _STREAM_STATE.get(key, (None, None))
    if state is None:
        state = torch.zeros(2, dtype=torch.int32, device=device)
    if ready is None or ready.numel() < n:
        ready = torch.zeros(n, dtype=torch.int32, device=device)
    _STREAM_STATE[key] = (state, ready)
    return state, ready


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("glrlm_runs")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.glrlm_runs.argtypes = [vp] * 6 + [i32] * 7 + [vp]
    lib.glrlm_runs.restype = i32
    lib.glrlm_runs_error_string.argtypes = [i32]
    lib.glrlm_runs_error_string.restype = ctypes.c_char_p
    return lib


def glrlm_runs(levels: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """[M, H, W] int32 levels + bool inside → packed [M, 4, H, W] int32
    (module docstring)."""
    check_maps("glrlm_runs", levels, inside)
    _check_sizes(*levels.shape[-2:])
    if levels.device.type == "cpu":
        return glrlm_runs_reference(levels, inside)
    m, h, w = levels.shape
    out = torch.empty((m, 4, h, w), dtype=torch.int32, device=levels.device)
    if out.numel() == 0:
        return out
    p = runs_plan(m, h, w)
    ends = torch.empty((m, p["n_bands"], 3, w), dtype=torch.int16,
                       device=levels.device)
    lib = _lib()
    with torch.cuda.device(levels.device):
        stream = torch.cuda.current_stream(levels.device).cuda_stream
        state, ready = _stream_state(levels.device, stream, m * p["n_bands"])
        rc = lib.glrlm_runs(
            levels.data_ptr(), inside.data_ptr(), out.data_ptr(),
            ends.data_ptr(), ready.data_ptr(), state.data_ptr(), m, h, w,
            p["band_h"], p["n_bands"], p["threads"], p["smem"], stream)
    if rc != 0:
        raise RuntimeError("glrlm_runs launch failed: "
                           f"{lib.glrlm_runs_error_string(rc).decode()}")
    glrlm_runs.launches += 1
    return out


glrlm_runs.launches = 0
