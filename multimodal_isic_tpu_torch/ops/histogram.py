"""Joint histograms of code pairs, and first-order accumulation over ROI
maps, both batched over rows.

``joint_histogram`` is the counterpart of ``multimodal_isic_tpu/ops/
pallas_hist.py::joint_histogram_pallas`` (the Pallas kernel at :81): codes in
1..n, 0 = skip → P[a−1, b−1] = #{k : codes_a[k] = a ∧ codes_b[k] = b}.  Here
it is batched: ``codes_a``, ``codes_b`` [B, N] int32 → [B, na, nb] float32; a
pair counts only when 1 ≤ a ≤ na and 1 ≤ b ≤ nb (the one-hot rows of the
Pallas kernel drop every other code).  On the radiomics path the rows are
map × angle and the pairs are (gray, run length) at the run starts: the GLRLM
matrix.

``firstorder_accumulate`` is the counterpart of
``firstorder_accumulate_pallas`` (the Pallas kernel at :175), batched over
maps: image [B, N] float32 and levels [B, N] int32 → (stats [B, 9], hist
[B, NG]).  Over the valid pixels
(levels > 0, every positive code): stats = [n, Σx, min, max, Σc, Σc², Σc³,
Σc⁴, Σ|c|] with μ = round_f32(Σx) / max(n, 1) and c = x − μ both in float32;
hist counts codes 1..NG only (the Pallas one-hot is 128 lanes sliced to NG,
so a code above NG counts in stats alone).  An empty map gives the Pallas
kernel's sentinels, min 3.4e38 and max −3.4e38, and sums 0.  Rounding
points: the six sums are taken in float64 (the powers of c in float64 from
the float32 c) and rounded to float32 once; the Pallas kernel summed in
float32 block by block, so the sums are held to ``SUM_TOL`` of their
magnitude (:func:`firstorder_scales`), the counts, min and max exactly.  No
caller in the JAX package: it is an entry point of its own.

- On a CUDA tensor :func:`joint_histogram` launches ``csrc/histogram.cu`` and
  :func:`firstorder_accumulate` ``csrc/firstorder.cu`` (two phases, a
  fixed-order reduction: a rerun gives the same bits), or raise: there is no
  fallback.
- On a CPU tensor they run :func:`joint_histogram_reference` (one count over
  the key row·na·nb + (a−1)·nb + (b−1)) and
  :func:`firstorder_accumulate_reference`.

Counts are integers, exact in float32 below 2²⁴: the joint-histogram kernel
equals the plain version bit for bit.  The wrappers count their kernel
launches in ``joint_histogram.launches`` and
``firstorder_accumulate.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .texture import NG, bincount, map_offsets

SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
_MAX_ROWS = 65535     # gridDim.y


def joint_histogram_reference(codes_a: torch.Tensor, codes_b: torch.Tensor,
                              na: int, nb: int) -> torch.Tensor:
    """Plain version of :func:`joint_histogram`."""
    rows = codes_a.shape[0]
    ok = (codes_a >= 1) & (codes_a <= na) & (codes_b >= 1) & (codes_b <= nb)
    row = torch.arange(rows, device=codes_a.device)[:, None] * (na * nb)
    key = row + (codes_a.long() - 1) * nb + codes_b.long() - 1
    key = torch.where(ok, key, rows * na * nb)
    return bincount(key, rows * na * nb).view(rows, na, nb)


def library_joint_histogram(codes_a: torch.Tensor, codes_b: torch.Tensor,
                            na: int, nb: int) -> torch.Tensor:
    """The same function as one ``torch.bincount`` over the packed key
    row·na·nb + (a−1)·nb + (b−1) of the counted pairs (the key is built and
    the skipped pairs dropped here too).  Not used by the port: the
    yardstick of the card's smoke run."""
    rows = codes_a.shape[0]
    ok = (codes_a >= 1) & (codes_a <= na) & (codes_b >= 1) & (codes_b <= nb)
    row = torch.arange(rows, device=codes_a.device)[:, None] * (na * nb)
    key = (row + (codes_a.long() - 1) * nb + codes_b.long() - 1)[ok]
    return torch.bincount(key, minlength=rows * na * nb).view(
        rows, na, nb).float()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("histogram")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.joint_histogram.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.joint_histogram.restype = i32
    lib.joint_histogram_error_string.argtypes = [i32]
    lib.joint_histogram_error_string.restype = ctypes.c_char_p
    return lib


def joint_histogram(codes_a: torch.Tensor, codes_b: torch.Tensor, na: int,
                    nb: int) -> torch.Tensor:
    """[B, N] int32 code pairs → [B, na, nb] float32 counts (module
    docstring)."""
    if codes_a.dim() != 2 or codes_a.dtype != torch.int32:
        raise ValueError(f"joint_histogram: codes_a must be int32 [B, N], "
                         f"got {codes_a.dtype} {tuple(codes_a.shape)}")
    if codes_b.shape != codes_a.shape or codes_b.dtype != torch.int32:
        raise ValueError(f"joint_histogram: codes_b must be int32 "
                         f"{tuple(codes_a.shape)}, got {codes_b.dtype} "
                         f"{tuple(codes_b.shape)}")
    if codes_b.device != codes_a.device:
        raise ValueError("joint_histogram: codes must be on one device")
    if na < 1 or nb < 1:
        raise ValueError(f"joint_histogram: na, nb must be >= 1, got {na}, {nb}")
    if codes_a.device.type == "cpu":
        return joint_histogram_reference(codes_a, codes_b, na, nb)
    if codes_a.device.type != "cuda":
        raise ValueError(f"joint_histogram: tensors must be on the CPU or a "
                         f"CUDA device, got {codes_a.device}")
    for name, t in (("codes_a", codes_a), ("codes_b", codes_b)):
        if not t.is_contiguous():
            raise ValueError(f"joint_histogram: {name} must be contiguous")
    if na * nb * 4 > SMEM_LIMIT:
        raise ValueError(f"joint_histogram: a {na}x{nb} int32 histogram "
                         f"exceeds one block's {SMEM_LIMIT} B of shared memory")
    rows, n = codes_a.shape
    if rows > _MAX_ROWS:
        raise ValueError(f"joint_histogram: {rows} rows > {_MAX_ROWS}")
    out = torch.zeros((rows, na, nb), dtype=torch.float32,
                      device=codes_a.device)
    if rows == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(codes_a.device):
        stream = torch.cuda.current_stream(codes_a.device).cuda_stream
        rc = lib.joint_histogram(codes_a.data_ptr(), codes_b.data_ptr(),
                                 out.data_ptr(), rows, n, na, nb, stream)
    if rc != 0:
        raise RuntimeError("joint_histogram launch failed: "
                           f"{lib.joint_histogram_error_string(rc).decode()}")
    joint_histogram.launches += 1
    return out


joint_histogram.launches = 0


# --------------------------------------------------------------- first order

FIRSTORDER_STATS = ("n", "sum", "min", "max", "sum_c", "sum_c2", "sum_c3",
                    "sum_c4", "sum_abs_c")
SUMS = (1, 4, 5, 6, 7, 8)  # the columns of stats that are sums
_BIG = 3.4e38              # the Pallas kernel's min / max sentinels (:123)
# Each sum of two implementations, |got − want| <= SUM_TOL · scale, scale
# from :func:`firstorder_scales`.  The orders of summation differ (float32
# block by block in the Pallas kernel, float64 here and on the card), and
# through μ so does the centring: a few float32 ulps of μ move Σc^p by
# p·δμ·Σ|c|^(p−1).  float32 sums of up to 2¹⁹ terms stay well inside 1e-5 of
# their magnitude sum; the float64 ones are within one rounding to float32.
SUM_TOL = 1e-5


def firstorder_accumulate_reference(image: torch.Tensor,
                                    levels: torch.Tensor):
    """Plain version of :func:`firstorder_accumulate`."""
    valid = levels > 0
    x = image.float()
    n = valid.sum(dim=1).float()
    sx = torch.where(valid, x, 0.0).double().sum(dim=1).float()
    mu = sx / n.clamp_min(1.0)
    c = torch.where(valid, x - mu[:, None], 0.0).double()
    c2 = c * c
    sums = torch.stack([c.sum(1), c2.sum(1), (c2 * c).sum(1),
                        (c2 * c2).sum(1), c.abs().sum(1)], dim=1).float()
    big = torch.full((x.shape[0], 1), _BIG, dtype=torch.float32,
                     device=x.device)
    mn = torch.cat([torch.where(valid, x, big), big], dim=1).amin(dim=1)
    mx = torch.cat([torch.where(valid, x, -big), -big], dim=1).amax(dim=1)
    stats = torch.cat([torch.stack([n, sx, mn, mx], dim=1), sums], dim=1)
    rows = x.shape[0]
    ok = (levels >= 1) & (levels <= NG)
    keys = torch.where(ok, levels.long() - 1
                       + map_offsets(rows, NG, x.device).view(rows, 1),
                       rows * NG)
    return stats, bincount(keys, rows * NG).view(rows, NG)


def firstorder_scales(image: torch.Tensor, levels: torch.Tensor,
                      stats: torch.Tensor) -> torch.Tensor:
    """[B, 9] float64 magnitude of each stat, the unit of ``SUM_TOL``:
    Σ|x| for Σx, Σ|c|^p + p·|μ|·Σ|c|^(p−1) for Σc^p (n·|μ| + Σ|c| for Σc and
    Σ|c|), 0 for n, min and max (held exactly); μ and c from ``stats``."""
    valid = levels > 0
    x = torch.where(valid, image.double(), 0.0)
    n = stats[:, 0].double()
    mu = (stats[:, 1] / stats[:, 0].clamp_min(1.0)).double()
    a = torch.where(valid, (x - mu[:, None]).abs(), 0.0)
    p = [n] + [(a ** k).sum(1) for k in (1, 2, 3, 4)]
    m = mu.abs()
    out = torch.zeros(stats.shape, dtype=torch.float64, device=stats.device)
    out[:, 1] = x.abs().sum(1)
    for col, k in ((4, 1), (5, 2), (6, 3), (7, 4)):
        out[:, col] = p[k] + k * m * p[k - 1]
    out[:, 8] = out[:, 4]
    return out



def firstorder_disagreement(image: torch.Tensor, levels: torch.Tensor,
                            got, want):
    """Two (stats, hist) results of the same maps → (whether n, min, max
    and hist are equal, the largest |Δ sum| / (SUM_TOL · scale)): they
    agree where the first is True and the second at most 1."""
    (gs, gh), (ws, wh) = got, want
    exact = bool(torch.equal(gs[:, [0, 2, 3]], ws[:, [0, 2, 3]])
                 and torch.equal(gh, wh))
    scale = firstorder_scales(image, levels, ws)[:, SUMS] * SUM_TOL
    err = (gs[:, SUMS].double() - ws[:, SUMS].double()).abs()
    ratio = torch.where(err == 0, 0.0, err / scale)
    return exact, float(ratio.max()) if ratio.numel() else 0.0

@functools.cache
def _fo_lib() -> ctypes.CDLL:
    lib = _build.load("firstorder")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.firstorder_accumulate.argtypes = [vp, vp, vp, vp, i32, i32, vp, vp]
    lib.firstorder_accumulate.restype = i32
    lib.firstorder_workspace.argtypes = [i32, i32]
    lib.firstorder_workspace.restype = ctypes.c_longlong
    lib.firstorder_error_string.argtypes = [i32]
    lib.firstorder_error_string.restype = ctypes.c_char_p
    return lib


def firstorder_accumulate(image: torch.Tensor, levels: torch.Tensor):
    """[B, N] float32 image and int32 levels → (stats [B, 9], hist [B, NG])
    float32 (module docstring; the columns of stats are
    ``FIRSTORDER_STATS``)."""
    if image.dim() != 2 or image.dtype != torch.float32:
        raise ValueError(f"firstorder_accumulate: image must be float32 "
                         f"[B, N], got {image.dtype} {tuple(image.shape)}")
    if levels.shape != image.shape or levels.dtype != torch.int32:
        raise ValueError(f"firstorder_accumulate: levels must be int32 "
                         f"{tuple(image.shape)}, got {levels.dtype} "
                         f"{tuple(levels.shape)}")
    if levels.device != image.device:
        raise ValueError("firstorder_accumulate: image and levels must be on "
                         "one device")
    if image.device.type == "cpu":
        return firstorder_accumulate_reference(image, levels)
    if image.device.type != "cuda":
        raise ValueError(f"firstorder_accumulate: tensors must be on the CPU "
                         f"or a CUDA device, got {image.device}")
    for name, t in (("image", image), ("levels", levels)):
        if not t.is_contiguous():
            raise ValueError(f"firstorder_accumulate: {name} must be "
                             "contiguous")
    rows, n = image.shape
    if rows > _MAX_ROWS:
        raise ValueError(f"firstorder_accumulate: {rows} maps > {_MAX_ROWS}")
    if rows == 0 or n == 0:  # nothing to accumulate: the empty-map values
        stats = torch.zeros((rows, 9), dtype=torch.float32,
                            device=image.device)
        stats[:, 2], stats[:, 3] = _BIG, -_BIG
        return stats, torch.zeros((rows, NG), dtype=torch.float32,
                                  device=image.device)
    stats = torch.empty((rows, 9), dtype=torch.float32, device=image.device)
    hist = torch.empty((rows, NG), dtype=torch.float32, device=image.device)
    lib = _fo_lib()
    ws = torch.empty(lib.firstorder_workspace(rows, n), dtype=torch.uint8,
                     device=image.device)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = lib.firstorder_accumulate(image.data_ptr(), levels.data_ptr(),
                                       stats.data_ptr(), hist.data_ptr(),
                                       rows, n, ws.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("firstorder_accumulate launch failed: "
                           f"{lib.firstorder_error_string(rc).decode()}")
    firstorder_accumulate.launches += 1
    return stats, hist


firstorder_accumulate.launches = 0
