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
  :func:`firstorder_accumulate` ``csrc/firstorder.cu``, or raise: there is no
  fallback.  First order follows :func:`firstorder_plan`: a map that fits
  one thread-block cluster's shared memory (the radiomics chunk's 450×600)
  is read once, by one launch; a larger one takes two phases over device
  memory.  Both reduce in a fixed order: a rerun gives the same bits.
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

# The card's first-order kernel (csrc/firstorder.cu; its constants of the
# same names): a map that one thread-block cluster of FO_CLUSTER blocks
# keeps in shared memory takes the cluster path, a larger one the two-pass
# path.
FO_CLUSTER = 16     # blocks a map: a non-portable cluster size
FO_THREADS = 512    # a cluster block: 16 warps, each compacting a region
FO_STATIC = 8192    # a cluster block's static shared memory, at most
FO_SMS, FO_MIN_CHUNK, FO_NSUM = 132, 4096, 5  # the two-pass path's grid


def _a(n: int, k: int) -> int:
    return -(-n // k) * k


def firstorder_plan(b: int, n: int) -> dict:
    """The card's launch plan for B maps of N pixels, which the library
    recomputes and holds the wrapper to.  ``path`` "cluster": one
    thread-block cluster of ``cluster`` blocks a map, block r reading pixels
    [r·slice, (r + 1)·slice) once and its warps compacting the values of
    their valid pixels into ``region`` floats each (128 a step of the
    16-byte walk, 32 more for a scalar head and tail): ``smem`` bytes of
    dynamic shared memory beside ``FO_STATIC`` of static, one launch.
    ``path`` "two_pass" where a block cannot keep its slice: (chunk, map)
    blocks, two launches, ``workspace`` bytes of partials and tickets (the
    library's ``carve``).  Raises ``ValueError`` for sizes no path takes."""
    if b < 1 or b > _MAX_ROWS or n < 1:
        raise ValueError(f"firstorder_accumulate: no plan for {b} maps of "
                         f"{n} pixels")
    p = _a(-(-n // FO_CLUSTER), 4)
    region = 128 * -(-(p // 4) // FO_THREADS) + 32
    smem = FO_THREADS // 32 * region * 4
    if smem + FO_STATIC <= SMEM_LIMIT:
        return {"path": "cluster", "cluster": FO_CLUSTER, "slice": p,
                "region": region, "smem": smem, "workspace": 0,
                "launches": 1}
    want = max(1, -(-4 * FO_SMS // b))
    want = min(want, max(1, -(-n // FO_MIN_CHUNK)))
    chunk = _a(-(-n // want), 4)
    parts = b * -(-n // chunk)
    ws = sum(_a(v, 256) for v in (parts * 24, parts * FO_NSUM * 8,
                                  parts * NG * 4, b * 4))
    return {"path": "two_pass", "cluster": 0, "slice": 0, "region": 0,
            "smem": 0, "workspace": ws, "launches": 2}


@functools.cache
def _fo_lib() -> ctypes.CDLL:
    lib = _build.load("firstorder")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.firstorder_accumulate.argtypes = ([vp] * 4 + [i32] * 6
                                          + [i64, vp, i64, vp])
    lib.firstorder_accumulate.restype = i32
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
    plan = firstorder_plan(rows, n)
    stats = torch.empty((rows, 9), dtype=torch.float32, device=image.device)
    hist = torch.empty((rows, NG), dtype=torch.float32, device=image.device)
    ws = (torch.empty(plan["workspace"], dtype=torch.uint8,
                      device=image.device) if plan["workspace"] else None)
    lib = _fo_lib()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = lib.firstorder_accumulate(
            image.data_ptr(), levels.data_ptr(), stats.data_ptr(),
            hist.data_ptr(), rows, n, 0 if plan["path"] == "cluster" else 1,
            plan["cluster"], plan["slice"], plan["region"], plan["smem"],
            None if ws is None else ws.data_ptr(), plan["workspace"], stream)
    if rc != 0:
        raise RuntimeError("firstorder_accumulate launch failed: "
                           f"{lib.firstorder_error_string(rc).decode()}")
    firstorder_accumulate.launches += 1
    return stats, hist


firstorder_accumulate.launches = 0
