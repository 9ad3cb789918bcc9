"""Host side of the GLCM counts (B4, ``ops/glcm.py``), ShiftScaleRotate
warp (B3, ``ops/affine_warp.py``) and colour jitter (``ops/color_jitter.py``)
kernels, on the CPU, where the CUDA kernels cannot run: their launch plans
(``glcm_plan``, ``warp_plan``, ``jitter_plan``),
plain-Python models of how each kernel splits its work (B4: a cluster of
bands of rows with a halo row, lanes of 4 columns in 128-column strips,
16-bit counters, the cluster's sum and P + Pᵀ; B3: a warp's strip of output
pixels, 4 a lane, and its stores from the row buffer with a ragged head and
tail), held against the plain versions; the jitter's plan, a cluster's
slices and its warps' chunks in both phases; B3's fast REFLECT_101
reflection against ``torch.fmod``'s and the jitter's remainder against
``torch.remainder``'s.  Host-side only: no JAX, every test well under
0.1 s."""

import numpy as np
import pytest
import torch

from multimodal_isic_tpu_torch.ops import affine_warp as aw
from multimodal_isic_tpu_torch.ops import color_jitter as cj
from multimodal_isic_tpu_torch.ops import glcm

NG = 64


# ------------------------------------------------------------ B4: the plan

PLAN_SIZES = [(450, 600), (1, 1), (1, 7), (7, 1), (14, 13), (16, 600),
              (17, 600), (33, 257), (449, 601), (2040, 257), (2048, 600),
              (3000, 4000), (5, 65535)]


@pytest.mark.parametrize("hw", PLAN_SIZES)
def test_glcm_plan_puts_every_row_in_one_band_and_fits(hw):
    h, w = hw
    p = glcm.glcm_plan(64, h, w)
    c, bh = p["cluster"], p["band_h"]
    assert c == glcm.CLUSTER and p["threads"] == glcm.THREADS
    assert 1 <= bh and bh * w <= glcm.MAX_BAND_PX
    count = np.zeros(h, np.int32)
    for rnd in range(p["rounds"]):
        for r in range(c):
            y0 = (rnd * c + r) * bh
            count[y0:y0 + bh] += 1
    assert (count == 1).all()
    assert (p["rounds"] - 1) * c * bh < h  # no round wholly past the map
    assert p["smem"] == glcm.SMEM <= glcm.MAX_SMEM
    # the packed (min, max) histogram (two 16-bit counters a word), the
    # slice totals (int32), 8 warps' rings of 4 row slots
    tri = NG * (NG + 1) // 2
    assert glcm.SLICE * glcm.CLUSTER == 4 * tri
    assert p["smem"] == 4 * tri * 2 + glcm.SLICE * 4 + 8 * 4 * 656
    if hw == (450, 600):  # the radiomics chunk's maps: one round of 8 bands
        assert (bh, p["rounds"]) == (57, 1)


def test_glcm_plan_refuses_what_the_kernel_cannot_take():
    for m, h, w in ((0, 4, 4), (65536, 4, 4), (1, 0, 4), (1, 4, 0),
                    (1, 4, 65536)):
        with pytest.raises(ValueError):
            glcm.glcm_plan(m, h, w)


# ------------------------------------------------- B4: a model of the split

def _codes(levels, mask):
    """The kernel's codes: the level where the mask is set and it lies in
    1..NG, else 0 (no pair)."""
    return np.where((mask != 0) & (levels >= 1) & (levels <= NG), levels, 0)


def glcm_bands_model(levels: torch.Tensor, mask: torch.Tensor, band_h: int,
                     cluster: int = glcm.CLUSTER) -> torch.Tensor:
    """``csrc/glcm.cu`` in plain Python: a cluster of ``cluster`` blocks a
    map; block r of round k counts the centres of rows [(k·cluster + r)·
    band_h, + band_h) in 16-bit counters of the bins (min, max) of each
    pair, reading the row below as its halo; a warp walks (128-column
    strip, row segment) tasks (warp w the tasks w, w + 8, ...), a lane
    owning 4 columns and taking its right
    and down-left neighbours from the lanes beside it (lane 31 and lane 0
    read them themselves), skipping a row where no lane's centre is
    inside; the cluster sums each block's slice of bins in rank order, and
    the output is the (min, max) bin, the diagonal doubled: P + Pᵀ."""
    lv, mk = levels.numpy(), mask.numpy()
    m, h, w = lv.shape
    strip, seg_rows, lanes = 128, 8, 32
    tri = NG * (NG + 1) // 2
    n_strips = -(-w // strip)
    rounds = -(-h // (cluster * band_h))
    out = np.zeros((m, 4, NG, NG), np.int64)
    for mi in range(m):
        code = _codes(lv[mi], mk[mi])

        def at(y, x):
            return int(code[y, x]) if 0 <= y < h and 0 <= x < w else 0

        def quad(y, x):
            return [at(y, x + i) for i in range(4)]

        tot = np.zeros(4 * tri, np.int64)
        for rnd in range(rounds):
            hists = []
            for r in range(cluster):
                hist = np.zeros(4 * tri, np.int64)  # the 16-bit counters
                y0 = (rnd * cluster + r) * band_h
                rows = max(0, min(h, y0 + band_h) - y0)
                n_seg = -(-rows // seg_rows)
                for task in range(n_strips * n_seg):
                    seg, s = divmod(task, n_strips)
                    xs = [s * strip + 4 * ln for ln in range(lanes)]
                    r1 = y0 + (seg + 1) * rows // n_seg
                    for y in range(y0 + seg * rows // n_seg, r1):
                        c = [quad(y, x) for x in xs]
                        d = [quad(y + 1, x) for x in xs]
                        if not any(any(q) for q in c):
                            continue  # the warp's row lies outside the ROI
                        c_right = at(y, xs[31] + 4)
                        d_right, d_left = at(y + 1, xs[31] + 4), at(y + 1, xs[0] - 1)
                        for ln in range(lanes):
                            cr = c_right if ln == 31 else c[ln + 1][0]
                            dr = d_right if ln == 31 else d[ln + 1][0]
                            dl = d_left if ln == 0 else d[ln - 1][3]
                            nbs = (c[ln][1:] + [cr], [dl] + d[ln][:3], d[ln],
                                   d[ln][1:] + [dr])
                            for a, nb in enumerate(nbs):
                                for ci, vi in zip(c[ln], nb):
                                    if ci and vi:
                                        lo, hi = min(ci, vi), max(ci, vi)
                                        hist[a * tri + hi * (hi - 1) // 2
                                             + lo - 1] += 1
                assert hist.max(initial=0) <= 0xFFFF, "a 16-bit counter overflows"
                hists.append(hist)
            # after every block of the round counted: block r sums its slice
            # over the cluster's histograms in rank order
            sl = len(tot) // cluster
            for r in range(cluster):
                for k in range(cluster):
                    tot[r * sl:(r + 1) * sl] += hists[k][r * sl:(r + 1) * sl]
        i, j = np.meshgrid(np.arange(1, NG + 1), np.arange(1, NG + 1),
                           indexing="ij")
        lo, hi = np.minimum(i, j), np.maximum(i, j)
        for a in range(4):
            n = tot[a * tri + hi * (hi - 1) // 2 + lo - 1]
            out[mi, a] = np.where(i == j, 2 * n, n)
    return torch.from_numpy(out.astype(np.float32))


def _glcm_cases(rng, h, w):
    """Maps of every kind: a random ROI (levels 1..64 and codes outside
    1..64 inside it), an empty mask, a full frame of 3 levels, one level
    over the frame (every pair of an angle in one bin)."""
    lv = rng.randint(0, 70, (4, h, w)).astype(np.int32)
    mask = (rng.rand(4, h, w) < 0.7).astype(np.uint8) * 255
    mask[1] = 0
    lv[2] = rng.randint(1, 4, (h, w))
    mask[2] = 255
    lv[3] = 9
    mask[3] = 255
    return torch.from_numpy(lv), torch.from_numpy(mask)


@pytest.mark.parametrize("hw,band_h", [((20, 23), 1), ((20, 23), 7),
                                       ((20, 23), 20), ((6, 131), 1),
                                       ((6, 131), 7), ((6, 131), 6),
                                       ((3, 260), 1)])
def test_glcm_band_split_model_matches_plain(hw, band_h):
    """Band heights 1, 7 and H (several rounds where the cluster's bands do
    not reach H), widths that are no multiple of 4 and span two or three
    strips."""
    lv, mask = _glcm_cases(np.random.RandomState(band_h), *hw)
    got = glcm_bands_model(lv, mask, band_h)
    assert torch.equal(got, glcm.glcm_matrices_reference(lv, mask))


# ------------------------------------------------------------ B3: the plan

WARP_SIZES = [(16, 380, 380, 3, 380, 380), (128, 380, 380, 3, 380, 380),
              (5, 37, 45, 3, 37, 45), (3, 1, 7, 3, 3, 5), (2, 50, 70, 4, 41, 93),
              (1, 9, 130, 1, 9, 130), (2, 8, 8, 56, 8, 8)]


@pytest.mark.parametrize("shape", WARP_SIZES)
def test_warp_plan_covers_every_strip_once_and_fits(shape):
    b, h, w, c, oh, ow = shape
    p = aw.warp_plan(*shape)
    assert p["px_lane"] * 32 == p["strip"] and p["threads"] % 32 == 0
    warps = p["threads"] // 32
    assert p["tasks"] == b * oh * -(-ow // p["strip"])
    assert (p["blocks"] - 1) * warps < p["tasks"] <= p["blocks"] * warps
    assert p["stage"] == 0
    assert p["smem"] == warps * (p["strip"] * c + 4) * 4 <= aw.MAX_SMEM
    if shape[:4] == (16, 380, 380, 3):  # the bs 16 train step
        assert (p["tasks"], p["blocks"], p["smem"]) == (18240, 2280, 12416)


def test_warp_plan_refuses_what_the_kernel_cannot_take():
    for shape in ((0, 8, 8, 3, 8, 8), (1, 0, 8, 3, 8, 8), (1, 8, 8, 0, 8, 8),
                  (1, 8, 8, 3, 0, 8), (1, 8, 8, aw.MAX_C + 1, 8, 8),
                  (2 ** 20, 4096, 8, 3, 4096, 8)):
        with pytest.raises(ValueError):
            aw.warp_plan(*shape)


# ------------------------------------------------- B3: a model of the strips

def strip_pixels(p: dict, ow: int, strip: int):
    """Output columns that the lanes write in strip ``strip`` of a row
    (``csrc/affine_warp.cu``): lane l the pixels j = l + 32k < the strip's
    width, k < px_lane (the pixels past it are computed, not written)."""
    xb = strip * p["strip"]
    lane, k = np.meshgrid(np.arange(32), np.arange(p["px_lane"]),
                          indexing="ij")
    j = (lane + 32 * k).ravel()
    return xb + j[j < min(p["strip"], ow - xb)]


def store_spans(g: int, n: int):
    """How the kernel writes floats [g, g + n) of the output from a row
    buffer (``store_row``): (scalar head, 16-byte body, scalar tail) as
    (start, count) float spans."""
    head = min(n, (4 - g % 4) % 4)
    body = (n - head) // 4 * 4
    return (g, head), (g + head, body), (g + head + body, n - head - body)


@pytest.mark.parametrize("shape", WARP_SIZES[:6])
def test_warp_strip_model_computes_and_stores_each_output_once(shape):
    """Every output column of a row is written by exactly one lane of one
    strip, and a strip's floats go out once each: a scalar head, a body of
    16-byte stores starting on a multiple of 4 floats, a scalar tail of at
    most 3."""
    b, h, w, c, oh, ow = shape
    p = aw.warp_plan(*shape)
    n_strips = -(-ow // p["strip"])
    cols = np.concatenate([strip_pixels(p, ow, s) for s in range(n_strips)])
    assert sorted(cols) == list(range(ow))
    for row in (0, 1, b * oh - 1):
        written = np.zeros(ow * c, np.int32)
        for s in range(n_strips):
            xb = s * p["strip"]
            n = min(p["strip"], ow - xb) * c
            g = (row * ow + xb) * c
            (h0, hn), (b0, bn), (t0, tn) = store_spans(g, n)
            assert hn <= 3 and tn <= 3 and bn % 4 == 0
            assert b0 % 4 == 0 or bn == 0
            assert h0 == g and b0 == g + hn and t0 + tn == g + n
            written[g - row * ow * c:g - row * ow * c + n] += 1
        assert (written == 1).all()


# --------------------------------------- B3: the kernel's fast reflection

def _fast_mirror(c: torch.Tensor, n: int) -> torch.Tensor:
    """``csrc/affine_warp.cu::mirror_coord``: |c| below one period is its
    own remainder, so fmod runs only beyond it."""
    if n == 1:
        return torch.zeros_like(c)
    period = torch.tensor(2.0 * (n - 1), dtype=torch.float32)
    a = c.abs()
    m = torch.where(a < period, a, torch.fmod(a, period))
    return torch.minimum(m, period - m)


@pytest.mark.parametrize("n", [1, 2, 7, 45, 380, 601])
def test_fast_reflection_equals_fmod_bit_for_bit(n):
    """A sweep over 0, the period, its multiples up to 40, the floats just
    below and above each, and a dense random range, both signs: the fast
    form equals the plain version's (``aw.mirror_coord``) bit for bit."""
    period = np.float32(2.0 * (n - 1))
    ks = np.arange(0, 41, dtype=np.float32) * max(period, np.float32(1))
    pts = np.concatenate([ks, np.nextafter(ks, np.float32(-np.inf)),
                          np.nextafter(ks, np.float32(np.inf)),
                          ks + np.float32(0.5), ks - np.float32(0.25),
                          np.random.RandomState(n).uniform(
                              0, 41 * max(float(period), 1.0), 4000)
                          .astype(np.float32)])
    c = torch.from_numpy(np.concatenate([pts, -pts]).astype(np.float32))
    want = aw.mirror_coord(c, n)
    got = _fast_mirror(c, n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(((got >= 0) & (got <= max(n - 1, 0))).all())


# ------------------------------------------------------ the jitter: the plan

JITTER_SIZES = [(64, 380, 380), (16, 380, 380), (48, 37, 45), (48, 97, 131),
                (1, 1, 1), (2, 1, 7), (3, 5, 300), (1, 1000, 1000)]


def jitter_chunks(p: dict, n: int, r: int, warp: int, phase: int):
    """Pixels ``[start, end)`` of the image that warp ``warp`` of block
    ``r`` takes, chunk by chunk, in phase 1 (forward) or 2 (reverse), as
    ``csrc/color_jitter.cu`` walks them."""
    lo = min(n, r * p["slice"])
    hi = min(n, lo + p["slice"])
    nch = -(-(hi - lo) // p["chunk"])
    ks = list(range(warp, nch, p["threads"] // 32))
    return [(lo + k * p["chunk"], min(hi, lo + (k + 1) * p["chunk"]))
            for k in (ks if phase == 1 else ks[::-1])]


@pytest.mark.parametrize("shape", JITTER_SIZES)
def test_jitter_plan_walks_every_pixel_once_a_phase(shape):
    b, h, w = shape
    n = h * w
    p = cj.jitter_plan(*shape)
    assert (p["cluster"], p["threads"], p["chunk"]) == (8, 512, 128)
    assert p["blocks"] == 8 * b and p["slice"] % p["chunk"] == 0
    assert p["slice"] * (p["cluster"] - 1) < n + p["cluster"] * p["chunk"]
    assert cj.jitter_plan(1, h, w)["slice"] == p["slice"]  # size alone
    for phase in (1, 2):
        seen = np.zeros(n, np.int32)
        for r in range(p["cluster"]):
            for warp in range(p["threads"] // 32):
                spans = jitter_chunks(p, n, r, warp, phase)
                starts = [a for a, _ in spans]
                assert starts == sorted(starts, reverse=phase == 2)
                for a, e in spans:
                    assert 0 < e - a <= p["chunk"]  # 3·128 floats a buffer
                    seen[a:e] += 1
        assert (seen == 1).all()
    if shape == (64, 380, 380):  # the train step
        assert p["slice"] == 18176 and p["blocks"] == 512


def test_jitter_plan_refuses_what_the_kernel_cannot_take():
    for shape in ((0, 8, 8), (1, 0, 8), (1, 8, 0), (cj.MAX_BATCH + 1, 2, 2),
                  (1, 2 ** 15, 2 ** 15)):
        with pytest.raises(ValueError):
            cj.jitter_plan(*shape)


# ------------------------------------------- the jitter: the remainder

def _rem1(a: torch.Tensor) -> torch.Tensor:
    """``csrc/color_jitter.cu::rem1``: the fractional part with ``a``'s
    sign (fmod's: -0 for a negative whole number), plus 1 where it is
    negative."""
    m = torch.copysign(a - torch.trunc(a), a)
    return torch.where(m < 0, m + 1.0, m)


def test_jitter_remainder_equals_torch_remainder_bit_for_bit():
    """Over the range the hue takes (h / 6 in [-1/6, 5/6], plus a shift in
    [-0.1, 0.1]), its whole numbers, the floats beside them and a dense
    random sweep: the kernel's form equals ``torch.remainder(a, 1.0)``."""
    ks = np.arange(-3, 4, dtype=np.float32)
    pts = np.concatenate([ks, np.nextafter(ks, np.float32(-np.inf)),
                          np.nextafter(ks, np.float32(np.inf)),
                          np.float32([1e-9, -1e-9, 1e-30, -1e-30, 0.5, -0.5]),
                          np.random.RandomState(0).uniform(-2, 2, 20000)
                          .astype(np.float32)])
    a = torch.from_numpy(pts)
    want = torch.remainder(a, 1.0)
    got = _rem1(a)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
