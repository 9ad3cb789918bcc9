"""Port parity for the radiomics kernels' plain versions: GLCM counts
(``ops/glcm.py``), GLRLM run bookkeeping (``ops/glrlm_runs.py``), the joint
histogram (``ops/histogram.py``) and connected components
(``ops/connected_components.py``).  Each plain version is what the CUDA
kernel is held against on the card; here it is held against the JAX
package's Pallas kernel in interpret mode and against its XLA formulation,
on the same integer inputs.  All four compute integers, so every comparison
is exact (``assert_array_equal``).  Plus the wrappers' CPU behaviour: the
plain version runs, no launch is counted, bad arguments raise.  And, for
the two kernels that split a map (B7 into tiles, B5 into bands of rows),
their launch plans and a plain-Python model of each split, held against
the plain versions at several tile and band sizes: the arithmetic of the
split, on the CPU, where the CUDA kernels cannot run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.ops import texture as JT
from multimodal_isic_tpu.ops import texture_extra as JX
from multimodal_isic_tpu.ops.pallas_cc import connected_components_pallas
from multimodal_isic_tpu.ops.pallas_glcm import glcm_matrices_pallas
from multimodal_isic_tpu.ops.pallas_glrlm import glrlm_runs_pallas
from multimodal_isic_tpu.ops.pallas_hist import joint_histogram_pallas
from multimodal_isic_tpu_torch.ops import connected_components as tcc
from multimodal_isic_tpu_torch.ops import glcm as tglcm
from multimodal_isic_tpu_torch.ops import glrlm_runs as truns
from multimodal_isic_tpu_torch.ops import histogram as thist
from multimodal_isic_tpu_torch.ops import texture as TT
from tests.test_texture import _case, np_discretize

SIZES = [(14, 13), (45, 60), (40, 129)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels_case(rng, h, w, kind="roi", vmax=30):
    """(levels int32 [H, W], mask uint8 [H, W]) of one map: an ROI with a
    hole, the empty mask, the full frame, or a single gray level."""
    img, mask = _case(rng, h=h, w=w, vmax=vmax)
    if kind == "empty":
        mask[:] = 0
        return np.zeros((h, w), np.int32), mask
    if kind == "full":
        mask[:] = 255
    lv, _ = np_discretize(img, mask, 10.0)
    if kind == "single":
        lv = np.where(mask > 0, 3, 0)
    return lv.astype(np.int32), mask


def _batch(rng, h, w, kinds=("roi", "empty", "full", "single", "roi")):
    cases = [_levels_case(rng, h, w, k) for k in kinds]
    return (np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases]))


# ------------------------------------------------------------------- GLCM

@pytest.mark.parametrize("hw", SIZES)
def test_glcm_plain_matches_pallas_and_xla(rng, hw):
    lv, mask = _batch(rng, *hw)
    got = tglcm.glcm_matrices_reference(torch.from_numpy(lv),
                                        torch.from_numpy(mask)).numpy()
    assert got.shape == (len(lv), 4, TT.NG, TT.NG) and got.dtype == np.float32
    for i in range(len(lv)):
        want = np.asarray(glcm_matrices_pallas(jnp.asarray(lv[i]),
                                               jnp.asarray(mask[i]),
                                               interpret=True))
        np.testing.assert_array_equal(got[i], want, err_msg=f"map {i}")
        xla = np.asarray(JT.glcm_matrices(jnp.asarray(lv[i]),
                                          jnp.asarray(mask[i])))
        np.testing.assert_array_equal(got[i], xla, err_msg=f"map {i}")


def test_glcm_wrapper_on_cpu_runs_plain_version(rng):
    lv, mask = _batch(rng, 14, 13)
    before = tglcm.glcm_matrices.launches
    got = tglcm.glcm_matrices(torch.from_numpy(lv), torch.from_numpy(mask) > 0)
    want = tglcm.glcm_matrices_reference(torch.from_numpy(lv),
                                         torch.from_numpy(mask))
    assert torch.equal(got, want)
    assert tglcm.glcm_matrices.launches == before
    with pytest.raises(ValueError):  # int64 levels
        tglcm.glcm_matrices(torch.from_numpy(lv).long(), torch.from_numpy(mask))
    with pytest.raises(ValueError):  # mask of another shape
        tglcm.glcm_matrices(torch.from_numpy(lv), torch.from_numpy(mask)[:, 1:])


# ------------------------------------------------------------ GLRLM runs

@pytest.mark.parametrize("hw", SIZES)
def test_glrlm_runs_plain_matches_pallas_and_xla(rng, hw):
    lv, mask = _batch(rng, *hw)
    ins = mask > 0
    got = truns.glrlm_runs_reference(torch.from_numpy(lv),
                                     torch.from_numpy(ins)).numpy()
    assert got.shape == (len(lv), 4, *hw) and got.dtype == np.int32
    for i in range(len(lv)):
        want = np.asarray(glrlm_runs_pallas(jnp.asarray(lv[i]),
                                            jnp.asarray(ins[i]),
                                            interpret=True))
        np.testing.assert_array_equal(got[i], want, err_msg=f"map {i}")
        start, gray, length = truns.unpack_runs(torch.from_numpy(got[i]))
        for a, (dy, dx) in enumerate(JT.ANGLES_2D):
            s, g, ln = (np.asarray(v) for v in JT.run_starts_and_lengths(
                jnp.asarray(lv[i]), jnp.asarray(ins[i]), dy, dx))
            np.testing.assert_array_equal(start[a].numpy(), s)
            np.testing.assert_array_equal(gray[a].numpy()[s], g[s])
            np.testing.assert_array_equal(length[a].numpy()[s], ln[s])


def test_glrlm_run_longer_than_max_len_saturates():
    """Runs of 16 with max_len 8 land in the top length bin, through the
    runs and the histogram, as the JAX XLA matrix does."""
    lv = np.ones((1, 2, 16), np.int32)
    mask = np.full((1, 2, 16), 255, np.uint8)
    got = TT.glrlm_matrices(torch.from_numpy(lv), torch.from_numpy(mask),
                            8).numpy()[0]
    for a, (dy, dx) in enumerate(JT.ANGLES_2D):
        want = np.asarray(JT.glrlm_matrix_for_angle(
            jnp.asarray(lv[0]), jnp.asarray(mask[0]) > 0, dy, dx, 8))
        np.testing.assert_array_equal(got[a], want, err_msg=f"angle {a}")
    assert got[0, 0, 7] == 2 and got[0].sum() == 2


def test_glrlm_runs_wrapper_on_cpu_and_size_check(rng):
    lv, mask = _batch(rng, 14, 13)
    before = truns.glrlm_runs.launches
    got = truns.glrlm_runs(torch.from_numpy(lv), torch.from_numpy(mask > 0))
    assert torch.equal(got, truns.glrlm_runs_reference(
        torch.from_numpy(lv), torch.from_numpy(mask > 0)))
    assert truns.glrlm_runs.launches == before
    with pytest.raises(ValueError):  # lengths would overflow 11 bits
        truns.glrlm_runs(torch.zeros((1, 2, 2048), dtype=torch.int32),
                         torch.zeros((1, 2, 2048), dtype=torch.bool))


# -------------------------------------------------------- joint histogram

@pytest.mark.parametrize("na,nb,n", [(9, 29, 5000), (64, 640, 3001)])
def test_joint_histogram_plain_matches_pallas(rng, na, nb, n):
    """Batched rows, codes beyond na / nb and 0 (all skipped)."""
    a = rng.randint(0, na + 3, (3, n)).astype(np.int32)
    b = rng.randint(0, nb + 5, (3, n)).astype(np.int32)
    got = thist.joint_histogram_reference(torch.from_numpy(a),
                                          torch.from_numpy(b), na, nb).numpy()
    assert got.shape == (3, na, nb) and got.dtype == np.float32
    for r in range(3):
        want = np.asarray(joint_histogram_pallas(jnp.asarray(a[r]),
                                                 jnp.asarray(b[r]), na, nb,
                                                 interpret=True))
        np.testing.assert_array_equal(got[r], want, err_msg=f"row {r}")
    ok = (a >= 1) & (a <= na) & (b >= 1) & (b <= nb)
    assert got.sum() == ok.sum()


def test_glrlm_matrices_match_jax_xla(rng):
    """Runs + histogram, batched over maps × angles, equal the JAX XLA
    matrices (``glrlm_matrix_for_angle``) map by map."""
    lv, mask = _batch(rng, 24, 31)
    got = TT.glrlm_matrices(torch.from_numpy(lv), torch.from_numpy(mask),
                            32).numpy()
    for i in range(len(lv)):
        for a, (dy, dx) in enumerate(JT.ANGLES_2D):
            want = np.asarray(JT.glrlm_matrix_for_angle(
                jnp.asarray(lv[i]), jnp.asarray(mask[i]) > 0, dy, dx, 32))
            np.testing.assert_array_equal(got[i, a], want,
                                          err_msg=f"map {i} angle {a}")


def test_joint_histogram_wrapper_on_cpu(rng):
    a = torch.from_numpy(rng.randint(0, 5, (2, 100)).astype(np.int32))
    before = thist.joint_histogram.launches
    got = thist.joint_histogram(a, a, 4, 4)
    assert torch.equal(got, thist.joint_histogram_reference(a, a, 4, 4))
    assert thist.joint_histogram.launches == before
    assert torch.equal(thist.library_joint_histogram(a, a, 4, 4), got)
    with pytest.raises(ValueError):  # int64 codes
        thist.joint_histogram(a.long(), a.long(), 4, 4)


# ------------------------------------------------- connected components

@pytest.mark.parametrize("hw", SIZES)
def test_cc_plain_matches_pallas_and_xla(rng, hw):
    lv, mask = _batch(rng, *hw)
    ins = mask > 0
    got = tcc.connected_components_reference(torch.from_numpy(lv),
                                             torch.from_numpy(ins)).numpy()
    assert got.dtype == np.int32
    for i in range(len(lv)):
        want = np.asarray(connected_components_pallas(
            jnp.asarray(lv[i]), jnp.asarray(ins[i]), interpret=True))
        np.testing.assert_array_equal(got[i], want, err_msg=f"map {i}")
        xla = np.asarray(JX.connected_components(jnp.asarray(lv[i]),
                                                 jnp.asarray(ins[i])))
        np.testing.assert_array_equal(got[i], xla, err_msg=f"map {i}")
    assert (got[1] == hw[0] * hw[1]).all()   # empty mask: all outside
    assert (got[3][ins[3]] == np.argmax(ins[3].reshape(-1))).all()


def serpentine(h, w):
    """Boustrophedon snake of level 7 on level 2 (tests/test_pallas_cc.py):
    one long geodesic that bends every row."""
    levels = np.full((h, w), 2, np.int32)
    snake = np.zeros((h, w), bool)
    snake[0::2, :] = True
    for r in range(1, h, 2):
        snake[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    levels[snake] = 7
    return levels, snake


def test_cc_serpentine_is_one_zone():
    levels, snake = serpentine(40, 41)
    ins = np.ones_like(snake)
    got = tcc.connected_components_reference(
        torch.from_numpy(levels)[None], torch.from_numpy(ins)[None]).numpy()[0]
    assert np.unique(got[snake]).size == 1
    assert int(snake.sum()) == int((got == got[snake][0]).sum())
    want = np.asarray(connected_components_pallas(
        jnp.asarray(levels), jnp.asarray(ins), interpret=True))
    np.testing.assert_array_equal(got, want)


def test_cc_wrapper_on_cpu(rng):
    lv, mask = _batch(rng, 14, 13)
    before = tcc.connected_components.launches
    got = tcc.connected_components(torch.from_numpy(lv),
                                   torch.from_numpy(mask > 0))
    assert torch.equal(got, tcc.connected_components_reference(
        torch.from_numpy(lv), torch.from_numpy(mask > 0)))
    assert tcc.connected_components.launches == before
    with pytest.raises(ValueError):  # float levels
        tcc.connected_components(torch.from_numpy(lv).float(),
                                 torch.from_numpy(mask > 0))


# ------------------------------------------- the card kernels' launch plans
# The CUDA kernels cannot run here; their plans and the arithmetic of their
# split into tiles and bands can.

PLAN_SIZES = [(450, 600), (1, 1), (1, 7), (7, 1), (14, 13), (16, 600),
              (17, 600), (33, 257), (449, 601), (2047, 2047)]


def _cover(h, w, rows, n_rows, cols, n_cols):
    """How many tiles of rows × cols (n_rows × n_cols of them, clipped to the
    map) hold each pixel."""
    count = np.zeros((h, w), np.int32)
    for ty in range(n_rows):
        for tx in range(n_cols):
            count[ty * rows:(ty + 1) * rows, tx * cols:(tx + 1) * cols] += 1
    return count


@pytest.mark.parametrize("hw", PLAN_SIZES)
def test_cc_plan_covers_each_pixel_once_and_fits(hw):
    h, w = hw
    p = tcc.cc_plan(64, h, w)
    assert 1 <= p["tile_h"] <= tcc.MAX_TILE_H
    assert 4 <= p["tile_w"] <= tcc.MAX_TILE_W and p["tile_w"] % 4 == 0
    assert (_cover(h, w, p["tile_h"], p["n_ty"], p["tile_w"], p["n_tx"])
            == 1).all()
    # no tile row or column lies wholly outside the map
    assert (p["n_ty"] - 1) * p["tile_h"] < h and (p["n_tx"] - 1) * p["tile_w"] < w
    assert p["threads"] == 32 * min(p["tile_h"], 16)
    assert p["smem"] == 17 * p["tile_h"] * p["tile_w"]
    assert p["smem"] <= tcc.SMEM_SHARE <= tcc.MAX_SMEM
    if hw == (450, 600):  # the radiomics chunk's maps
        assert (p["tile_h"], p["tile_w"], p["n_ty"], p["n_tx"]) == (27, 120,
                                                                   17, 5)


def test_cc_plan_refuses_what_the_kernel_cannot_take():
    for m, h, w in ((0, 4, 4), (65536, 4, 4), (1, 0, 4), (1, 4, 0),
                    (1, 65536, 32768)):
        with pytest.raises(ValueError):
            tcc.cc_plan(m, h, w)


@pytest.mark.parametrize("hw", PLAN_SIZES)
def test_runs_plan_covers_each_row_once_and_fits(hw):
    h, w = hw
    p = truns.runs_plan(64, h, w)
    assert 1 <= p["band_h"] <= truns.MAX_BAND
    assert (_cover(h, 1, p["band_h"], p["n_bands"], 1, 1) == 1).all()
    assert (p["n_bands"] - 1) * p["band_h"] < h
    assert p["threads"] % 32 == 0 and p["threads"] <= 512
    assert p["smem"] == truns.band_smem_bytes(p["band_h"], w) <= truns.MAX_SMEM
    if hw == (450, 600):
        assert (p["band_h"], p["n_bands"]) == (16, 29)
        # band rows + halo rows of levels and flags, masks, carries, ticket
        assert p["smem"] == 18 * 600 * 5 + 3 * 620 * 4 + 3 * 600 * 4 + 16


def test_runs_plan_refuses_what_the_kernels_cannot_take():
    for m, h, w in ((0, 4, 4), (65536, 4, 4), (1, 0, 4), (1, 4, 0),
                    (1, 2048, 4), (1, 4, 2048)):
        with pytest.raises(ValueError):
            truns.runs_plan(m, h, w)


# ------------------------------- models of the kernels' split, on the CPU

def _same(ins, lv, p, q):
    return bool(ins[q]) and lv[q] == lv[p]


def cc_tiles_model(levels: torch.Tensor, inside: torch.Tensor, tile_h: int,
                   tile_w: int) -> torch.Tensor:
    """``csrc/connected_components.cu``'s three phases, one map at a time in
    plain Python: a union-find a tile from each row run's start, with links
    to the row above only where they join a new run; tile roots as map
    indices; the unions across the tiles' top rows and left columns by the
    same rules; then each pixel's chain from its tile root.  (The kernel
    unites in parallel and in another order; union by the smaller root
    gives the same labels.)"""
    m, h, w = levels.shape
    n = h * w
    out = torch.empty((m, h, w), dtype=torch.int32)
    for k in range(m):
        lv, ins = levels[k].reshape(-1).tolist(), inside[k].reshape(-1).tolist()
        lab = [n] * n
        for y0 in range(0, h, tile_h):
            for x0 in range(0, w, tile_w):
                th, tw = min(tile_h, h - y0), min(tile_w, w - x0)
                par = [-1] * (tile_h * tile_w)
                start = {}
                for r in range(th):
                    run = -1
                    for c in range(tw):
                        p = (y0 + r) * w + x0 + c
                        if not ins[p]:
                            continue
                        start[r, c] = not (c > 0 and _same(ins, lv, p, p - 1))
                        run = c if start[r, c] else run
                        par[r * tile_w + c] = r * tile_w + run

                def find(x):
                    while par[x] != x:
                        x = par[x]
                    return x

                def unite(a, b):
                    a, b = find(a), find(b)
                    par[max(a, b)] = min(a, b)

                for r in range(1, th):
                    for c in range(tw):
                        p = (y0 + r) * w + x0 + c
                        if not ins[p]:
                            continue
                        i, up = r * tile_w + c, p - w
                        mu = _same(ins, lv, p, up)
                        mr = c + 1 < tw and _same(ins, lv, p, up + 1)
                        if start[r, c]:
                            if mu:
                                unite(i, i - tile_w)
                            else:
                                if c > 0 and _same(ins, lv, p, up - 1):
                                    unite(i, i - tile_w - 1)
                                if mr:
                                    unite(i, i - tile_w + 1)
                        elif mr and not mu:
                            unite(i, i - tile_w + 1)
                for r in range(th):
                    for c in range(tw):
                        if par[r * tile_w + c] >= 0:
                            root = find(r * tile_w + c)
                            lab[(y0 + r) * w + x0 + c] = (
                                (y0 + root // tile_w) * w + x0 + root % tile_w)

        def gfind(x):
            while lab[x] != x:
                x = lab[x]
            return x

        def gunite(a, b):
            a, b = gfind(a), gfind(b)
            lab[max(a, b)] = min(a, b)

        for y in range(tile_h, h, tile_h):  # the tiles' top rows
            for x in range(w):
                p = y * w + x
                if not ins[p]:
                    continue
                up = p - w
                mu = _same(ins, lv, p, up)
                mr = x + 1 < w and _same(ins, lv, p, up + 1)
                if not (x > 0 and _same(ins, lv, p, p - 1)):
                    if mu:
                        gunite(p, up)
                    else:
                        if x > 0 and _same(ins, lv, p, up - 1):
                            gunite(p, up - 1)
                        if mr:
                            gunite(p, up + 1)
                elif mr and not mu:
                    gunite(p, up + 1)
        for x in range(tile_w, w, tile_w):  # the tiles' left columns
            for y in range(h):
                p = y * w + x
                if not ins[p]:
                    continue
                if _same(ins, lv, p, p - 1):
                    gunite(p, p - 1)
                    continue
                ty0 = y // tile_h * tile_h
                if y - 1 >= ty0 and _same(ins, lv, p, p - w - 1):
                    gunite(p, p - w - 1)
                if y + 1 < min(h, ty0 + tile_h) and _same(ins, lv, p, p + w - 1):
                    gunite(p, p + w - 1)
        out[k] = torch.tensor([gfind(r) if r < n else n for r in lab],
                              dtype=torch.int32).view(h, w)
    return out


def runs_bands_model(levels: torch.Tensor, inside: torch.Tensor,
                     band_h: int) -> torch.Tensor:
    """``csrc/glrlm_runs.cu``'s band split, one map at a time in plain
    Python: first the records that bands 1 .. n - 1 publish (each vertical
    angle's first run end a line entering the band from above), then each
    band's run-end masks by the kernel's line indices, with the runs that
    leave the band resolved from the records of the bands below (a walk to
    the first band with an end on the line)."""
    m, h, w = levels.shape
    nb = -(-h // band_h)
    out = torch.zeros((m, 4, h, w), dtype=torch.int32)

    def pack(start, gray, length):
        return ((1 << truns.START_SHIFT) if start else 0) | (
            gray << truns.GRAY_SHIFT) | min(length, (1 << truns.LEN_BITS) - 1)

    for k in range(m):
        lv, ins = levels[k].tolist(), inside[k].tolist()

        def cell(y, x):
            return (ins[y][x], lv[y][x]) if 0 <= y < h and 0 <= x < w else (
                False, 0)

        def is_end(y, x, dy, dx):
            (ci, cv), (ni, nv) = cell(y, x), cell(y + dy, x + dx)
            return ci and not (ni and nv == cv)

        def line_mask(y0, rows, r, x, dx):
            """Bit r' for each band row r' >= r where the line ends."""
            mask = 0
            while r < rows and 0 <= x < w:
                mask |= is_end(y0 + r, x, 1, dx) << r
                r, x = r + 1, x + dx
            return mask

        def rows_of(b):
            return min(band_h, h - b * band_h)

        first_end = {}
        for b in range(1, nb):
            for a, dx in enumerate((-1, 0, 1)):
                for xt in range(w):
                    mk = line_mask(b * band_h, rows_of(b), 0, xt, dx)
                    first_end[b, a, xt] = (b * band_h + (mk & -mk).bit_length()
                                           - 1 if mk else None)
        for b in range(nb):
            y0, rows = b * band_h, rows_of(b)
            masks = {}
            for a, dx in enumerate((-1, 0, 1)):
                for i in range(w if dx == 0 else w + rows - 1):
                    r0, x = 0, i
                    if dx == 1:
                        x = i - (rows - 1)
                        r0 = max(0, -x)
                        x += r0
                    if dx == -1 and x > w - 1:
                        r0, x = x - (w - 1), w - 1
                    masks[a, i] = line_mask(y0, rows, r0, x, dx)
            for r in range(rows):
                y = y0 + r
                for x in range(w):
                    if not ins[y][x]:
                        continue
                    c = lv[y][x]
                    e = x
                    while not is_end(y, e, 0, 1):
                        e += 1
                    out[k, 0, y, x] = pack(cell(y, x - 1) != (True, c), c,
                                           e - x + 1)
                    for a, dx in enumerate((-1, 0, 1)):
                        li = x if dx == 0 else (x - r + rows - 1 if dx == 1
                                                else x + r)
                        mk = masks[a, li] >> r
                        if mk:
                            length = (mk & -mk).bit_length()
                        else:  # the run leaves the band: the bands below
                            xt, bb = x + dx * (rows - r), b + 1
                            while first_end[bb, a, xt] is None:
                                xt += dx * rows_of(bb)
                                bb += 1
                            length = first_end[bb, a, xt] - y + 1
                        out[k, a + 1, y, x] = pack(
                            cell(y - 1, x - dx) != (True, c), c, length)
    return out


def _vertical_serpentine(h, w):
    """The serpentine turned on its side: a snake that bends every column."""
    levels, snake = serpentine(w, h)
    return levels.T.copy(), snake.T.copy()


def _split_cases(rng):
    """Maps of every kind, and both serpentines as full frames."""
    lv, mask = _batch(rng, 20, 23)
    ins = mask > 0
    snakes = [serpentine(20, 23), _vertical_serpentine(20, 23)]
    lv = np.concatenate([lv, np.stack([s[0] for s in snakes])])
    ins = np.concatenate([ins, np.ones((2, 20, 23), bool)])
    return torch.from_numpy(lv), torch.from_numpy(ins)


@pytest.mark.parametrize("tile", [(1, 1), (7, 7), (32, 32), (20, 23), (7, 4),
                                  (1, 23), (20, 1)])
def test_cc_tile_split_model_matches_plain(rng, tile):
    lv, ins = _split_cases(rng)
    got = cc_tiles_model(lv, ins, *tile)
    assert torch.equal(got, tcc.connected_components_reference(lv, ins))
    for k in (5, 6):  # each serpentine is one zone
        assert got[k][lv[k] == 7].unique().numel() == 1


@pytest.mark.parametrize("band_h", [1, 7, 32, 20, 3])
def test_runs_band_split_model_matches_plain(rng, band_h):
    lv, ins = _split_cases(rng)
    got = runs_bands_model(lv, ins, band_h)
    assert torch.equal(got, truns.glrlm_runs_reference(lv, ins))
