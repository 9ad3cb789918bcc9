"""Port parity for first-order accumulation (``ops/histogram.py::
firstorder_accumulate``): its plain version, which the CUDA kernel is held
against on the card, against the JAX package's Pallas kernel
``firstorder_accumulate_pallas`` in interpret mode, on the same seeded maps.
n, min, max and the histogram are held exactly; the six sums within
``SUM_TOL`` of their magnitude (``firstorder_scales``).  Plus the wrapper's
CPU behaviour: the plain version runs, no launch is counted, bad arguments
raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.ops.pallas_hist import (BLK,
                                                 firstorder_accumulate_pallas)
from multimodal_isic_tpu_torch.ops import histogram as thist
from tests.test_texture import _case, np_discretize

H, W = 60, 80  # 4800 pixels: more than two 2048-pixel blocks, not a multiple
CASES = ("roi_with_high_codes", "empty_roi", "one_pixel_roi")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def maps():
    """(image [3, H·W] float32, levels [3, H·W] int32) of the three cases,
    and the Pallas kernel's (stats, hist) of each map (one compile: one
    shape).  Map 0: an ROI with a hole whose codes include NG + 1..128 and
    codes above 128, and a negative code outside it; map 1: an empty ROI;
    map 2: one pixel."""
    assert H * W > 2 * BLK and (H * W) % BLK != 0
    rng = np.random.RandomState(3)
    img, mask = _case(rng, h=H, w=W, vmax=200)
    img = img + rng.rand(H, W).astype(np.float32)  # non-integer values
    lv, _ = np_discretize(img, mask, 10.0)
    lv = lv.astype(np.int32)
    inside = np.flatnonzero(mask.reshape(-1) > 0)
    high = rng.choice(inside, 40, replace=False)
    lv.reshape(-1)[high] = np.array([65, 100, 128, 129, 500] * 8, np.int32)
    lv[0, 0] = -3
    one = np.zeros((H, W), np.int32)
    one[31, 47] = 7
    image = np.stack([img, img * 0.5 - 40.0, img]).reshape(3, -1)
    levels = np.stack([lv, np.zeros_like(lv), one]).reshape(3, -1)
    want = [tuple(np.array(o) for o in firstorder_accumulate_pallas(
        jnp.asarray(image[i].reshape(H, W)),
        jnp.asarray(levels[i].reshape(H, W)), interpret=True))
        for i in range(3)]
    return image.astype(np.float32), levels, want


def _hold(image, levels, stats, hist, want_stats, want_hist):
    """n, min, max and hist exactly, the sums within SUM_TOL · scale."""
    assert stats.dtype == torch.float32 and hist.dtype == torch.float32
    exact, ratio = thist.firstorder_disagreement(
        torch.from_numpy(image[None]), torch.from_numpy(levels[None]),
        (stats[None], hist[None]),
        (torch.from_numpy(want_stats[None]), torch.from_numpy(want_hist[None])))
    assert exact, (stats, want_stats)
    assert ratio <= 1.0, f"a sum is {ratio} of its tolerance away"


@pytest.mark.parametrize("case", range(3), ids=CASES)
def test_firstorder_plain_matches_pallas(maps, case):
    image, levels, want = maps
    stats, hist = thist.firstorder_accumulate_reference(
        torch.from_numpy(image[case:case + 1]),
        torch.from_numpy(levels[case:case + 1]))
    assert stats.shape == (1, 9) and hist.shape == (1, thist.NG)
    _hold(image[case], levels[case], stats[0], hist[0], *want[case])


def test_firstorder_batch_matches_three_pallas_calls(maps):
    image, levels, want = maps
    stats, hist = thist.firstorder_accumulate_reference(
        torch.from_numpy(image), torch.from_numpy(levels))
    assert stats.shape == (3, 9) and hist.shape == (3, thist.NG)
    for i in range(3):
        _hold(image[i], levels[i], stats[i], hist[i], *want[i])
        one = thist.firstorder_accumulate_reference(
            torch.from_numpy(image[i:i + 1]),
            torch.from_numpy(levels[i:i + 1]))
        assert torch.equal(stats[i], one[0][0]) and torch.equal(hist[i],
                                                                one[1][0])


def test_high_codes_count_in_stats_not_in_hist(maps):
    image, levels, want = maps
    stats, hist = thist.firstorder_accumulate_reference(
        torch.from_numpy(image[:1]), torch.from_numpy(levels[:1]))
    lv = levels[0]
    assert stats[0, 0] == (lv > 0).sum() == want[0][0][0]
    assert hist[0].sum() == ((lv >= 1) & (lv <= thist.NG)).sum()
    assert (lv > 128).any() and ((lv > thist.NG) & (lv <= 128)).any()
    assert stats[0, 2] == image[0][lv > 0].min()
    assert stats[0, 3] == image[0][lv > 0].max()


def test_empty_roi_keeps_the_sentinels(maps):
    """ROADMAP C6: an empty ROI gives min 3.4e38, max −3.4e38, sums 0, as
    the Pallas kernel does."""
    image, levels, want = maps
    stats, hist = thist.firstorder_accumulate_reference(
        torch.from_numpy(image[1:2]), torch.from_numpy(levels[1:2]))
    assert stats[0, 2] == np.float32(3.4e38) == want[1][0][2]
    assert stats[0, 3] == np.float32(-3.4e38) == want[1][0][3]
    assert not stats[0, [0, 1, 4, 5, 6, 7, 8]].any()
    assert not hist.any()


def test_one_pixel_roi(maps):
    image, levels, want = maps
    stats, hist = thist.firstorder_accumulate_reference(
        torch.from_numpy(image[2:3]), torch.from_numpy(levels[2:3]))
    x = image[2][levels[2] > 0][0]
    np.testing.assert_array_equal(stats[0, :4].numpy(), [1.0, x, x, x])
    assert not stats[0, 4:].any()
    assert hist[0, 6] == 1 and hist.sum() == 1


def test_plain_sums_match_float64_at_the_path_size():
    """One 450×600 map as the radiomics chunk gives it: the plain sums
    against numpy float64 with the plain version's μ, within SUM_TOL."""
    rng = np.random.RandomState(4)
    img = (rng.randn(450, 600) * 40 + 90).astype(np.float32)
    lv = np.where(rng.rand(450, 600) < 0.4, rng.randint(1, 30, (450, 600)),
                  0).astype(np.int32)
    image = torch.from_numpy(img.reshape(1, -1))
    levels = torch.from_numpy(lv.reshape(1, -1))
    stats, _ = thist.firstorder_accumulate_reference(image, levels)
    vals = img[lv > 0]
    mu = np.float32(stats[0, 1]) / np.float32(stats[0, 0])
    c = (vals - mu).astype(np.float64)
    want = [vals.astype(np.float64).sum(), c.sum(), (c ** 2).sum(),
            (c ** 3).sum(), (c ** 4).sum(), np.abs(c).sum()]
    scale = thist.firstorder_scales(image, levels, stats)[0].numpy()
    for col, w in zip(thist.SUMS, want):
        assert abs(float(stats[0, col]) - w) <= thist.SUM_TOL * scale[col]


def test_wrapper_on_cpu_runs_plain_version(maps):
    image, levels, _ = maps
    before = thist.firstorder_accumulate.launches
    got = thist.firstorder_accumulate(torch.from_numpy(image),
                                      torch.from_numpy(levels))
    want = thist.firstorder_accumulate_reference(torch.from_numpy(image),
                                                 torch.from_numpy(levels))
    assert thist.firstorder_accumulate.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["image_dtype", "levels_dtype", "shape",
                                 "dims"])
def test_wrapper_rejects_bad_arguments(bad):
    image = torch.zeros(2, 10)
    levels = torch.ones(2, 10, dtype=torch.int32)
    image, levels = {
        "image_dtype": (image.double(), levels),
        "levels_dtype": (image, levels.long()),
        "shape": (image, levels[:, :9]),
        "dims": (image[None], levels[None]),
    }[bad]
    with pytest.raises(ValueError):
        thist.firstorder_accumulate(image, levels)


@pytest.mark.parametrize("b,n,path", [(64, 450 * 600, "cluster"),
                                      (3, 4800, "cluster"), (1, 3, "cluster"),
                                      (2, 884736, "cluster"),
                                      (2, 884737, "two_pass"),
                                      (4, 1000 * 1000, "two_pass")])
def test_firstorder_plan_paths(b, n, path):
    """The radiomics chunk's maps (450×600) take the cluster path: one
    launch, the slices of the cluster cover the map, a block's shared memory
    within the card's; a map past the cluster's capacity takes the two-pass
    path with its workspace."""
    p = thist.firstorder_plan(b, n)
    assert p["path"] == path
    if path == "cluster":
        assert p["launches"] == 1 and p["workspace"] == 0
        even = -(-n // p["cluster"])  # the map split evenly, to 4 pixels
        assert p["slice"] % 4 == 0 and even <= p["slice"] < even + 4
        assert p["smem"] + thist.FO_STATIC <= thist.SMEM_LIMIT
        assert p["smem"] == thist.FO_THREADS // 32 * p["region"] * 4
    else:
        assert p["launches"] == 2 and p["workspace"] > 0 and p["smem"] == 0


def _warp_counts(length, head, vec):
    """Pixels each warp of a cluster block takes from a slice of ``length``
    pixels (the kernel's walk: a scalar head of ``head`` pixels before the
    first 16-byte boundary, 16-byte vectors of 4, a scalar tail; every walk
    in warp-uniform steps of 32 lanes over FO_THREADS threads)."""
    threads = thist.FO_THREADS
    counts = np.zeros(threads // 32, np.int64)
    head = min(length, head) if vec else length
    nv = (length - head) // 4

    def scalars(lo, hi):
        for w in range(threads // 32):
            for i0 in range(lo + 32 * w, hi, threads):
                counts[w] += min(32, hi - i0)

    scalars(0, head)
    for w in range(threads // 32):
        for v0 in range(32 * w, nv, threads):
            counts[w] += 4 * min(32, nv - v0)
    scalars(head + 4 * nv, length)
    return counts


@pytest.mark.parametrize("n", [450 * 600, 450 * 600 - 1, 4801, 884736, 3])
def test_firstorder_cluster_regions_hold_every_pixel(n):
    """A model of the kernel's walk: no warp takes more pixels than its
    region holds, at every phase against 16 bytes and without vectors."""
    p = thist.firstorder_plan(1, n)
    for r in range(p["cluster"]):
        length = max(0, min(n, (r + 1) * p["slice"]) - min(n, r * p["slice"]))
        for head, vec in ((0, True), (1, True), (3, True), (0, False)):
            counts = _warp_counts(length, head, vec)
            assert counts.sum() == length
            assert counts.max() <= p["region"], (r, head, vec)
