"""Port parity for the affine warp (``ops/affine_warp.py``): its plain
version, which the CUDA kernel is held against on the card, against the JAX
package's Pallas warp (``affine_warp_batch``, f32, interpret mode) and its
golden gather ``_warp_taps``; against ``F.grid_sample`` as an independent
oracle; and the wrapper's CPU behaviour (no nvcc, no launch counted).

Tolerance: atol 2e-2 on the 0..255 scale, as ``tests/test_pallas_warp.py``
(float rounding of the coordinates and of the four-tap blend)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.data import augment as jaug
from multimodal_isic_tpu.ops.pallas_warp import affine_warp_batch as jwarp
from multimodal_isic_tpu_torch.data import augment as taug
from multimodal_isic_tpu_torch.ops import affine_warp as tw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-2
# corners of the policy's SSR domain (dx, dy, scale, angle), the identity,
# and overhangs beyond the JAX pad budget (128 px at 380², 16 px at 64²)
CORNERS = [(0.05, 0.05, 0.9, 15.0), (-0.05, 0.05, 0.9, -15.0),
           (0.05, -0.05, 1.1, 15.0), (-0.05, -0.05, 1.1, -15.0),
           (0.0, 0.0, 1.0, 0.0)]
OVERHANG = [(0.45, -0.4, 0.6, 170.0), (-0.6, 0.3, 1.4, -95.0)]



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs (a B0
    step here ran 10x slower oversubscribed than on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _inv(h, w, cases):
    return np.stack([np.asarray(jaug._ssr_inverse(h, w, *c), np.float32)
                     for c in cases])


def _ssr_cases(rng, n):
    return [(rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
             1.0 + rng.uniform(-0.1, 0.1), rng.uniform(-15, 15))
            for _ in range(n)]


def _jax_taps(imgs, inv, out_hw):
    """vmapped JAX ``_warp_taps`` (order 1) at the affine coordinates."""
    oh, ow = out_hw
    ys = jnp.arange(oh, dtype=jnp.float32)[:, None]
    xs = jnp.arange(ow, dtype=jnp.float32)[None, :]

    def one(img, p):
        return jaug._warp_taps(img, p[3] * xs + p[4] * ys + p[5],
                               p[0] * xs + p[1] * ys + p[2], 1)

    return np.asarray(jax.vmap(one)(jnp.asarray(imgs), jnp.asarray(inv)))


def _port(imgs, inv, out_hw, **kw):
    return tw.affine_warp_batch(torch.from_numpy(imgs), torch.from_numpy(inv),
                                out_hw, **kw).numpy()


def test_plain_warp_matches_pallas_and_warp_taps_160():
    rng = np.random.RandomState(0)
    h = w = 160
    imgs = rng.randint(0, 256, (9, h, w, 3)).astype(np.float32)
    inv = _inv(h, w, _ssr_cases(rng, 4) + CORNERS)
    ours = _port(imgs, inv, (h, w))
    pallas = np.asarray(jwarp(jnp.asarray(imgs), jnp.asarray(inv), (h, w),
                              compute_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(ours, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours, _jax_taps(imgs, inv, (h, w)),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours[-1], imgs[-1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("h,w", [(64, 64), (97, 131)])
def test_plain_warp_matches_warp_taps_where_the_jax_pad_fails(h, w):
    """At 64² the JAX fast policy's 16-px mirror pad is smaller than the
    SSR overhang (ROADMAP C1); the port reflects in place, so it matches
    the golden gather there, at an odd non-square size, and far beyond."""
    rng = np.random.RandomState(1)
    cases = _ssr_cases(rng, 3) + CORNERS + OVERHANG
    imgs = rng.randint(0, 256, (len(cases), h, w, 3)).astype(np.float32)
    inv = _inv(h, w, cases)
    np.testing.assert_allclose(_port(imgs, inv, (h, w)),
                               _jax_taps(imgs, inv, (h, w)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("h,w,out_hw", [(64, 64, (64, 64)),
                                        (97, 131, (97, 131)),
                                        (50, 70, (40, 90))])
def test_plain_warp_matches_grid_sample(h, w, out_hw):
    rng = np.random.RandomState(2)
    cases = _ssr_cases(rng, 2) + CORNERS[:2] + OVERHANG
    imgs = torch.from_numpy(
        rng.randint(0, 256, (len(cases), h, w, 3)).astype(np.float32))
    inv = torch.from_numpy(_inv(h, w, cases))
    ours = tw.affine_warp_batch(imgs, inv, out_hw)
    lib = tw.affine_warp_grid_sample(imgs, inv, out_hw)
    assert ours.shape == (len(cases), *out_hw, 3)
    torch.testing.assert_close(ours, lib, atol=ATOL, rtol=0)


def test_mirror_coord_matches_jax():
    c = np.linspace(-300.0, 300.0, 4001, dtype=np.float32)
    for n in (2, 12, 97, 380):
        np.testing.assert_array_equal(
            tw.mirror_coord(torch.from_numpy(c), n).numpy(),
            np.asarray(jaug._mirror_coord(jnp.asarray(c), n)))
    assert torch.equal(tw.mirror_coord(torch.tensor([-3.5, 7.0]), 1),
                       torch.zeros(2))


def test_warp_taps_nearest_and_channelless_match_jax():
    rng = np.random.RandomState(3)
    h, w = 33, 47
    masks = (rng.rand(3, h, w) > 0.5).astype(np.float32) * 255
    inv = _inv(h, w, _ssr_cases(rng, 2) + OVERHANG[:1])
    sy, sx = tw.affine_coords(torch.from_numpy(inv), (h, w))
    for order in (0, 1):
        ours = tw.warp_taps(torch.from_numpy(masks), sy, sx, order).numpy()
        want = np.stack([np.asarray(jaug._warp_taps(
            jnp.asarray(m), jnp.asarray(y), jnp.asarray(x), order))
            for m, y, x in zip(masks, sy.numpy(), sx.numpy())])
        np.testing.assert_allclose(ours, want, atol=ATOL, rtol=0)


def test_apply_flags_select_per_image():
    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 256, (3, 24, 24, 3)).astype(np.float32)
    inv = _inv(24, 24, CORNERS[:3])
    apply = torch.tensor([True, False, True])
    out = _port(imgs, inv, (24, 24), apply=apply)
    full = _port(imgs, inv, (24, 24))
    np.testing.assert_array_equal(out[[0, 2]], full[[0, 2]])
    np.testing.assert_array_equal(out[1], imgs[1])


def test_wrapper_checks_and_counts_no_cpu_launch():
    imgs = torch.zeros(2, 8, 8, 3)
    inv = torch.from_numpy(_inv(8, 8, CORNERS[:2]))
    before = tw.affine_warp_batch.launches
    tw.affine_warp_batch(imgs, inv, (8, 8))
    assert tw.affine_warp_batch.launches == before  # CPU: the plain version
    with pytest.raises(ValueError):
        tw.affine_warp_batch(imgs.double(), inv, (8, 8))
    with pytest.raises(ValueError):
        tw.affine_warp_batch(imgs, inv[:1], (8, 8))
    with pytest.raises(ValueError):  # apply needs out_hw == input size
        tw.affine_warp_batch(imgs, inv, (6, 8),
                             apply=torch.tensor([True, False]))
    with pytest.raises(ValueError):
        tw.affine_warp_batch(imgs, inv, (8, 8), apply=torch.tensor([1, 0]))


def test_import_builds_nothing():
    """Importing the module and calling it on the CPU neither needs nvcc
    nor builds a library."""
    code = ("import torch\n"
            "from multimodal_isic_tpu_torch.ops import affine_warp as tw\n"
            "tw.affine_warp_batch(torch.zeros(1, 4, 4, 3), "
            "torch.tensor([[1., 0, 0, 0, 1, 0]]), (4, 4))\n"
            "assert tw._lib.cache_info().currsize == 0\n"
            "assert tw.affine_warp_batch.launches == 0\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_ssr_inverse_matches_jax():
    rng = np.random.RandomState(5)
    cases = _ssr_cases(rng, 6) + CORNERS
    dx, dy, sc, an = (torch.tensor([c[i] for c in cases], dtype=torch.float32)
                      for i in range(4))
    for h, w in ((380, 380), (97, 131)):
        ours = taug.ssr_inverse(h, w, dx, dy, sc, an).numpy()
        want = np.stack([np.asarray(jaug._ssr_inverse(
            h, w, *(jnp.float32(float(v)) for v in vals)))
            for vals in zip(dx, dy, sc, an)])
        np.testing.assert_allclose(ours, want, rtol=1e-5, atol=1e-4)
