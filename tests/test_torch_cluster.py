"""Port parity for latent clustering: ``analysis/{kmeans,cluster,ann,
embed}.py`` against the JAX package on the CPU.

Data are seeded numpy Gaussian blobs; every JAX function is jitted once
(the exact and layout paths at N ≤ 600, the approximate graph at N ≤
4,000).  Tolerances:

- k-means from JAX's own k-means++ centers: the same labels and
  ``n_iter``, centers within 1e-5, inertia within 1e-5 relative (float32
  sums in another order);
- the cluster statistics and ``trustworthiness`` (float64 on the torch
  side, an integer penalty sum) equal JAX's, the score to 1e-12;
- the approximate graph: JAX's buckets from the same seed, ≥ 99.9% of the
  neighbour entries equal (a float32 near-tie at a bucket boundary may
  move a point) and the squared distances of shared entries within 1e-6
  of ‖q‖² + ‖c‖², the scale of the expanded form's float32 rounding (as
  are the port's from float64 ones),
  ``_balance_buckets``, the sentinel slots and ``knn_recall`` exactly;
- the exact graph: JAX's neighbour sets, in JAX's order but for float32
  near-ties, distances as the approximate graph's;
- fuzzy weights and core distances within 1e-6; 10 layout epochs on JAX's
  negative draws within 1e-4 of JAX's ``y``; ``n_seg`` 3 against 1 within
  1e-5; a chunked and a resumed layout bit for bit;
- the density clusterings: JAX's labels; the neighbour embedding's
  trustworthiness within 0.02 of JAX's (its draws differ) and above PCA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.analysis import ann as JA
from multimodal_isic_tpu.analysis import cluster as JC
from multimodal_isic_tpu.analysis import embed as JE
from multimodal_isic_tpu.analysis import kmeans as JK
from multimodal_isic_tpu_torch.analysis import ann as TA
from multimodal_isic_tpu_torch.analysis import cluster as TC
from multimodal_isic_tpu_torch.analysis import embed as TE
from multimodal_isic_tpu_torch.analysis import kmeans as TK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(seed, n, d, centers=6, spread=0.3, scale=3.0):
    rng = np.random.RandomState(seed)
    mu = rng.randn(centers, d) * scale
    which = rng.randint(0, centers, n)
    return (mu[which] + rng.randn(n, d) * spread).astype(np.float32), which


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- k-means

def test_lloyd_from_jax_init_matches_fit():
    x, _ = _blobs(0, 600, 8, centers=7, spread=1.0)
    key = jax.random.PRNGKey(3)
    state, labels = JK.fit(key, x, 6)
    init = JK._kmeanspp_init(key, jnp.asarray(x), 6)
    got, got_labels = TK.lloyd(_t(x), _t(init))
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(labels))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(state.centers),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(got.inertia), float(state.inertia),
                               rtol=1e-5)
    assert int(got.n_iter) == int(state.n_iter)
    np.testing.assert_array_equal(TK.predict(got, x).numpy(),
                                  got_labels.numpy())


def test_fit_best_of_picks_jax_restart():
    x, _ = _blobs(1, 500, 4, centers=9, spread=0.8, scale=2.0)
    key = jax.random.PRNGKey(5)
    state, labels = JK.fit_best_of(key, x, 5)
    inits = np.stack([np.asarray(JK._kmeanspp_init(s, jnp.asarray(x), 5))
                      for s in jax.random.split(key, 4)])
    states, all_labels = TK.lloyd(_t(x), _t(inits))
    assert len(set(np.round(states.inertia.numpy(), 2))) > 1  # a real choice
    best, best_labels = TK.best_restart(states, all_labels)
    np.testing.assert_array_equal(best_labels.numpy(), np.asarray(labels))
    np.testing.assert_allclose(float(best.inertia), float(state.inertia),
                               rtol=1e-5)


def test_own_init_recovers_planted_blobs():
    x, which = _blobs(2, 600, 6, centers=5, spread=0.2, scale=5.0)
    state, labels = TK.fit_best_of(torch.Generator().manual_seed(0), x, 5)
    labels = labels.numpy()
    for c in range(5):  # every planted blob is one cluster
        assert len(np.unique(labels[which == c])) == 1
    assert len(np.unique(labels)) == 5
    single, _ = TK.fit(torch.Generator().manual_seed(1), x, 5)
    assert single.centers.shape == (5, 6) and int(single.n_iter) >= 1


# ------------------------------------------------------ cluster statistics

def test_cluster_statistics_equal_jax():
    rng = np.random.RandomState(4)
    n, nc = 400, 4
    clusters = rng.randint(-1, 9, n)          # −1: noise
    targets = rng.randint(0, nc, n)
    patients = rng.randint(0, nc, 60)
    jw = JC.patient_class_weights(patients, nc)
    tw = TC.patient_class_weights(patients, nc)
    assert tw == jw
    js = JC.cluster_purity_stats(clusters, targets, nc, class_weights=jw)
    ts = TC.cluster_purity_stats(clusters, targets, nc, class_weights=tw)
    assert sorted(ts) == sorted(js)
    for key in js:
        np.testing.assert_array_equal(ts[key], js[key])
    (jk, jt), (tk, tt) = (JC.filter_low_purity_clusters(js, 10),
                          TC.filter_low_purity_clusters(ts, 10))
    np.testing.assert_array_equal(tk, jk)
    assert tt == jt
    x, _ = _blobs(4, 300, 12)
    emb = x[:, :2] + rng.randn(300, 2).astype(np.float32)
    for nn in (5, 12):
        assert abs(TC.trustworthiness(x, emb, nn, block=64)
                   - JC.trustworthiness(x, emb, nn)) <= 1e-12


# ---------------------------------------------------------- approximate kNN

def _entries_agree(x, nbr_a, dist_a, nbr_b, dist_b):
    """Share of (row, neighbour) entries in both graphs, and the largest
    difference of their squared distances over the shared ones, in units
    of ‖q‖² + ‖c‖²: the scale at which float32 rounds the expanded
    ‖q‖² − 2q·c + ‖c‖² (relative to d itself the two packages differ by up
    to ~5e-5 on these blobs, where d² ≪ ‖q‖²)."""
    sq = (x.astype(np.float64) ** 2).sum(1)
    same, worst = 0, 0.0
    for r, (ra, da, rb, db) in enumerate(zip(nbr_a, dist_a, nbr_b, dist_b)):
        shared, ia, ib = np.intersect1d(ra, rb, return_indices=True)
        same += len(shared)
        if len(shared):
            a, b = (da[ia].astype(np.float64) ** 2,
                    db[ib].astype(np.float64) ** 2)
            worst = max(worst, float(np.max(np.abs(a - b)
                                            / (sq[r] + sq[shared]))))
    return same / nbr_b.size, worst


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_approx_graph_matches_jax(metric):
    x, _ = _blobs(5, 4000, 16, centers=12, spread=0.4)
    jn, jd = JA.approx_knn_graph(x, 15, metric, seed=2)
    tn, td = TA.approx_knn_graph(x, 15, metric, seed=2, device="cpu")
    xs = x if metric == "euclidean" else \
        x / np.linalg.norm(x, axis=1, keepdims=True)
    share, worst = _entries_agree(xs, tn, td, jn, jd)
    assert share >= 0.999 and worst <= 1e-6, (share, worst)
    # and the port's distances are float32-exact ones
    exact = np.sqrt(((xs[:50, None, :].astype(np.float64)
                      - xs[tn[:50]]) ** 2).sum(-1))
    _, err = _entries_agree(xs, tn[:50], td[:50], tn[:50], exact)
    assert err <= 1e-6, err
    assert TA.knn_recall(tn, jn, td) == JA.knn_recall(tn, jn, td)
    if metric == "euclidean":
        # the same seed draws JAX's buckets
        rs_j, rs_t = np.random.RandomState(2), np.random.RandomState(2)
        c = int(np.sqrt(len(x)))
        init = rs_j.choice(len(x), c, replace=False)
        np.testing.assert_array_equal(rs_t.choice(len(x), c, replace=False),
                                      init)
        # each Lloyd step from JAX's centers: JAX's assignment but for
        # float32 near-ties (one in 4,000 rows here), one step's centers
        # equal; across steps a moved row moves its buckets' centers
        jc = jnp.asarray(x[init])
        for step in range(4):
            tc, tl = TA._lloyd_step(_t(x), _t(jc), c)
            jc, jl = JA._lloyd_step(jnp.asarray(x), jc, c)
            agree = tl.numpy() == np.asarray(jl)
            assert agree.mean() >= 0.999
            if agree.all():
                np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                           atol=1e-5, rtol=0)


def test_balance_buckets_and_sentinels_equal_jax():
    x, _ = _blobs(6, 2000, 6, centers=3, spread=0.5)
    labels = np.where(x[:, 0] > 0, 0, 1) * (np.arange(2000) % 5 != 0) + \
        2 * (np.arange(2000) % 5 == 0)
    cen = np.stack([x[labels == b].mean(0) for b in range(3)])
    jl, jc = JA._balance_buckets(x, labels.copy(), cen.copy(), 150,
                                 np.random.RandomState(7))
    tl, tc = TA._balance_buckets(x, labels.copy(), cen.copy(), 150,
                                 np.random.RandomState(7))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    assert np.bincount(tl).max() <= 150 and len(tc) > 3
    # one probe a bucket and ~2 rows a bucket: most slots cannot be filled
    y, _ = _blobs(7, 300, 4)
    jn, jd = JA.approx_knn_graph(y, 15, n_buckets=150, nprobe=1, seed=1)
    tn, td = TA.approx_knn_graph(y, 15, n_buckets=150, nprobe=1, seed=1,
                                 device="cpu")
    assert (jd == JA.BIG).sum() > y.shape[0]
    np.testing.assert_array_equal(td == TA.BIG, jd == JA.BIG)
    np.testing.assert_array_equal(tn[td == TA.BIG], 0)
    assert TA.knn_recall(tn, jn, td) == JA.knn_recall(tn, jn, td)
    assert TA.BIG == JA.BIG and TA.FINITE == JA.FINITE


# ----------------------------------------------------------------- exact kNN

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_knn_graph_equals_jax_chunked_and_single(metric):
    x, _ = _blobs(8, 600, 10)
    jn, jd = JE.knn_graph(jnp.asarray(x), 12, metric, block=128)
    xs = x if metric == "euclidean" else \
        x / np.linalg.norm(x, axis=1, keepdims=True)
    for block in (128, 4096):
        tn, td = TE.knn_graph(x, 12, metric, block=block, device="cpu")
        # the same neighbour sets; in order but for float32 near-ties
        np.testing.assert_array_equal(np.sort(tn.numpy(), 1),
                                      np.sort(np.asarray(jn), 1))
        assert (tn.numpy() == np.asarray(jn)).mean() >= 0.999
        share, worst = _entries_agree(xs, tn.numpy(), td.numpy(),
                                      np.asarray(jn), np.asarray(jd))
        assert share == 1.0 and worst <= 1e-6, worst
    rows = torch.tensor([5, 17, 599])
    sn, sd = TE.knn_graph(x, 12, metric, block=2, rows=rows, device="cpu")
    np.testing.assert_array_equal(sn.numpy(), tn.numpy()[rows.numpy()])


def test_distance_products_ignore_the_tf32_flags():
    x, _ = _blobs(9, 400, 8)
    kept = torch.backends.cuda.matmul.fp32_precision
    try:
        want = (TE.knn_graph(x, 8, device="cpu")[0],
                TK.lloyd(_t(x), _t(x[:5]))[1])
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        got = (TE.knn_graph(x, 8, device="cpu")[0],
               TK.lloyd(_t(x), _t(x[:5]))[1])
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    finally:
        torch.backends.cuda.matmul.fp32_precision = kept
        torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------- layout

def _graph(n=300, seed=10):
    x, which = _blobs(seed, n, 8, centers=5, spread=0.6)
    nbr, dist = JE.knn_graph(jnp.asarray(x), 10)
    return x, which, np.asarray(nbr), np.asarray(dist)


def test_weights_and_core_distances_equal_jax():
    _, _, _, dist = _graph()
    dist = dist.copy()
    dist[3, 5:] = JA.BIG            # an approx row with unfilled slots
    np.testing.assert_allclose(TE._fuzzy_weights(_t(dist)).numpy(),
                               np.asarray(JE._fuzzy_weights(dist)),
                               atol=1e-6, rtol=0)
    for ms in (1, 5, 30):
        np.testing.assert_allclose(TE._core_distance(_t(dist), ms).numpy(),
                                   np.asarray(JE._core_distance(dist, ms)),
                                   atol=1e-6, rtol=0)


def test_layout_epochs_on_jax_draws():
    x, _, nbr, dist = _graph()
    n, n_neg, epochs = x.shape[0], 5, 10
    w = np.asarray(JE._fuzzy_weights(dist))
    y0 = (np.random.RandomState(11).randn(n, 2) * 0.1).astype(np.float32)
    zero = np.zeros_like(y0)
    keys = jax.random.split(jax.random.PRNGKey(12), epochs)
    jy = JE._layout_chunk((y0, zero, zero, jnp.float32(0.0)), keys, nbr, w,
                          n_neg=n_neg, lr=0.05)[0]
    negs = [_t(jax.random.randint(k, (n, n_neg), 0, n)).long() for k in keys]
    carry = (_t(y0), _t(zero), _t(zero), torch.zeros(()))
    ty = TE._layout_chunk(carry, negs, _t(nbr), _t(w), lr=0.05)
    np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy), atol=1e-4,
                               rtol=0)
    assert float(ty[3]) == epochs
    seg = TE._layout_chunk(carry, negs, _t(nbr), _t(w), lr=0.05, n_seg=3)
    for a, b in zip(seg, ty):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def _layout_args():
    x, _, nbr, dist = _graph(200, seed=13)
    w = TE._fuzzy_weights(_t(dist))
    y0 = torch.from_numpy(x[:, :2] * 0.05)
    return y0, _t(nbr), w


def test_layout_chunked_and_resumed_bit_for_bit(tmp_path, monkeypatch):
    y0, nbr, w = _layout_args()
    whole = TE._optimize_layout(y0, nbr, w, seed=1, n_epochs=12,
                                epoch_chunk=12)
    chunked = TE._optimize_layout(y0, nbr, w, seed=1, n_epochs=12,
                                  epoch_chunk=4)
    assert torch.equal(chunked, whole)

    def interrupted(seed):
        real, calls = TE._layout_chunk, []

        def dies(*args, **kwargs):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("lost the card")
            return real(*args, **kwargs)
        monkeypatch.setattr(TE, "_layout_chunk", dies)
        with pytest.raises(RuntimeError):
            TE._optimize_layout(y0, nbr, w, seed=seed, n_epochs=12,
                                epoch_chunk=4, checkpoint_dir=str(tmp_path),
                                checkpoint_every=4)
        monkeypatch.setattr(TE, "_layout_chunk", real)
        assert (tmp_path / "layout_carry.npz").exists()

    interrupted(1)
    resumed = TE._optimize_layout(y0, nbr, w, seed=1, n_epochs=12,
                                  epoch_chunk=4, checkpoint_dir=str(tmp_path),
                                  checkpoint_every=4, verbose=True)
    assert torch.equal(resumed, whole)
    assert not (tmp_path / "layout_carry.npz").exists()


def test_stale_checkpoint_is_not_resumed(tmp_path, monkeypatch):
    """ROADMAP C2: a checkpoint of other inputs (here another seed, then
    another y0) is ignored, and none is left after a completed run."""
    y0, nbr, w = _layout_args()
    real = TE._layout_chunk
    calls = []

    def dies(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("lost the card")
        return real(*args, **kwargs)

    monkeypatch.setattr(TE, "_layout_chunk", dies)
    with pytest.raises(RuntimeError):
        TE._optimize_layout(y0, nbr, w, seed=1, n_epochs=8, epoch_chunk=4,
                            checkpoint_dir=str(tmp_path), checkpoint_every=4)
    monkeypatch.setattr(TE, "_layout_chunk", real)
    ck = tmp_path / "layout_carry.npz"
    assert ck.exists()
    stale = ck.read_bytes()
    for y_start, seed in ((y0, 2), (y0 + 1e-3, 1)):
        fresh = TE._optimize_layout(y_start, nbr, w, seed=seed, n_epochs=8,
                                    epoch_chunk=4)
        got = TE._optimize_layout(y_start, nbr, w, seed=seed, n_epochs=8,
                                  epoch_chunk=4, checkpoint_dir=str(tmp_path),
                                  checkpoint_every=4)
        assert torch.equal(got, fresh)
        assert not ck.exists()
        ck.write_bytes(stale)


@pytest.mark.parametrize("n_edges", [1, 8_000_000, 8_000_001, 15_999_999,
                                     30_000_000, 2_097_152 * 15])
def test_no_segment_over_its_edge_cap(n_edges):
    """ROADMAP C3: the segment count rounds up (JAX's floor puts up to
    ~16M edges in one segment)."""
    seg = TE.layout_segments(n_edges)
    assert -(-n_edges // seg) <= TE.EDGES_A_SEGMENT
    assert seg == 1 or -(-n_edges // (seg - 1)) > TE.EDGES_A_SEGMENT


# ------------------------------------------------------- density clustering

def _two_densities():
    rng = np.random.RandomState(14)
    dense = rng.randn(240, 3) * 0.15 + np.array([0.0, 0.0, 0.0])
    dense2 = rng.randn(180, 3) * 0.15 + np.array([1.2, 0.0, 0.0])
    sparse = rng.randn(150, 3) * 0.8 + np.array([7.0, 5.0, 0.0])
    noise = rng.uniform(-6, 12, (30, 3))
    return np.concatenate([dense, dense2, sparse, noise]).astype(np.float32)


def test_density_and_hdbscan_equal_jax():
    x = _two_densities()
    for fn_j, fn_t in ((JE.density_cluster, TE.density_cluster),
                       (JE.hdbscan_cluster, TE.hdbscan_cluster)):
        want = fn_j(x, min_cluster_size=30, min_samples=8)
        got = fn_t(x, min_cluster_size=30, min_samples=8, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(want[want >= 0])) >= 2 and (want == -1).any()
    nbr, dist = TE.knn_graph(x, 16, device="cpu")
    np.testing.assert_array_equal(
        TE.hdbscan_cluster(x, 30, 8, precomputed_knn=(nbr, dist),
                           device="cpu"),
        JE.hdbscan_cluster(x, 30, 8))


def test_components_flow_both_ways():
    """A one-way edge joins its two points (JAX's rule)."""
    nbr = torch.tensor([[1], [1], [3], [2]])
    ok = torch.tensor([[True], [False], [False], [True]])
    lab = TE._connected_components(nbr, ok).numpy()
    want = np.asarray(JE._connected_components(jnp.asarray(nbr.numpy()),
                                               jnp.asarray(ok.numpy())))
    np.testing.assert_array_equal(lab, want)
    assert lab[0] == lab[1] and lab[2] == lab[3] and lab[0] != lab[2]


def test_neighbor_embedding_trustworthiness():
    x, _ = _blobs(15, 500, 16, centers=8, spread=1.0)
    want = JC.trustworthiness(x, JE.neighbor_embedding(x, 2, seed=0))
    got = TC.trustworthiness(x, TE.neighbor_embedding(x, 2, seed=0,
                                                      device="cpu"))
    pca = TC.trustworthiness(x, x @ np.linalg.svd(
        x - x.mean(0), full_matrices=False)[2][:2].T)
    assert abs(got - want) <= 0.02 and got > pca, (got, want, pca)
