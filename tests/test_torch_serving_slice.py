"""Port parity for the serving slice as a whole: rendered requests →
centroid crop → ``preprocess_eval_batch`` → BN-folded fusion forward (the
port with its fused-kernel serving path) → ``evaluate_test``, against the JAX
package on the same inputs and weights.  Plus the port's import hygiene: no
module of it pulls in JAX or a package the card's machine lacks."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.core import metrics as jmet
from multimodal_isic_tpu.data import augment as jaug
from multimodal_isic_tpu.data import crop as jcrop
from multimodal_isic_tpu.data import synthetic as jsyn
from multimodal_isic_tpu.models import fusion as jfu
from multimodal_isic_tpu.train import fusion as jtr
from multimodal_isic_tpu_torch.core import metrics as tmet
from multimodal_isic_tpu_torch.data import augment as taug
from multimodal_isic_tpu_torch.data import crop as tcrop
from multimodal_isic_tpu_torch.data import synthetic as tsyn
from multimodal_isic_tpu_torch.models import fusion as tfu
from multimodal_isic_tpu_torch.models.convert import flax_to_state_dict
from multimodal_isic_tpu_torch.train import fusion as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = "efficientnet-b0"
RAD_DIM = 20
N, BS, SRC_HW, OUT_HW = 12, 4, (48, 64), (32, 32)


def _requests(n, src_hw, seed=0):
    """Port-rendered requests (uint8 crops + metadata), checked against the
    JAX package's renderer and crop on the same seeds."""
    rng_t, rng_j = np.random.RandomState(seed), np.random.RandomState(seed)
    meta_rng = np.random.RandomState(seed + 1)
    crops = []
    for i in range(n):
        img, mask = tsyn._render_sample(rng_t, *src_hw, i % 7)
        img_j, mask_j = jsyn._render_sample(rng_j, *src_hw, i % 7)
        np.testing.assert_array_equal(img, img_j)
        np.testing.assert_array_equal(mask, mask_j)
        crop, _ = tcrop.centroid_crop(img, mask)
        np.testing.assert_array_equal(crop, jcrop.centroid_crop(img, mask)[0])
        crops.append(crop)
    return {
        "image": np.stack(crops),
        "radiomics": meta_rng.randn(n, RAD_DIM).astype(np.float32),
        "age": meta_rng.randn(n).astype(np.float32),
        "sex": meta_rng.randint(0, 3, n).astype(np.int32),
        "loc": meta_rng.randint(0, 15, n).astype(np.int32),
        "artifacts": meta_rng.randint(0, 2, (n, 6)).astype(np.int32),
        "target": (np.arange(n) % 7).astype(np.int32),
    }


def test_preprocess_matches_jax():
    imgs = _requests(4, (90, 120))["image"]
    assert imgs.shape == (4, 90, 90, 3) and imgs.dtype == np.uint8
    yj = np.asarray(jaug.preprocess_eval_batch(jnp.asarray(imgs), (76, 76)))
    yt = taug.preprocess_eval_batch(torch.from_numpy(imgs), (76, 76))
    assert yt.dtype == torch.float32 and yt.is_contiguous()
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-4, atol=1e-4)


def test_folded_serving_evaluate_test_matches_jax():
    reqs = _requests(N, SRC_HW)
    model = jfu.MultiModalFusionNet(radiomics_dim=RAD_DIM, backbone=BACKBONE)
    init_in = {k: jnp.asarray(v[:2]) for k, v in reqs.items()
               if k in jtr.BATCH_KEYS}
    init_in["image"] = jnp.zeros((2, *OUT_HW, 3), jnp.float32)
    vs = model.init(jax.random.PRNGKey(0), **init_in, train=False)
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.randn(*p.shape).astype(np.float32) * 0.05,
        vs["params"])
    stats = jax.tree_util.tree_map(
        lambda s: np.asarray(s) + np.abs(rng.randn(*s.shape)).astype(np.float32)
        * 0.1, vs["batch_stats"])

    # JAX: fold → folded model → eval step → evaluate_test
    jfolded = jfu.fold_fusion_params(params, stats, backbone=BACKBONE)
    jmodel = jfu.MultiModalFusionNet(radiomics_dim=RAD_DIM, backbone=BACKBONE,
                                     backbone_bn_folded=True)
    jbatches, jlogits = [], []
    for s in range(0, N, BS):
        b = {k: jnp.asarray(v[s:s + BS]) for k, v in reqs.items()}
        b["image"] = jaug.preprocess_eval_batch(b["image"], OUT_HW)
        jbatches.append(b)
    jstep = jtr.make_fusion_eval_step(jmodel)
    jloss = []
    for b in jbatches:
        loss, logits = jstep(jfolded, {}, b)
        jloss.append(float(loss))
        jlogits.append(np.asarray(logits))
    acc_j, report_j = jtr.evaluate_test(jstep, jfolded, {}, jbatches)

    # port: the same chain, with the fused-kernel serving path
    sd = tfu.fold_fusion_params(flax_to_state_dict(params, stats),
                                backbone=BACKBONE)
    tmodel = tfu.MultiModalFusionNet(radiomics_dim=RAD_DIM, backbone=BACKBONE,
                                     backbone_bn_folded=True,
                                     backbone_pallas_serving=True)
    tmodel.load_state_dict(sd)
    tbatches = []
    for s in range(0, N, BS):
        b = {k: torch.from_numpy(v[s:s + BS]).long() if v.dtype == np.int32
             else torch.from_numpy(v[s:s + BS]) for k, v in reqs.items()}
        b["image"] = taug.preprocess_eval_batch(b["image"], OUT_HW)
        tbatches.append(b)
    tstep = ttr.make_fusion_eval_step(tmodel)
    tout = [tstep(b) for b in tbatches]
    tlogits = [logits.numpy() for _, logits in tout]
    np.testing.assert_allclose([float(l) for l, _ in tout], jloss,
                               rtol=2e-4, atol=2e-4)
    logged = {}

    class Logger:
        def assign(self, k, v):
            logged[k] = v

        def print(self, msg):
            pass

    acc_t, report_t = ttr.evaluate_test(tstep, tbatches, logger=Logger())

    assert np.abs(np.concatenate(jlogits)).max() > 1e-2
    np.testing.assert_allclose(np.concatenate(tlogits),
                               np.concatenate(jlogits), rtol=2e-4, atol=2e-4)
    assert acc_t == acc_j
    assert report_t == report_j
    assert logged["test/accuracy"] == acc_t
    assert logged["test/classification_report"] == report_t


@pytest.mark.parametrize("n,num_classes,seed", [(50, 7, 0), (9, 7, 1),
                                                (40, 4, 2)])
def test_metrics_match_jax(n, num_classes, seed):
    """Metrics on predictions where some classes never occur (n=9 leaves
    classes out of y_true and y_pred)."""
    rng = np.random.RandomState(seed)
    y_true = rng.randint(0, num_classes, n).astype(np.int32)
    y_pred = np.where(rng.rand(n) < 0.5, y_true,
                      rng.randint(0, num_classes, n)).astype(np.int32)
    jt, jp = jnp.asarray(y_true), jnp.asarray(y_pred)
    np.testing.assert_array_equal(
        tmet.confusion_matrix(y_true, y_pred, num_classes),
        np.asarray(jmet.confusion_matrix(jt, jp, num_classes)))
    assert tmet.accuracy(y_true, y_pred) == pytest.approx(
        float(jmet.accuracy(jt, jp)), abs=1e-6)
    assert tmet.balanced_accuracy(y_true, y_pred, num_classes) == \
        pytest.approx(float(jmet.balanced_accuracy(jt, jp, num_classes)),
                      abs=1e-6)
    for average in ("macro", "weighted"):
        got = tmet.precision_recall_fscore(y_true, y_pred, num_classes,
                                           average)
        want = jmet.precision_recall_fscore(jt, jp, num_classes, average)
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(want[k], np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert (tmet.classification_report(y_true, y_pred)
            == jmet.classification_report(y_true, y_pred))


def test_port_imports_no_jax_or_missing_packages():
    """Every module of the port imports without jax, flax, the JAX package,
    cv2, pandas, yaml or triton (the card's machine has none of the first
    five, and triton is imported only inside a launch)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multimodal_isic_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in ('jax', 'flax', 'multimodal_isic_tpu', 'cv2', "
        "'pandas', 'yaml', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 12, names\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
