"""Port parity for the ConvMAE and latent host side: ``restore_partial``,
``cli.train_ae`` (loader and ``device_cache`` paths, the epoch hook's
artifacts), ``cli.save_latent`` on a checkpoint the JAX ``cli.train_ae``
wrote, ``remat_blocks`` and ``DeviceLoader(drop_last)``, on the CPU with
the tiny ConvMAE (224² inputs).

Tolerances: latents from the same weights, float32 on both sides, within
rtol 1e-4 + atol 1e-4 (the same arithmetic in another order, as
``test_torch_latents.py``); everything else in the frames (columns, paths,
targets, patch ids, masks) exactly; remat against none bit for bit; the
loader epoch against the device-resident epoch bit for bit in the weights
and within 1e-6 relative in the losses (a float64 weighted mean against a
float32 mean of the same batch losses)."""

import json
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from multimodal_isic_tpu.cli import save_latent as jsave
from multimodal_isic_tpu.cli import train_ae as jtrain
from multimodal_isic_tpu.models import convmae as JM
from multimodal_isic_tpu.utils import viz as jviz
from multimodal_isic_tpu_torch.cli import prepare_df as tprep
from multimodal_isic_tpu_torch.cli import save_latent as tsave
from multimodal_isic_tpu_torch.cli import train_ae as ttrain
from multimodal_isic_tpu_torch.core import checkpoint as tck
from multimodal_isic_tpu_torch.core.rng import RngPool, generator
from multimodal_isic_tpu_torch.data import augment as taug
from multimodal_isic_tpu_torch.data import pipeline as tpipe
from multimodal_isic_tpu_torch.data.synthetic import make_synthetic_isic
from multimodal_isic_tpu_torch.models import convmae as T
from multimodal_isic_tpu_torch.models.convert import (convmae_state_dict,
                                                      read_checkpoint)
from multimodal_isic_tpu_torch.train import mae as tmae
from multimodal_isic_tpu_torch.utils import viz as tviz
from multimodal_isic_tpu_torch.utils.logging import read_metrics
from tests.test_torch_convmae import random_params

LATENT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, config):
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _variant(config, root, name, **params):
    cfg = json.loads(json.dumps(config))
    cfg["model_path"] = str(root / name / "models")
    cfg["log_dir"] = str(root / name / "runs")
    cfg["training_plan"]["parameters"].update(params)
    return cfg


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """``tests/test_cli.py``'s workspace (22 train and 8 test lesions of
    64×80, seed 5) with the tiny MAE at bs 8, mask 0.75, eval mask 0.5,
    written and prepared by the port, device 'cpu'."""
    root = tmp_path_factory.mktemp("torch_ae_ws")
    dirs = make_synthetic_isic(str(root / "data"), n_train=22, n_test=8,
                               image_hw=(64, 80), seed=5)
    config = {
        "seed": 42, "device": "cpu", "dir": dirs, "pca": False,
        "latent_dtype": "float32",
        "model_path": str(root / "models"), "log_dir": str(root / "runs"),
        "training_plan": {"parameters": {
            "epochs": 1, "fold": 1, "batch_size": 8, "model_size": "tiny",
            "norm_pix_loss": False, "masking_ratio": 0.75,
            "eval_masking_ratio": 0.5, "include_lesion_mask": False}},
    }
    tprep.main(["--config_path", _write(root / "prep.yml", config)])
    return root, config


def _only_hex_dir(path):
    (name,) = [d for d in os.listdir(path) if len(d) == 32]
    return os.path.join(path, name)


def _seeded_init(model, key):
    """JAX's ``init_mae`` stand-in: seeded parameters of ``init``'s shapes
    (``eval_shape``, no compile; ``tests/test_torch_convmae.py``)."""
    return random_params(model, model.img_size, seed=3)


class _JittedApply(JM.ConvMAE):
    """The JAX ConvMAE with ``apply`` jitted a (mask_ratio, method): the
    JAX CLI's epoch hook calls it op by op, about 25 s of one-op compiles
    on the CPU; jitted, the same program compiles once."""

    def apply(self, variables, *args, **kwargs):
        static = {k: kwargs.pop(k) for k in ("mask_ratio", "method")
                  if k in kwargs}
        key = (id(self), tuple(sorted(static.items(), key=str)))
        fn = _APPLY_CACHE.get(key)
        if fn is None:
            fn = _APPLY_CACHE[key] = jax.jit(
                lambda v, a, kw: _JAX_CONVMAE.apply(self, v, *a, **static,
                                                    **kw))
        return fn(variables, args, kwargs)


_JAX_CONVMAE = JM.ConvMAE
_APPLY_CACHE = {}


def _record_plots(mp, module):
    """Replace ``module``'s two plotting functions with recorders that
    write an empty file under the path asked for (drawing costs matplotlib
    about a second a figure; the names are what the tests compare)."""
    def record(*args, **kwargs):
        path = kwargs.get("out_path") or next(a for a in args
                                              if isinstance(a, str))
        open(path, "w").close()
        return path
    mp.setattr(module, "latent_scatter", record)
    mp.setattr(module, "reconstruction_grid", record)


@pytest.fixture(scope="module")
def jax_run(workspace):
    """JAX's ``cli.train_ae`` (tiny, 1 epoch) → its checkpoints and run
    artifacts; JAX's and the port's ``save_latent`` (float32) on its best
    checkpoint → both sets of six frames.  The JAX CLIs' init is seeded
    (:func:`_seeded_init`), their forward jitted (:class:`_JittedApply`),
    and the hook's plots recorded, not drawn (:func:`_record_plots`)."""
    root, config = workspace
    cfg = _variant(config, root, "jax", **{"device_cache": False})
    cfg["device"] = "tpu"
    path = _write(root / "jax.yml", cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "ConvMAE", _JittedApply)
        mp.setattr(jtrain, "init_mae", _seeded_init)
        mp.setattr(jsave, "init_mae", _seeded_init)
        _record_plots(mp, jviz)
        jtrain.main(["--config_path", path])
        best = _only_hex_dir(cfg["model_path"])
        (run,) = os.listdir(cfg["log_dir"])
        artifacts = sorted(os.listdir(os.path.join(cfg["log_dir"], run,
                                                   "artifacts")))
        mp.chdir(root)
        jsave.main(["--config_path", path, "--model_name", best])
        jframes = [pd.read_pickle(root / "dataframes_latents" / f"{n}.pkl")
                   for n in tsave.FRAME_NAMES]
        tframes = tsave.main(["--config_path",
                              _write(root / "port_sl.yml", config),
                              "--model_name", best])
        for n in tsave.FRAME_NAMES:  # the port's pickles replaced JAX's
            assert (root / "dataframes_latents" / f"{n}.pkl").exists()
    _APPLY_CACHE.clear()
    return cfg, best, artifacts, jframes, tframes


def test_save_latent_reads_the_jax_train_ae_checkpoint(jax_run):
    """Weights carried across end to end: JAX's train_ae checkpoint read by
    both packages' save_latent gives the same six frames."""
    _, _, _, jframes, tframes = jax_run
    assert len(tframes) == 6
    exact = ("image_path", "segmentation_path", "target", "patch_id",
             "patch_in_mask", "ids_restore", "lesion_mask_patches")
    latent = ("patch_latent", "patch_latent_pca", "latent_pooled_max",
              "latent_pooled_mean", "latent")
    for name, j, t in zip(tsave.FRAME_NAMES, jframes, tframes):
        assert list(t.columns) == list(j.columns), name
        assert len(t) == len(j) and len(j) > 0, name
        for col in j.columns:
            got, want = np.stack(t[col].values), np.stack(j[col].values)
            if col in exact:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{name}.{col}")
            else:
                assert col in latent, col
                np.testing.assert_allclose(got, want, **LATENT_TOL,
                                           err_msg=f"{name}.{col}")
    raw = tframes[4]
    assert np.stack(raw["latent"].values).shape == (len(raw), 196, 64)


def test_restore_partial_reads_both_packages(jax_run, tmp_path):
    """A JAX ``train_ae`` best checkpoint (bare params) and its resumable
    TrainState (the ``params/`` alias) restore the full tiny model; the
    encoder-only model takes its tensors and ignores the decoder's; a port
    checkpoint (and a port train state's ``model.`` keys) restores too;
    ``strict`` raises on a missing key, and 0 matches raise either way."""
    cfg, best, *_ = jax_run
    want = convmae_state_dict(read_checkpoint(best))
    full = T.ConvMAE(**ttrain.TINY)
    got = tck.restore_partial(best, full.state_dict(), strict=True)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    ckpt_dir = os.path.join(cfg["model_path"], "mae_ckpt")
    (step,) = os.listdir(ckpt_dir)
    state = tck.restore_partial(os.path.join(ckpt_dir, step),
                                full.state_dict(), strict=True)
    assert all(torch.equal(state[k], v) for k, v in want.items())

    enc = T.ConvMAE(**ttrain.TINY, with_decoder=False)
    enc_sd = tck.restore_partial(best, enc.state_dict(), strict=True)
    assert "mask_token" not in enc_sd and len(enc_sd) < len(want)
    assert all(torch.equal(v, want[k]) for k, v in enc_sd.items())

    port_dir = tck.save_checkpoint(str(tmp_path / "port"), got)
    again = tck.restore_partial(port_dir, enc.state_dict(), strict=True)
    assert all(torch.equal(v, want[k]) for k, v in again.items())
    full.load_state_dict(got)
    opt = tmae.mae_optimizer(full)
    train_state = tck.save_train_state(str(tmp_path / "ts"), full, opt, 0)
    from_ts = tck.restore_partial(train_state, full.state_dict(), strict=True)
    assert all(torch.equal(v, want[k]) for k, v in from_ts.items())

    wider = T.ConvMAE(**{**ttrain.TINY, "decoder_dim": 48})
    partial = tck.restore_partial(best, wider.state_dict())
    assert torch.equal(partial["patch_embed1.proj.weight"],
                       want["patch_embed1.proj.weight"])
    assert torch.equal(partial["decoder_embed.weight"],
                       wider.state_dict()["decoder_embed.weight"])
    with pytest.raises(KeyError, match="missing"):
        tck.restore_partial(best, wider.state_dict(), strict=True)
    with pytest.raises(ValueError, match="matched 0"):
        tck.restore_partial(best, {"nothing.weight": torch.zeros(3)})


@pytest.mark.parametrize("device_cache", [False, True])
def test_port_train_ae_runs_both_paths(device_cache, workspace, jax_run):
    """The port's ``cli.train_ae`` (tiny, 2 epochs): the uuid checkpoint,
    ``mae_ckpt/``, finite losses, the metrics events, and the hook's
    artifacts named as JAX names them (its epoch 0, here also epoch 1, the
    last); restoring ``mae_ckpt/`` gives the saved validation loss.  The
    plots are recorded, not drawn (``test_viz_draws_pngs`` draws them)."""
    root, config = workspace
    _, _, jax_artifacts, *_ = jax_run
    name = f"port_{'cached' if device_cache else 'loader'}"
    cfg = _variant(config, root, name, epochs=2, device_cache=device_cache)
    with pytest.MonkeyPatch.context() as mp:
        _record_plots(mp, tviz)
        result = ttrain.main(["--config_path",
                              _write(root / f"{name}.yml", cfg)])
    models = os.listdir(cfg["model_path"])
    assert "mae_ckpt" in models
    assert result["model_path"] == _only_hex_dir(cfg["model_path"])
    losses = [v for h in result["history"]
              for v in (h["train_loss"], h["val_loss"])]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    events = {e["name"] for e in read_metrics(result["run_dir"])}
    assert events == {"train/loss", "val/loss"}
    artifacts = sorted(os.listdir(os.path.join(result["run_dir"],
                                               "artifacts")))
    assert artifacts == sorted(jax_artifacts + [a.replace("ep0", "ep1")
                                                for a in jax_artifacts])
    with np.load(os.path.join(result["run_dir"], "artifacts",
                              "latent_moments_ep1.npz")) as z:
        assert z["feats"].shape == (len(result["val_idx"]), 6 * 64)
        assert np.isfinite(z["feats"]).all()
    best = tck.restore_checkpoint(result["model_path"])
    meta = tck.read_metadata(result["model_path"])
    assert meta["val_loss"] == result["best_val_loss"]
    model = T.ConvMAE(**ttrain.TINY)
    tmeta = tck.restore_train_state(result["checkpoint"], model)
    assert tmeta["val_loss"] == result["best_val_loss"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k


def test_viz_draws_pngs(tmp_path):
    """The hook's two plots as PNG files: the latent scatter of 12 seeded
    6·64-wide moments in 3 classes and a reconstruction grid of a 224²
    image with half its 196 patches masked."""
    rng = np.random.RandomState(0)
    scatter = tviz.latent_scatter(rng.randn(12, 384), np.arange(12) % 3,
                                  str(tmp_path / "scatter.png"), seed=0)
    grid = tviz.reconstruction_grid(
        rng.randn(224, 224, 3).astype(np.float32),
        rng.randn(196, 768).astype(np.float32), np.arange(196) % 2,
        str(tmp_path / "grid.png"), norm_pix_loss=True)
    for path in (scatter, grid):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


class _OneGenerator:
    """An ``rng_stream`` that hands out one generator every time: the
    loader then draws each batch's augmentation from it in step order, as
    the device-resident epoch does."""

    def __init__(self, gen):
        self.gen = gen

    def next(self):
        return self.gen


def test_loader_epoch_equals_device_resident_epoch(workspace):
    """``train_mae``'s loader path and its device-resident path on the same
    order, augmentation and masking generators: the same weights bit for
    bit, the same losses."""
    root, config = workspace
    df = pd.read_pickle(config["dir"]["df"])
    records = tpipe.DermRecords(df.iloc[:20])
    val = tpipe.DermRecords(df.iloc[20:])
    order = np.random.RandomState(3).permutation(20)
    runs = []
    for loader_path in (True, False):
        model = T.build_convmae(generator(7, "cpu"), **ttrain.TINY)
        opt = tmae.mae_optimizer(model)
        pool = RngPool(0, "cpu")
        aug = pool["augment"].at(0)
        kwargs = dict(mask_ratio=0.75, eval_mask_ratio=0.5)
        if loader_path:
            kwargs["train_batches"] = lambda epoch: tpipe.DeviceLoader(
                records, 8, order=order, transform=taug.POLICIES["mae_train"],
                rng_stream=_OneGenerator(aug), device="cpu", drop_last=True)
            kwargs["val_batches"] = lambda: tpipe.DeviceLoader(
                val, 64, transform=taug.POLICIES["mae_eval"], device="cpu")
        else:
            train_ds = tpipe.DeviceDataset.from_records(records, device="cpu")
            val_ds = tpipe.DeviceDataset.from_records(val, device="cpu")
            train_ep = tmae.make_mae_train_epoch(
                model, opt, 0.75, False, taug.POLICIES["mae_train"])
            val_ep = tmae.make_mae_eval_epoch(model, 0.5,
                                              taug.POLICIES["mae_eval"])
            kwargs["fused_train"] = lambda e, a, m: train_ep(
                train_ds.images, train_ds.masks,
                train_ds.epoch_order(8, order=order), a, m)
            kwargs["fused_val"] = lambda g: val_ep(
                val_ds.images, val_ds.masks, np.arange(2)[None], g)
        out = tmae.train_mae(model, opt, num_epochs=1, rng=pool, **kwargs)
        runs.append((out["history"][0], model.state_dict()))
    (h_loader, w_loader), (h_fused, w_fused) = runs
    for k, v in w_loader.items():
        assert torch.equal(v, w_fused[k]), k
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(h_loader[key], h_fused[key], rtol=1e-6)
    with pytest.raises(ValueError, match="one of"):
        tmae.train_mae(model, opt, num_epochs=1, rng=RngPool(0, "cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_blocks_equal_none(dtype):
    """Every conv, ViT and decoder block recomputed in the backward pass:
    the loss and every gradient equal the run that keeps activations."""
    imgs = torch.randn(2, 224, 224, 3, generator=generator(1, "cpu"))
    draws = None
    results = []
    for remat in (False, True):
        model = T.build_convmae(generator(4, "cpu"), **ttrain.TINY,
                                dtype=dtype, norm_pix_loss=True,
                                remat_blocks=remat)
        if draws is None:
            draws = model.masking(2, 0.75, generator(2, "cpu"))
        loss, _, _ = model(imgs, masking=draws)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                        model.named_parameters()}))
    (loss0, g0), (loss1, g1) = results
    assert torch.equal(loss0, loss1)
    for k, v in g0.items():
        assert torch.equal(v, g1[k]), k


def test_device_loader_drop_last(workspace):
    root, config = workspace
    df = pd.read_pickle(config["dir"]["df"]).iloc[:11]
    records = tpipe.DermRecords(df, with_image=False)
    order = np.arange(11)[::-1]
    kept = tpipe.DeviceLoader(records, 4, order=order, device="cpu",
                              drop_last=True)
    full = tpipe.DeviceLoader(records, 4, order=order, device="cpu")
    assert (len(kept), len(full)) == (2, 3)
    got = [b["target"] for b in kept]
    want = [b["target"] for b in full]
    assert [len(t) for t in got] == [4, 4] and \
        [len(t) for t in want] == [4, 4, 3]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        torch.cat(got).numpy(), df["dx"].values[order[:8]].astype(int))
