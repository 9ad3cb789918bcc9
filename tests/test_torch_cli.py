"""Port parity for the fusion classifier's CLI: the JAX package's
``cli.main`` checkpoint evaluated by the port, the port's ``prepare_df`` +
``main`` end to end on the CPU (metadata only and with the image modality at
small sizes), ``parse_config``'s device rule, the backbone's remat and
``entry()``."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from multimodal_isic_tpu.cli import main as jmain
from multimodal_isic_tpu.cli import prepare_df as jprep
from multimodal_isic_tpu.core import splits as jsplits
from multimodal_isic_tpu.data import pipeline as jpipe
from multimodal_isic_tpu.models import fusion as jfu
from multimodal_isic_tpu.train import fusion as jtr
from multimodal_isic_tpu.utils.logging import read_metrics as jread
from multimodal_isic_tpu_torch.cli import common as tcommon
from multimodal_isic_tpu_torch.cli import main as tmain
from multimodal_isic_tpu_torch.cli import prepare_df as tprep
from multimodal_isic_tpu_torch.core import checkpoint as tck
from multimodal_isic_tpu_torch.core.config import config_from_dict
from multimodal_isic_tpu_torch.core.rng import generator
from multimodal_isic_tpu_torch.data import augment as taug
from multimodal_isic_tpu_torch.data import pipeline as tpipe
from multimodal_isic_tpu_torch.data.synthetic import make_synthetic_isic
from multimodal_isic_tpu_torch.models import fusion as tfu
from multimodal_isic_tpu_torch.models.convert import read_checkpoint
from multimodal_isic_tpu_torch.models.convert import state_dict_from_checkpoint
from multimodal_isic_tpu_torch.train import fusion as ttr
from multimodal_isic_tpu_torch.utils.logging import read_metrics

META_MODS = ["radiomics", "clinical", "artifacts"]
SMALL_HW = (64, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """``tests/test_cli.py``'s metadata-only workspace (22 train and 8 test
    lesions of 64×80, seed 5), written by the port, with device 'cpu'."""
    root = tmp_path_factory.mktemp("torch_cli_ws")
    dirs = make_synthetic_isic(str(root / "data"), n_train=22, n_test=8,
                               image_hw=(64, 80), seed=5)
    config = {
        "neptune": False, "seed": 42, "device": "cpu", "dir": dirs,
        "model_path": str(root / "models"), "log_dir": str(root / "runs"),
        "pca": False, "num_classes": 7,
        "training_plan": {
            "modality": META_MODS, "fusion": "concat",
            "fusion_level": "intermediate",
            "parameters": {"patience": 3, "epochs": 2, "fold": 1,
                           "batch_size": 8},
        },
    }
    return root, config


def _write(root, name, config):
    path = root / f"{name}.yml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _variant(root, config, name, **params):
    """The workspace config with its own model and log dirs and
    ``params`` merged into its parameters."""
    cfg = json.loads(json.dumps(config))
    cfg["model_path"] = str(root / name / "models")
    cfg["log_dir"] = str(root / name / "runs")
    modality = params.pop("modality", None)
    if modality is not None:
        cfg["training_plan"]["modality"] = modality
    cfg["training_plan"]["parameters"].update(params)
    return cfg


def _only_dir(path):
    (name,) = os.listdir(path)
    return os.path.join(path, name)


def _capture(step, logits):
    def fn(batch):
        loss, out = step(batch)
        logits.append(out)
        return loss, out
    return fn


def test_jax_checkpoint_evaluated_by_the_port(workspace):
    """JAX's ``cli.main`` trains on the metadata-only workspace; its saved
    checkpoint, loaded into the port, gives JAX's test logits (rtol/atol
    1e-5), predictions and classification report on the port's test
    loader.  The port's ``main`` on the same workspace picks the same fold
    split and logs the same event and attribute names."""
    root, config = workspace
    cfg = _variant(root, config, "jax")
    path = _write(root, "jax", cfg)
    jprep.main(["--config_path", path])
    jmain.main(["--config_path", path])
    ckpt = _only_dir(cfg["model_path"])
    run_j = _only_dir(cfg["log_dir"])
    with open(os.path.join(run_j, "attributes.json")) as f:
        attrs_j = json.load(f)
    assert attrs_j["best_model_path"] == ckpt

    import pandas as pd
    df_test = pd.read_pickle(cfg["dir"]["df_test"])
    tree = read_checkpoint(ckpt)
    jmodel = jfu.MultiModalFusionNet(modality=META_MODS,
                                     fusion_strategy="concat")
    jstep = jtr.make_fusion_eval_step(jmodel)
    jloader = jpipe.DeviceLoader(jpipe.DermRecords(df_test, with_image=False),
                                 16)
    jlogits = np.concatenate([np.asarray(jstep(tree["params"],
                                               tree.get("batch_stats", {}), b)[1])
                              for b in jloader])

    model = tfu.MultiModalFusionNet(modality=META_MODS,
                                    fusion_strategy="concat",
                                    radiomics_dim=tpipe.RADIOMICS_PLACEHOLDER_DIM)
    model.load_state_dict(state_dict_from_checkpoint(ckpt))
    loader = tpipe.DeviceLoader(tpipe.DermRecords(df_test, with_image=False),
                                tmain.GLOBAL_BS, device="cpu")
    tlogits = []
    acc, report = ttr.evaluate_test(
        _capture(ttr.make_fusion_eval_step(model), tlogits), loader)
    tlogits = torch.cat(tlogits).numpy()
    assert np.abs(jlogits).max() > 1e-2
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tlogits.argmax(1), jlogits.argmax(1))
    assert acc == attrs_j["test/accuracy"]
    assert report == attrs_j["test/classification_report"]

    tcfg = _variant(root, config, "port_meta")
    result = tmain.main(["--config_path", _write(root, "port_meta", tcfg)])
    df = pd.read_pickle(cfg["dir"]["df"])
    train_j, val_j = list(jsplits.StratifiedKFold(
        10, shuffle=True, random_state=42).split(df, df["dx"]))[1]
    np.testing.assert_array_equal(result["train_idx"], train_j)
    np.testing.assert_array_equal(result["val_idx"], val_j)
    names = lambda events: sorted({e["name"] for e in events})
    assert names(read_metrics(result["run_dir"])) == names(jread(run_j))
    with open(os.path.join(result["run_dir"], "attributes.json")) as f:
        assert sorted(json.load(f)) == sorted(attrs_j)


def _small_policies(monkeypatch):
    # the CLI takes its policies from augment.fusion_policies at this size
    monkeypatch.setattr(tmain, "FUSED_EVAL_HW", SMALL_HW)


RUNS = {
    "metadata_only": {},
    "image_cached_fast_folded": dict(
        modality=["image", "clinical"], backbone="efficientnet-b0",
        device_cache=True, augment_fast=True, fold_bn_eval=True),
    "image_streaming_faithful": dict(
        modality=["image", "radiomics"], backbone="efficientnet-b0",
        backbone_remat="block", epochs=1),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_port_cli_end_to_end(name, workspace, monkeypatch):
    """The port's ``prepare_df`` + ``main`` on the CPU: metrics.jsonl with
    the JAX CLI's event names a epoch, finite losses, the best checkpoint,
    and a fresh model restored from it (BN folded where the run folds)
    gives the run's test logits bit for bit."""
    root, config = workspace
    _small_policies(monkeypatch)
    params = dict(RUNS[name])
    cfg = _variant(root, config, name, **params)
    path = _write(root, name, cfg)
    tprep.main(["--config_path", path])
    result = tmain.main(["--config_path", path])

    events = read_metrics(result["run_dir"])
    epochs = cfg["training_plan"]["parameters"]["epochs"]
    for key in ("train/epoch_loss", "train/epoch_acc", "val/epoch_loss",
                "val/epoch_acc", "val/patience_counter"):
        values = [e["value"] for e in events if e["name"] == key]
        assert len(values) == epochs and np.all(np.isfinite(values)), key
    assert result["logits"].shape == (8, 7)
    assert os.path.dirname(result["model_path"]) == cfg["model_path"]

    import pandas as pd
    df_test = pd.read_pickle(cfg["dir"]["df_test"])
    p = cfg["training_plan"]
    model_cfg = dict(modality=p["modality"], fusion_strategy=p["fusion"],
                     radiomics_dim=tpipe.RADIOMICS_PLACEHOLDER_DIM,
                     backbone=p["parameters"].get("backbone",
                                                  "efficientnet-b3"))
    restored = tck.restore_checkpoint(result["model_path"])
    if p["parameters"].get("fold_bn_eval"):
        model = tfu.MultiModalFusionNet(**model_cfg, backbone_bn_folded=True,
                                        backbone_pallas_serving=True)
        model.load_state_dict(tfu.fold_fusion_params(
            restored, backbone=model_cfg["backbone"]))
    else:
        model = tfu.MultiModalFusionNet(**model_cfg)
        model.load_state_dict(restored)
    with_image = "image" in p["modality"]
    loader = tpipe.DeviceLoader(
        tpipe.DermRecords(df_test, with_image=with_image), tmain.GLOBAL_BS,
        transform=(taug.fusion_policies(SMALL_HW)["fusion_eval"]
                   if with_image else None),
        device="cpu")
    step = ttr.make_fusion_eval_step(model)
    logits = torch.cat([step(b)[1] for b in loader])
    assert torch.equal(logits, result["logits"])


def test_port_cli_maxvit_one_epoch(workspace, monkeypatch):
    """``main`` with a MaxViT backbone (a tiny preset at 64²: widths 32
    and 64, window 4): the policies and the device-resident validation at
    the preset's own size, not EfficientNet's, one epoch, the checkpoint
    saved, and the test pass on the unfolded net although ``fold_bn_eval``
    asks for the folded one (MaxViT has none); a fresh net restored from
    the checkpoint gives the run's test logits bit for bit."""
    from multimodal_isic_tpu_torch.models import maxvit
    root, config = workspace
    monkeypatch.setitem(maxvit.PARAMS, "maxvit-tiny-test", maxvit.Preset(
        image_size=64, stem=16, widths=(32, 64), depths=(1, 1), window=4,
        head_dim=16))
    assert tmain.image_hw("maxvit-tiny-test") == SMALL_HW
    cfg = _variant(root, config, "maxvit", modality=["image", "clinical"],
                   backbone="maxvit-tiny-test", device_cache=True,
                   augment_fast=True, fold_bn_eval=True, epochs=1)
    path = _write(root, "maxvit", cfg)
    tprep.main(["--config_path", path])
    result = tmain.main(["--config_path", path])
    events = read_metrics(result["run_dir"])
    for key in ("train/epoch_loss", "val/epoch_loss"):
        values = [e["value"] for e in events if e["name"] == key]
        assert len(values) == 1 and np.isfinite(values[0]), key
    import pandas as pd
    model = tfu.MultiModalFusionNet(modality=["image", "clinical"],
                                    fusion_strategy="concat",
                                    radiomics_dim=tpipe.RADIOMICS_PLACEHOLDER_DIM,
                                    backbone="maxvit-tiny-test")
    model.load_state_dict(tck.restore_checkpoint(result["model_path"]))
    loader = tpipe.DeviceLoader(
        tpipe.DermRecords(pd.read_pickle(cfg["dir"]["df_test"])),
        tmain.GLOBAL_BS,
        transform=taug.fusion_policies(SMALL_HW)["fusion_eval"],
        device="cpu")
    step = ttr.make_fusion_eval_step(model)
    logits = torch.cat([step(b)[1] for b in loader])
    assert torch.equal(logits, result["logits"])


def test_parse_config_device_rule_and_tf32(workspace, monkeypatch):
    """'cpu' runs on the CPU; '', 'tpu', 'cuda' and 'cuda:N' ask for a card
    and raise without one; other keys are refused; the CLI switches TF32
    off; multi-process and multi-card runs are refused."""
    root, config = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = tcommon.parse_config(["--config_path", _write(root, "dev", config)])
    assert cfg["device"] == "cpu"
    assert tcommon.resolve_device("CPU") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    for key in ("", "tpu", "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcommon.resolve_device(key)
        bad = dict(config, device=key)
        with pytest.raises(RuntimeError, match="CUDA"):
            tcommon.parse_config(["--config_path", _write(root, "dev", bad)])
    for key in ("gpu", "cuda:x", "mps"):
        with pytest.raises(ValueError):
            tcommon.resolve_device(key)
    tcommon.check_single_process(cfg)
    for mesh in ({"data": 4}, {"model": 2}):
        with pytest.raises(ValueError, match="one card"):
            tcommon.check_single_process(config_from_dict({"mesh": mesh}))
    monkeypatch.setenv("ISIC_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="multi-process"):
        tmain.main(["--config_path", _write(root, "dev", config)])


def test_port_main_reads_the_reduced_radiomics(workspace):
    """With ``radiomics_red`` and ``radiomics_test_red`` on disk (the
    reduce_dim CLI's outputs, here 37 seeded columns) the port's ``main``
    builds the radiomics MLP at their width, not the 102-wide placeholder,
    and feeds their rows: a model restored from its checkpoint gives its
    test logits bit for bit on records built from the reduced test pickle
    (JAX ``cli/main.py:65-69,110``)."""
    import pandas as pd
    root, config = workspace
    cfg = _variant(root, config, "reduced")
    path = _write(root, "reduced", cfg)
    tprep.main(["--config_path", path])
    df_train = pd.read_pickle(cfg["dir"]["df"])
    df_test = pd.read_pickle(cfg["dir"]["df_test"])
    rng = np.random.RandomState(0)
    reduced = {}
    for key, n in (("radiomics_red", len(df_train)),
                   ("radiomics_test_red", len(df_test))):
        reduced[key] = pd.DataFrame(rng.randn(n, 37),
                                    columns=[f"f{i}_gs" for i in range(37)])
        cfg["dir"][key] = str(root / f"reduced_{key}.pkl")
        reduced[key].to_pickle(cfg["dir"][key])
    result = tmain.main(["--config_path", _write(root, "reduced", cfg)])
    state = tck.restore_checkpoint(result["model_path"])
    assert state["radiomics_mlp.fc1.weight"].shape == (256, 37)
    model = tfu.MultiModalFusionNet(modality=META_MODS,
                                    fusion_strategy="concat",
                                    radiomics_dim=37)
    model.load_state_dict(state)
    loader = tpipe.DeviceLoader(
        tpipe.DermRecords(df_test, radiomics=reduced["radiomics_test_red"]
                          .values, with_image=False),
        tmain.GLOBAL_BS, device="cpu")
    step = ttr.make_fusion_eval_step(model)
    assert torch.equal(torch.cat([step(b)[1] for b in loader]),
                       result["logits"])


def _remat_step(remat):
    model = ttr.build_fusion(generator(0, "cpu"), backbone="efficientnet-b0",
                             radiomics_dim=20, fusion_strategy="concat",
                             backbone_remat=remat)
    g = torch.Generator().manual_seed(1)
    batch = {"image": torch.rand(4, 64, 64, 3, generator=g) * 2 - 1,
             "radiomics": torch.randn(4, 20, generator=g),
             "age": torch.randn(4, generator=g),
             "sex": torch.randint(0, 3, (4,), generator=g),
             "loc": torch.randint(0, 15, (4,), generator=g),
             "artifacts": torch.randint(0, 2, (4, 6), generator=g),
             "target": torch.arange(4)}
    rng = generator(5, "cpu")
    logits = model(**ttr._inputs(batch), rng=rng)
    loss = ttr.cross_entropy(logits, batch["target"])
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return loss.detach(), grads, stats, rng.get_state(), model


@pytest.mark.parametrize("remat", ["conv", "block"])
def test_backbone_remat_matches_none(remat):
    """A train step of a B0 fusion net at 64² with drop-connect and dropout
    on: ``remat`` 'conv' and 'block' give 'none''s loss, gradients and
    BatchNorm running statistics (rtol 1e-6), leave the generator where
    'none' does and keep the state dict's keys."""
    base = _remat_step("none")
    got = _remat_step(remat)
    torch.testing.assert_close(got[0], base[0], rtol=1e-6, atol=0)
    assert got[1].keys() == base[1].keys()
    assert all(g is not None for g in got[1].values())
    for k in base[1]:
        torch.testing.assert_close(got[1][k], base[1][k], rtol=1e-6,
                                   atol=1e-9, msg=k)
    for k in base[2]:
        torch.testing.assert_close(got[2][k], base[2][k], rtol=1e-6, atol=0,
                                   msg=k)
    assert not torch.equal(base[2][k], torch.zeros_like(base[2][k]))
    assert torch.equal(got[3], base[3])
    assert got[4].state_dict().keys() == base[4].state_dict().keys()
    with pytest.raises(ValueError, match="remat"):
        tfu.MultiModalFusionNet(backbone_remat="all")


def test_entry_forward_on_cpu():
    """``entry()`` gives a forward over two uint8 450² requests → finite
    [2, 7] logits from the bf16 B3 fusion net in eval mode."""
    from multimodal_isic_tpu_torch.entry import entry
    forward, (model, inputs) = entry("cpu")
    assert not model.training
    assert inputs["image"].dtype == torch.uint8
    assert inputs["image"].shape == (2, 450, 450, 3)
    logits = forward(model, inputs)
    assert logits.shape == (2, 7) and bool(torch.isfinite(logits).all())
