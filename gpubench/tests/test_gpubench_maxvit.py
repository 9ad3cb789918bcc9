"""The benchmark's MaxViT-B cell on the CPU: it resolves its files by
name; the builder's port side against ``reference/maxvit_fusion.py`` at a
small configuration, with the planted faults and the float8 control out of
its limits; ``forward_flops`` against a count of the module's own
products; the readers of spans that record many times a step and the
rooflines of the fused LN-MLP calls."""

import copy
import itertools
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT

from gpubench import common, harness, readers
from gpubench.calibrate import half_batch
from gpubench.tasks import train_numbers

from multimodal_isic_tpu_torch.models import maxvit
from multimodal_isic_tpu_torch.utils import trace

TRAIN = "maxvit_base_fusion.train_bs16"
SEED = 2 ** 31 + 13
TINY = dict(backbone="maxvit-tiny-test", image_size=64, stem=16,
            widths=[32, 384], depths=[1, 1], window=4, head_dim=16,
            radiomics_dim=20)


@pytest.fixture
def tiny_maxvit(monkeypatch):
    """The MaxViT cell's files at a CPU size: a preset of widths 32 and
    384 (stage 2 on the fused MLP's plain version) at 64², batches of 4
    from a pool of 11 crops of 40²."""
    monkeypatch.setitem(maxvit.PARAMS, TINY["backbone"], maxvit.Preset(
        image_size=64, stem=16, widths=(32, 384), depths=(1, 1), window=4,
        head_dim=16))
    r = copy.deepcopy(common.resolve(TRAIN))
    r["config"].update(TINY)
    r["traffic"].update(batch=4, pool=11, crop_hw=[40, 40], order_epochs=2)
    torch.manual_seed(0)
    return r


def test_new_cell_resolves():
    """As ``test_cell_resolves``: files, task, driver, metrics and limits."""
    r = common.resolve(TRAIN)
    builder = common.builder(r["builder"])
    assert r["traffic"]["task"] in builder.TASKS
    assert hasattr(common.driver(r["driver"]), "run")
    names = {m["name"] for m in r["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert r["per_layer"]
    for m in r["per_layer"]:
        assert callable(common.metric_reader(m["name"]).read)
    assert set(r["limits"]) and all(v["limit"] > 0
                                    for v in r["limits"].values())


def _run(r, fault=None):
    return harness.run_cell(TRAIN, SEED, 0.3, False, time.perf_counter(),
                            device="cpu", resolved=r, fault=fault)


def state_unchanged(task):
    task.optimizer.step = lambda *a, **k: None


@pytest.mark.parametrize("fault", [None, state_unchanged, half_batch])
def test_train_cell_on_the_cpu(tiny_maxvit, fault):
    """The sound run is correct; a step that leaves the state unchanged
    and a step on half the batch are not."""
    out = _run(tiny_maxvit, fault)
    assert out["correct"] == (fault is None), out["checks"]


def test_fp8_control_breaks_the_limits(tiny_maxvit):
    """The reference with float8 operands in the program's place fails the
    cell's limits (TF32, the cell's control, is a tensor-core precision
    and changes nothing on the CPU; the card's test is below)."""
    r = tiny_maxvit
    task = common.builder(r["builder"]).make("train", r["config"],
                                             r["traffic"], SEED, "cpu")
    task.release()
    n = r["traffic"]["compare_steps"]
    numbers = train_numbers(task.reference_steps(n, "fp8"),
                            task.reference_steps(n))
    assert any(v > r["limits"][k]["limit"] for k, v in numbers.items()), numbers


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card():
    """The cell's control at its full widths, a batch of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 is a tensor-core precision")
    r = common.resolve(TRAIN)
    r["traffic"].update(batch=8, pool=64)
    task = common.builder(r["builder"]).make("train", r["config"],
                                             r["traffic"], SEED,
                                             torch.device("cuda:0"))
    task.release()
    numbers = common.driver(r["driver"]).control(task, {}, "cuda:0")
    assert any(v > r["limits"][k]["limit"] for k, v in numbers.items()), numbers


def test_forward_flops_counts_the_module():
    """``forward_flops`` at MaxViT-B's 384² equals the products the fusion
    net runs, as ``FlopCounterMode`` counts them on the meta device (the
    MLPs on plain ops, which the counter sees; the kernel computes the
    same products)."""
    from multimodal_isic_tpu_torch.models.fusion import MultiModalFusionNet
    r = common.resolve(TRAIN)
    cfg = r["config"]
    with torch.device("meta"):
        net = MultiModalFusionNet(fusion_strategy="concat",
                                  backbone=cfg["backbone"]).eval()
    for m in net.modules():
        if isinstance(m, maxvit.Mlp):
            m.use_fused_mlp = False
    meta = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,
                                                   device="meta")
    inputs = dict(image=meta(1, 384, 384, 3), radiomics=meta(1, 780),
                  age=meta(1), sex=meta(1, dt=torch.long),
                  loc=meta(1, dt=torch.long),
                  artifacts=meta(1, 6, dt=torch.long))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(**inputs)
    builder = common.builder(r["builder"])
    assert builder.forward_flops(cfg, r["traffic"]) == \
        counter.get_total_flops()
    # the paper's ~74 G multiply-adds at 384²
    assert 72e9 < builder.forward_flops(cfg, r["traffic"]) / 2 < 76e9


IDS = itertools.count(1)


def made(name, unit, device_ms):
    i = next(IDS)
    r = trace.Record(name, i, unit, unit, 10 ** 9, 0)
    r.end_ns = r.start_ns + 1000
    r.device_ms = device_ms
    return r


SPAN_METRICS = {"maxvit_mbconv_ms.train": "maxvit.mbconv",
                "block_attn_ms.train": "maxvit.block_attn",
                "grid_attn_ms.train": "maxvit.grid_attn"}


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_unit_readers_sum_a_step_and_mean_the_steps(metric, monkeypatch):
    """Three records a unit: a unit's sum, the mean over the first
    ``units`` units; other spans and later units left out; None without
    records, without a segment and without stream times."""
    name = SPAN_METRICS[metric]
    recs = [made(name, 1, 1.0), made("other", 1, 50.0), made(name, 1, 2.0),
            made(name, 1, 3.0), made(name, 7, 4.0), made(name, 7, 4.0),
            made(name, 7, 4.0), made(name, 9, 100.0)]
    monkeypatch.setattr(trace, "spans", lambda: list(recs))
    reader = common.metric_reader(metric)
    assert reader.read({"segment": {"units": 2}}) == pytest.approx(9.0)
    assert reader.read({"segment": {"units": 1}}) == pytest.approx(6.0)
    assert reader.read({"segment": None}) is None
    monkeypatch.setattr(trace, "spans", lambda: [made("other", 1, 1.0)])
    assert reader.read({"segment": {"units": 2}}) is None
    monkeypatch.setattr(trace, "spans", lambda: [made(name, 1, None)])
    assert reader.read({"segment": {"units": 2}}) is None


# the f32 bound of one stage-3 call at batch 16 (M = 16·24², C 384, F 1536),
# operations-bound at 67 TFLOP/s (67e9 operations a ms): B9's 4·M·C·F,
# B10's 10·M·C·F
LN_MLP_CALL_MS = {"maxvit_ln_mlp_roofline": 4 * 9216 * 384 * 1536 / 67e9,
                  "maxvit_ln_mlp_bwd_roofline": 10 * 9216 * 384 * 1536 / 67e9}


@pytest.mark.parametrize("metric", sorted(LN_MLP_CALL_MS))
def test_ln_mlp_rooflines_bound_the_stage3_calls(metric, monkeypatch):
    """The fused LN-MLP runs MaxViT-B's 28 stage-3 MLPs a step, and the
    readers' bound is theirs over the kernels' device time; no launch
    reads None."""
    r = common.resolve(TRAIN)
    builder = common.builder(r["builder"])
    assert builder.ln_mlp_calls(r["config"], 16) == [(16, 24, 384, 28)]
    ctx = dict(config=r["config"], traffic=r["traffic"], builder=builder,
               segment={"units": 4})
    monkeypatch.setattr(readers.trace, "kernel_seconds",
                        lambda seg, pattern: (2.0, 28 * 4))
    got = common.metric_reader(metric).read(ctx)
    want = 100 * 28 * LN_MLP_CALL_MS[metric] * 1e-3 * 4 / 2.0
    assert got == pytest.approx(want, rel=1e-2)
    monkeypatch.setattr(readers.trace, "kernel_seconds",
                        lambda seg, pattern: (0.0, 0))
    assert common.metric_reader(metric).read(ctx) is None


def test_config_file_holds_the_published_widths():
    """The widths, depths and stochastic-depth rate the reference reads
    from the file are the port's preset's."""
    cfg = json.loads((ROOT / "gpubench/configs/maxvit_base_fusion.json")
                     .read_text())
    preset = maxvit.PARAMS[cfg["backbone"]]
    assert cfg["reduced"] == []
    assert (cfg["image_size"], cfg["stem"], tuple(cfg["widths"]),
            tuple(cfg["depths"]), cfg["window"], cfg["head_dim"],
            cfg["expansion"], cfg["se_ratio"], cfg["mlp_ratio"],
            cfg["drop_path_rate"]) == \
        (preset.image_size, preset.stem, preset.widths, preset.depths,
         preset.window, preset.head_dim, preset.expansion, preset.se_ratio,
         preset.mlp_ratio, preset.drop_path_rate)
