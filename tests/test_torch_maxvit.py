"""MaxViT as the fusion classifier's image branch, against the plain
reference ``tests/maxvit_reference.py`` on seeded weights at a tiny size:
the backbone's features and the fusion logits in eval and train mode, every
leaf's gradient, one SGD step through ``make_fusion_train_step``; the
block and grid partitions, the relative-position index, the fused-MLP gate
at MaxViT-B's widths, the spans and counters, the refusals of the
BN-folded path and the flax conversion, and the checkpoint round trip.

The tiny preset (64², stem 16, widths 32 and 384, one block a stage,
window 4, head dim 16) keeps stage 2 at C = 384, F = 1536, so its MLPs run
on ``fused_ln_mlp`` (its plain version on the CPU) and its block, the
second, under stochastic depth: the kernel path's ``(x + m) − x`` branch is
held to the reference too."""

import math

import numpy as np
import pytest
import torch

import maxvit_reference as ref
from multimodal_isic_tpu_torch.core import checkpoint as tck
from multimodal_isic_tpu_torch.core.rng import generator
from multimodal_isic_tpu_torch.models import convert, fusion, maxvit
from multimodal_isic_tpu_torch.models.maxvit import (
    Preset, block_partition, block_unpartition, grid_partition,
    grid_unpartition, relative_index, relpos_attention)
from multimodal_isic_tpu_torch.train import fusion as ttr
from multimodal_isic_tpu_torch.utils import trace

TINY = "maxvit-tiny-test"
PRESET = Preset(image_size=64, stem=16, widths=(32, 384), depths=(1, 1),
                window=4, head_dim=16)
ARCH = dict(stem=16, widths=(32, 384), depths=(1, 1), window=4, head_dim=16)
RAD_DIM, B = 20, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tiny_preset(monkeypatch):
    monkeypatch.setitem(maxvit.PARAMS, TINY, PRESET)


def net(**kw):
    return fusion.MultiModalFusionNet(fusion_strategy="concat",
                                      radiomics_dim=RAD_DIM, backbone=TINY,
                                      **kw)


def seeded_state(model, seed=0):
    """Every tensor of the state dict from one generator: matrices and
    kernels normal with std 1/sqrt(fan_in), the relative-position tables
    std 0.5 (so the bias moves the softmax), norm scales uniform 0.8-1.2,
    running variances 0.5-1.5, running means and biases small normals."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith("rel_bias"):
            t = 0.5 * torch.randn(v.shape, generator=g)
        elif v.dim() >= 2:
            t = torch.randn(v.shape, generator=g) / math.sqrt(v[0].numel())
        elif k.endswith("running_var"):
            t = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("weight") and "emb" not in k:  # norm scales
            t = 0.8 + 0.4 * torch.rand(v.shape, generator=g)
        else:
            t = 0.1 * torch.randn(v.shape, generator=g)
        out[k] = t.to(v.dtype)
    return out


def batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"image": torch.randn(B, 64, 64, 3, generator=g),
            "radiomics": torch.randn(B, RAD_DIM, generator=g),
            "age": torch.randn(B, generator=g),
            "sex": torch.randint(0, 3, (B,), generator=g),
            "loc": torch.randint(0, 15, (B,), generator=g),
            "artifacts": torch.randint(0, 2, (B, 6), generator=g),
            "target": torch.randint(0, 7, (B,), generator=g)}


def port_and_state(seed=0):
    model = net()
    state = seeded_state(model, seed)
    model.load_state_dict(state)
    return model, state


def inputs(b):
    return {k: b[k] for k in ttr.BATCH_KEYS}


# Float32 on both sides in another order of operations: SDPA against an
# explicit softmax, the fused MLP's E[x²] − mean² LayerNorm against
# F.layer_norm, reshapes against index gathers.  Features and logits are
# O(1); the observed gap is 2.4e-7, so 1e-4 leaves two orders of room and
# still fails on any missing term (a dropped bias or branch moves O(0.1)).
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
# A leaf's gradient by relative Frobenius error: the same sums in another
# order, through BatchNorm's backward over 4-256 rows; the worst leaf
# observed reads 1.3e-5 (a stage-1 BatchNorm scale), a wrong or missing path
# reads O(1).
GRAD_TOL = 1e-4


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_reference(train):
    model, state = port_and_state()
    model.train(train)
    b = batch()
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    with torch.no_grad():
        feats = model.image_model(b["image"], g1 if train else None)
        want = ref.backbone(state, ARCH, b["image"], train, g2)
        logits = model(**inputs(b), rng=g1 if train else None)
        want_logits = ref.fusion_logits(state, ARCH, b, train, g2)
    torch.testing.assert_close(feats, want, **FWD_TOL)
    torch.testing.assert_close(logits, want_logits, **FWD_TOL)
    # the generators moved alike: both drew the same number of values
    assert torch.equal(g1.get_state(), g2.get_state())


def _rel_fro(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_every_gradient_matches_reference():
    model, state = port_and_state()
    model.train()
    b = batch()
    loss = torch.nn.functional.cross_entropy(
        model(**inputs(b), rng=torch.Generator().manual_seed(4)), b["target"])
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in state.items()
         if not k.endswith(("running_mean", "running_var"))}
    want = ref.loss({**state, **p}, ARCH, b, True,
                    torch.Generator().manual_seed(4))
    torch.testing.assert_close(loss.detach(), want.detach(), **FWD_TOL)
    grads = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    # a pre-norm BatchNorm's shift feeds a bias-free conv and a train-mode
    # BatchNorm, which subtracts it again: its gradient is zero, computed
    # as rounding noise on both sides; such leaves are held absolutely
    med = torch.stack([g.norm() for g in grads.values()]).median()
    for k, g in grads.items():
        if g.norm() < 1e-3 * med:
            assert named[k].grad.norm() < 1e-3 * med, k
        else:
            assert _rel_fro(named[k].grad, g) < GRAD_TOL, \
                (k, _rel_fro(named[k].grad, g))


def test_sgd_step_matches_reference():
    """One step of ``make_fusion_train_step`` (SGD lr 1e-3, wd 1e-4)
    against the reference's gradient and the update written out: each
    leaf after the step within ``GRAD_TOL`` of the reference's change."""
    model, state = port_and_state()
    model.train()
    opt = ttr.fusion_optimizer(model, lr=1e-3, weight_decay=1e-4)
    step = ttr.make_fusion_train_step(model, opt)
    b = batch(2)
    loss, _ = step(b, torch.Generator().manual_seed(5))
    p = {k: v.clone().requires_grad_(True) for k, v in state.items()
         if not k.endswith(("running_mean", "running_var"))}
    want = ref.loss({**state, **p}, ARCH, b, True,
                    torch.Generator().manual_seed(5))
    torch.testing.assert_close(loss, want.detach(), **FWD_TOL)
    grads = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    for k, v in model.named_parameters():
        p0 = state[k].double()
        want_change = -1e-3 * (grads[k].double() + 1e-4 * p0)
        # the update's own rounding to float32 (half an ulp of each
        # parameter) beside GRAD_TOL of the change
        err = (v.detach().double() - (p0 + want_change)).norm()
        assert err <= GRAD_TOL * want_change.norm() + 2 ** -24 * p0.norm(), k


@pytest.mark.parametrize("grid", [False, True])
def test_partitions_round_trip_and_group_tokens(grid):
    """Each partition is undone exactly, and its groups hold the tokens the
    reference's index gathers name: a p×p window, or p×p tokens spaced H/p
    apart."""
    h, w, p = 16, 24, 4
    x = torch.randn(2, h, w, 5)
    part, unpart = ((grid_partition, grid_unpartition) if grid
                    else (block_partition, block_unpartition))
    t = part(x, p)
    assert t.shape == (2 * (h // p) * (w // p), p * p, 5)
    assert torch.equal(unpart(t, p, 2, h, w), x)
    idx = ref.group_tokens(h, w, p, grid, "cpu")
    want = x.reshape(2, h * w, 5)[:, idx].reshape(t.shape)
    assert torch.equal(t, want)
    if grid:  # group (1, 2): rows 1, 5, 9, 13 and columns 2, 8, 14, 20
        g = t[1 * (w // p) + 2]
        assert torch.equal(g.view(p, p, 5),
                           x[0, 1::h // p, 2::w // p])


def test_relative_bias_indexed_as_the_reference():
    table = torch.randn(3, 7, 7)
    got = table.flatten(1)[:, relative_index(4, torch.device("cpu"))]
    assert torch.equal(got, ref.relative_bias(table, 4))


def test_relpos_attention_against_plain_softmax():
    """The function the spans time, alone: SDPA with the gathered bias
    against softmax(QKᵀ/√d + B)·V written out."""
    g, n, heads, d = 5, 16, 2, 8
    qkv = torch.randn(g, n, 3 * heads * d)
    table = torch.randn(heads, 7, 7)
    q, k, v = qkv.view(g, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    s = q @ k.transpose(-1, -2) / math.sqrt(d) + ref.relative_bias(table, 4)
    want = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(g, n, -1)
    torch.testing.assert_close(relpos_attention(qkv, table, heads), want,
                               rtol=1e-5, atol=1e-5)


def test_maxvit_base_widths_and_fused_mlp_gate():
    """MaxViT-B's published widths, depths and heads; the 28 MLPs of
    stage 3 (C 384, F 1536) and no others on ``fused_ln_mlp``."""
    with torch.device("meta"):
        m = maxvit.MaxViT("maxvit-base")
    assert m.stem_conv1.out_channels == 64 and len(m.blocks) == 24
    widths = [blk.mbconv.project_conv.out_channels for blk in m.blocks]
    assert widths == [96] * 2 + [192] * 6 + [384] * 14 + [768] * 2
    for blk, c in zip(m.blocks, widths):
        assert blk.block_attn.heads == blk.grid_attn.heads == c // 32
        assert blk.mbconv.expand_conv.out_channels == 4 * c
        assert blk.mbconv.se_reduce.out_channels == c // 4
        assert blk.block_attn.rel_bias.shape[1:] == (23, 23)
    fused = [(mlp.fc1.in_features, mlp.fc1.out_features)
             for blk in m.blocks for mlp in (blk.block_mlp, blk.grid_mlp)
             if mlp.use_fused_mlp]
    assert fused == [(384, 1536)] * 28
    n = sum(p.numel() for p in m.parameters())
    # the paper's ~120 M with the 1.36 M pre-logits and classifier left out
    assert 117e6 < n < 120e6


@pytest.mark.parametrize("remat", ["none", "block"])
def test_spans_and_counters(remat):
    """Under recording, one forward and backward records each block's
    three spans once (a remat block's recompute none) and two attention
    calls a block; the groups are the windows and grid groups times the
    batch."""
    model = net(backbone_remat=remat)
    model.load_state_dict(seeded_state(model))
    model.train()
    b = batch()
    calls0, groups0 = relpos_attention.calls, relpos_attention.groups
    trace.reset()
    with trace.recording():
        out = model(**inputs(b), rng=torch.Generator().manual_seed(0))
        fwd_calls = relpos_attention.calls - calls0
        fwd_groups = relpos_attention.groups - groups0
        out.sum().backward()
    names = [r.name for r in trace.spans()]
    trace.reset()
    n = len(model.image_model.blocks)
    for name in ("maxvit.mbconv", "maxvit.block_attn", "maxvit.grid_attn"):
        assert names.count(name) == n, (name, names)
    assert fwd_calls == 2 * n
    # stage 1 at 16²: 16 windows and 16 grid groups; stage 2 at 8²: 4 and 4
    assert fwd_groups == B * (16 + 16 + 4 + 4)


def test_bn_folded_path_and_flax_conversion_refuse_maxvit():
    """The BN-folded serving path refuses a MaxViT by name; a flax tree
    (the JAX package has none of MaxViT) maps to EfficientNet's keys, which
    a MaxViT net refuses on load."""
    for kw in (dict(backbone_bn_folded=True),
               dict(backbone_bn_folded=True, backbone_pallas_serving=True)):
        with pytest.raises(ValueError, match="no BN-folded serving path"):
            net(**kw)
    with pytest.raises(ValueError, match="no BN-folded serving path"):
        fusion.fold_fusion_params({}, backbone=TINY)
    flax = {"image_model": {"_conv_stem": {
        "kernel": np.zeros((3, 3, 3, 8), np.float32)}}}
    with pytest.raises(RuntimeError, match="image_model._conv_stem.weight"):
        net().load_state_dict(convert.flax_to_state_dict(flax))


def test_checkpoint_round_trip(tmp_path):
    """A MaxViT fusion net's state through the port's checkpoint, read
    back by ``restore_checkpoint`` and ``state_dict_from_checkpoint``,
    loads into a fresh net that gives the same eval logits."""
    model = ttr.build_fusion(generator(7, "cpu"), fusion_strategy="concat",
                             radiomics_dim=RAD_DIM, backbone=TINY)
    assert all(torch.isfinite(v).all() for v in model.state_dict().values())
    assert model.image_model.blocks[0].block_attn.rel_bias.abs().max() > 0
    tck.save_checkpoint(str(tmp_path / "ck"), model.state_dict())
    for restored in (tck.restore_checkpoint(str(tmp_path / "ck")),
                     convert.state_dict_from_checkpoint(str(tmp_path / "ck"))):
        fresh = net()
        fresh.load_state_dict(restored)
        fresh.eval()
        model.eval()
        with torch.no_grad():
            b = inputs(batch())
            assert torch.equal(fresh(**b), model(**b))
