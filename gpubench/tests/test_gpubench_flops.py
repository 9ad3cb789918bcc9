"""The yardstick's arithmetic: the frozen bound functions give
``chip_smoke.py``'s numbers on the cells' shapes, and the FLOP counts match
hand counts."""

import json

import pytest
import torch

from conftest import ROOT

from gpubench import flops


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke
    return chip_smoke


def cfg(name):
    return json.loads((ROOT / f"gpubench/configs/{name}.json").read_text())


def test_serving_geometries_match(smoke):
    assert flops.serving_geometries(cfg("effnet_b3_fusion")) == \
        smoke.serving_geometries("efficientnet-b3", 380)


@pytest.mark.parametrize("bsz", [16, 128])
def test_fused_bound(smoke, bsz):
    for geo in flops.serving_geometries(cfg("effnet_b3_fusion")):
        assert flops.fused_bound_ms(geo, bsz, 2) == \
            smoke.fused_bound_ms(geo, bsz, 2)


def test_warp_bound(smoke):
    for b in (16, 64, 128):
        assert flops.warp_bound_ms(b, 380, 380, 3, (380, 380)) == \
            smoke.warp_bound_ms(b, 380, 380, 3, (380, 380))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mae_and_b10_bounds(smoke, dtype):
    for geo in ((128, 56, 256), (128, 28, 384), (64, 56, 256)):
        assert flops.mae_bound_ms("fused_ln_mlp", dtype, geo) == \
            smoke.mae_bound_ms("fused_ln_mlp", dtype, geo)
    for geo in ((128, 56, 256, False), (16, 28, 384, True)):
        assert flops.mae_bound_ms("fused_front", dtype, geo) == \
            smoke.mae_bound_ms("fused_front", dtype, geo)
    assert flops.mae_bound_ms("flash_attention", dtype, (16, 12, 49, 64)) == \
        smoke.mae_bound_ms("flash_attention", dtype, (16, 12, 49, 64))
    for m, c in ((64 * 56 * 56, 256), (64 * 28 * 28, 384)):
        assert flops.b10_bound_ms(dtype, m, c) == smoke.b10_bound_ms(dtype, m, c)


def test_ops_ms(smoke):
    assert flops.ops_ms(1e12, 1e11) == smoke.ops_ms(1e12, 1e11)


def test_conv_block_by_hand():
    """One ConvViT conv block at 56² × 256: two 1×1 convs of 256², the
    5×5 depthwise and the 256 → 1024 → 256 MLP, 2 FLOPs a multiply-add."""
    macs = 56 * 56 * (256 * 256 * 2 + 25 * 256 + 2 * 256 * 1024)
    assert flops._conv_block_flops(56, 256, 4.0) == 2 * macs


def test_vit_block_by_hand():
    """One ViT block of 196 tokens × 768: qkv, the two attention products,
    the projection and the 768 → 3072 → 768 MLP."""
    n, d = 196, 768
    macs = n * d * 3 * d + 2 * n * n * d + n * d * d + 2 * n * d * 4 * d
    assert flops._vit_block_flops(n, d, 4.0) == 2 * macs


def test_mbconv_block_by_hand():
    """EfficientNet-B0's first block at 112² (32 → 16, no expand, k 3,
    SE 8) plus the stem: stem 3×3×3→32 at 112², depthwise 3×3×32, SE
    32→8→32, project 32→16."""
    c = dict(width_coefficient=1.0, depth_coefficient=1.0, image_size=224,
             radiomics_dim=0, num_artifact_classes=0, shared_dim=0,
             num_classes=0)
    blocks = flops.effnet_blocks(1.0, 1.0)
    assert blocks[0] == (1, 3, 1, 32, 16)
    first = 112 * 112 * (27 * 32 + 9 * 32 + 32 * 16) + 2 * 32 * 8
    assert first * 2 < flops.effnet_fusion_flops(c)
    # B0's published 0.39 G multiply-adds at 224²
    assert 0.37e9 < flops.effnet_fusion_flops(c) / 2 < 0.41e9


def test_cell_flops():
    b3 = flops.effnet_fusion_flops(cfg("effnet_b3_fusion"))
    assert 5.0e9 < b3 < 6.5e9     # B3's 1.8 G MACs at 300², × (380/300)²
    vit = cfg("convvit_base")
    enc = flops.convmae_flops(vit, 0.0, decoder=False)
    assert 40e9 < enc < 50e9
    assert flops.convmae_flops(vit, 0.75, decoder=True) < enc
