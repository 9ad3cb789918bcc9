"""Shared fixtures: the cells resolved at a size the CPU holds (the same
files, with the widths and the pool cut down)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("effnet_b3_fusion.serve_bs128", "convvit_base.latent_bs128",
         "effnet_b3_fusion.train_bs64", "convvit_base.pretrain_bs64")
TINY_CONFIG = {
    "effnet_fusion": dict(backbone="efficientnet-b0", width_coefficient=1.0,
                          depth_coefficient=1.0, image_size=64,
                          feature_dropout=0.2, radiomics_dim=20),
    "convmae": dict(img_size=32, embed_dims=[128, 128, 64], depths=[1, 1, 2],
                    num_heads=4, decoder_dim=32, decoder_depth=1,
                    decoder_heads=4),
}


def tiny(cell: str):
    """The cell's files at a CPU size: EfficientNet-B0 at 64², a ConvMAE
    of widths 128/128/64 at 32², batches of 4 from a pool of 11 crops of
    40²."""
    from gpubench import common
    r = copy.deepcopy(common.resolve(cell))
    r["config"].update(TINY_CONFIG[r["config"]["builder"]])
    r["traffic"].update(batch=4, pool=11, crop_hw=[40, 40])
    if "order_epochs" in r["traffic"]:
        r["traffic"].update(order_epochs=2)
    return r


@pytest.fixture
def tiny_cell():
    import torch
    torch.manual_seed(0)
    return tiny
