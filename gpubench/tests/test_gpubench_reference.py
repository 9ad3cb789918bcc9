"""The frozen reference against the port on the CPU at a small size, and
the reference's independence: it imports nothing of the port or JAX."""

import ast

import pytest
import torch

from conftest import ROOT, tiny

from gpubench import common
from gpubench.reference import augment as ra
from gpubench.reference.convmae import Net as MaeNet
from gpubench.reference.convmae import masking
from gpubench.reference.effnet_fusion import Net as FusionNet


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in common.FORBIDDEN + (
                    "multimodal_isic_tpu_torch",), (path, n)


def _gens(seed=3):
    return (torch.Generator().manual_seed(seed),
            torch.Generator().manual_seed(seed))


def test_fusion_policy_bit_for_bit():
    from multimodal_isic_tpu_torch.data.augment import make_fusion_train_fast
    imgs = torch.randint(0, 256, (6, 40, 40, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    g1, g2 = _gens()
    a, _ = make_fusion_train_fast((32, 32))(imgs, None, g1)
    assert torch.equal(a, ra.fusion_train(imgs, g2, (32, 32)))


def test_mae_policy_bit_for_bit():
    from multimodal_isic_tpu_torch.data.augment import mae_train_batch
    imgs = torch.randint(0, 256, (6, 40, 40, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    g1, g2 = _gens()
    a, _ = mae_train_batch(imgs, None, g1, (32, 32))
    torch.testing.assert_close(a, ra.mae_train(imgs, g2, (32, 32)),
                               rtol=1e-6, atol=1e-5)


def test_eval_preprocess():
    from multimodal_isic_tpu_torch.data.augment import preprocess_eval_batch
    imgs = torch.randint(0, 256, (3, 45, 45, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(preprocess_eval_batch(imgs, (38, 38)),
                               ra.eval_batch(imgs, (38, 38)),
                               rtol=1e-5, atol=1e-4)


def _fusion_batch(cfg, b, gen):
    from gpubench.tasks import fusion_meta
    meta = fusion_meta(gen, b, cfg, "cpu")
    meta["image"] = torch.randn(b, cfg["image_size"], cfg["image_size"], 3,
                                generator=gen)
    return meta


@pytest.mark.parametrize("train", [False, True])
def test_fusion_net_matches_port(train):
    from gpubench.builders.effnet_fusion import META, _empty, _model_kwargs, _weights
    cfg = tiny("effnet_b3_fusion.train_bs64")["config"]
    state = _weights(cfg, 5, "cpu")
    port = _empty("cpu", **_model_kwargs(cfg))
    port.load_state_dict(state)
    port.train(train)
    batch = _fusion_batch(cfg, 4, torch.Generator().manual_seed(6))
    g1, g2 = _gens(7)
    with torch.no_grad():
        a = port(**{k: batch[k] for k in META + ("image",)},
                 rng=g1 if train else None)
        b = FusionNet(cfg, state).forward(batch, train=train,
                                          rng=g2 if train else None)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_folded_serving_net_matches_reference():
    """The port's BN fold and fused-kernel serving path in float32 against
    the unfolded reference with eval BatchNorm."""
    from multimodal_isic_tpu_torch.models.fusion import fold_fusion_params
    from gpubench.builders.effnet_fusion import META, _empty, _model_kwargs, _weights
    cfg = tiny("effnet_b3_fusion.serve_bs128")["config"]
    state = _weights(cfg, 8, "cpu")
    port = _empty("cpu", **_model_kwargs(cfg), backbone_bn_folded=True,
                  backbone_pallas_serving=True)
    port.load_state_dict(fold_fusion_params(state, cfg["backbone"]))
    port.eval()
    batch = _fusion_batch(cfg, 4, torch.Generator().manual_seed(9))
    with torch.no_grad():
        a = port(**{k: batch[k] for k in META + ("image",)})
        b = FusionNet(cfg, state).forward(batch)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_convmae_matches_port():
    from gpubench.builders.convmae import _dims, _empty, _weights
    cfg = tiny("convvit_base.pretrain_bs64")["config"]
    state = _weights(cfg, 10, "cpu", True)
    port = _empty("cpu", **_dims(cfg), norm_pix_loss=True)
    port.load_state_dict(state)
    imgs = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    g1, g2 = _gens(11)
    with torch.no_grad():
        loss, _, _ = port(imgs, 0.75, g1)
        m = masking(g2, 3, 4, 0.75)
        ref = MaeNet(cfg, state).loss(imgs, m)
        lat, _, _ = port.encode(imgs, 0.0)
        ref_lat = MaeNet(cfg, state).encode(imgs)
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lat, ref_lat, rtol=1e-4, atol=1e-4)
