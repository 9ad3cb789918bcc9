"""The port's parallel layer in one process, against the JAX package on the
CPU: ``process_epoch_order`` / ``process_local_rows`` for every rank of
worlds 1-4 (JAX's process index and count monkeypatched, as
``tests/test_distributed.py:292-340`` does), ``validate_epoch`` with
``n_true`` / ``group_size`` and ``evaluate_test`` on the same logits, the
Megatron rule of every ConvMAE parameter against ``megatron_spec``; the
global-batch BatchNorm at world 1 against the port's BatchNorm bit for bit,
the sharded draws, the tensor-parallel block's refusals and the attention
plan at the local heads, the CLIs' process rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_isic_tpu.models import convmae as JM
from multimodal_isic_tpu.parallel import distributed as JD
from multimodal_isic_tpu.parallel.tp import megatron_spec
from multimodal_isic_tpu.train import fusion as JF
from multimodal_isic_tpu_torch.cli import common as TC
from multimodal_isic_tpu_torch.core import rng as TR
from multimodal_isic_tpu_torch.core.config import config_from_dict
from multimodal_isic_tpu_torch.data import augment as TA
from multimodal_isic_tpu_torch.models import convmae as TM
from multimodal_isic_tpu_torch.models.convert import _convmae_leaf
from multimodal_isic_tpu_torch.models.efficientnet import BatchNorm
from multimodal_isic_tpu_torch.ops import attention as TAT
from multimodal_isic_tpu_torch.parallel import batchnorm as TBN
from multimodal_isic_tpu_torch.parallel import distributed as TD
from multimodal_isic_tpu_torch.parallel import tp as TTP
from multimodal_isic_tpu_torch.parallel.checks import TINY_MAE
from multimodal_isic_tpu_torch.parallel.sharding import SINGLE, Grid, shard_rows
from multimodal_isic_tpu_torch.train import fusion as TF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs several
    workers at once, and torch's OpenMP threads spin against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_world(monkeypatch, world, rank):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_process_epoch_order_matches_jax(world, monkeypatch):
    """Every rank's rows, its batch size and n_true equal JAX's, with and
    without ``pad_to_full``, on epochs that are and are not a multiple of
    the global batch; the ranks' rows in rank order are the global
    batches."""
    G = 12
    for n in (37, 48, 13):
        order = np.random.RandomState(n).permutation(n)
        for pad in (False, True):
            got_rows = []
            for rank in range(world):
                _jax_world(monkeypatch, world, rank)
                want = JD.process_epoch_order(order, G, pad_to_full=pad)
                got = TD.process_epoch_order(order, G, pad_to_full=pad,
                                             world=world, rank=rank)
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1:] == want[1:]
                got_rows.append(got[0].reshape(-1, G // world))
            rebuilt = np.concatenate(got_rows, axis=1).reshape(-1)
            assert len(rebuilt) % G == 0
            if not pad:
                np.testing.assert_array_equal(rebuilt, order[:len(rebuilt)])
    _jax_world(monkeypatch, 2, 0)
    with pytest.raises(ValueError, match="one global batch"):
        JD.process_epoch_order(np.arange(5), 8)
    with pytest.raises(ValueError, match="one global batch"):
        TD.process_epoch_order(np.arange(5), 8, world=2, rank=0)
    with pytest.raises(ValueError, match="not divisible"):
        TD.process_epoch_order(np.arange(40), 10, world=3, rank=0)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_process_local_rows_matches_jax(world, monkeypatch):
    for rank in range(world):
        _jax_world(monkeypatch, world, rank)
        assert (TD.process_local_rows(12 * world, world, rank)
                == JD.process_local_rows(12 * world))
        rows = {"x": torch.arange(4 * world)}
        grid = SINGLE if world == 1 else Grid(world, 1, rank)
        np.testing.assert_array_equal(
            shard_rows(rows, grid)["x"].numpy(),
            np.arange(4 * world)[JD.process_local_rows(4 * world)])
    with pytest.raises(ValueError, match="not divisible"):
        TD.process_local_rows(13, 2, 0)


def _eval_data(n=11, c=7, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, c).astype(np.float32) * 3,
            rs.randint(0, c, n).astype(np.int64))


@pytest.mark.parametrize("n,group", [(11, 4), (16, 4), (5, 16)])
def test_validate_epoch_n_true_matches_jax(n, group):
    """The wrap-padded loader's epoch loss with ``n_true`` / ``group_size``
    equals JAX's on the same logits and the one-process statistic (batch
    means over the unpadded loader); without the trim it would not."""
    logits, targets = _eval_data(n)
    wrapped = np.resize(np.arange(n), -(-n // group) * group)

    def batches(order, bs):
        return [{"logits": logits[order[k:k + bs]],
                 "target": targets[order[k:k + bs]]}
                for k in range(0, len(order), bs)]

    def tensors(host):
        return [{k: torch.from_numpy(v) for k, v in b.items()} for b in host]

    def jfn(params, stats, batch):
        lg = jnp.asarray(batch["logits"])
        return JF.cross_entropy(lg, jnp.asarray(batch["target"])), lg

    def tfn(batch):
        return TF.cross_entropy(batch["logits"], batch["target"]), \
            batch["logits"]

    want = JF.validate_epoch(jfn, None, None, batches(wrapped, group),
                             n_true=n, group_size=group)
    got = TF.validate_epoch(tfn, tensors(batches(wrapped, group)), n_true=n,
                            group_size=group)
    assert got == pytest.approx(want, rel=1e-6)
    plain = TF.validate_epoch(tfn, tensors(batches(np.arange(n), group)))
    assert got == pytest.approx(plain, rel=1e-6)
    if n % group:  # the untrimmed mean weights the duplicates twice
        skewed = TF.validate_epoch(tfn, tensors(batches(wrapped, group)))
        assert skewed != pytest.approx(plain, rel=1e-6)


def test_evaluate_test_n_true_matches_jax():
    n, g = 11, 4
    logits, targets = _eval_data(n, seed=1)
    order = np.concatenate([np.arange(n), np.arange(1)])
    jb = [{"logits": logits[order[k:k + g]], "target": targets[order[k:k + g]]}
          for k in range(0, len(order), g)]
    want = JF.evaluate_test(
        lambda p, s, b: (None, jnp.asarray(b["logits"])), None, None, jb,
        n_true=n)
    got = TF.evaluate_test(
        lambda b: (None, b["logits"]),
        [{k: torch.from_numpy(v) for k, v in b.items()} for b in jb],
        n_true=n)
    assert got[0] == pytest.approx(want[0])
    assert got[1] == want[1]


def test_megatron_rule_of_every_parameter_matches_jax():
    """Every ConvMAE parameter of JAX's tree, named by ``models/convert.py``
    in the port, is split the way ``megatron_spec`` splits it: a kernel
    ``P(None, model)`` (column) is the torch weight's dim 0, ``P(model,
    None)`` (row) its dim 1, a bias ``P(model)`` dim 0, ``P()``
    replicated."""
    shapes = jax.eval_shape(lambda k: JM.ConvMAE(**TINY_MAE).init(
        {"params": k}, jnp.zeros((1, 64, 64, 3)), mask_ratio=0.0),
        jax.random.PRNGKey(0))["params"]
    seen = {"column": 0, "row": 0, "replicated": 0}
    port_names = set(TM.ConvMAE(**TINY_MAE).state_dict())

    def check(path, leaf):
        spec = tuple(megatron_spec(path))
        key, _ = _convmae_leaf(tuple(p.key for p in path),
                               np.zeros(leaf.shape, np.float32))
        assert key in port_names, key
        got = TTP.megatron_dim(key)
        if spec in ((), (None,), (None, None)):
            want = None
        elif spec == (None, "model") or spec == ("model",):
            want = TTP.COLUMN
        else:
            assert spec == ("model", None), spec
            want = TTP.ROW
        assert got == want, (key, spec)
        seen["replicated" if want is None else
             ("column" if want == TTP.COLUMN else "row")] += 1

    jax.tree_util.tree_map_with_path(check, shapes)
    blocks = TINY_MAE["depths"][2] + TINY_MAE["decoder_depth"]
    assert seen["column"] == 4 * blocks and seen["row"] == 2 * blocks


def test_tp_block_refuses_what_does_not_divide():
    model = TM.ConvMAE(**TINY_MAE)
    blk = model.blocks3[0]
    with pytest.raises(ValueError, match="head count 4 does not divide"):
        TTP.TPBlock(blk, None, 8, 0)
    with pytest.raises(ValueError, match="hidden width 128 does not divide"):
        TTP.TPBlock(blk, None, 3, 0)
    # the split itself: rank r's heads of q, k and v, its hidden units
    part = TTP.TPBlock(blk, None, 2, 1)
    w = blk.attn.qkv.weight.detach().reshape(3, 4, 8, 32)
    np.testing.assert_array_equal(part.attn.qkv.weight.detach().numpy(),
                                  w[:, 2:].reshape(48, 32).numpy())
    np.testing.assert_array_equal(
        part.mlp.fc2.weight.detach().numpy(),
        blk.mlp.fc2.weight.detach()[:, 64:].numpy())
    assert part.attn.num_heads == 2
    assert torch.equal(part.attn.proj.bias, blk.attn.proj.bias)


def test_attention_plan_takes_the_local_heads():
    """A rank of 2 model ranks runs ConvViT-Base's encoder on 6 heads of 64
    and the decoder on 8 of 32: the card's attention kernel takes both at
    the smoke run's batch, and its plan depends on N only."""
    for b, h, d in ((8, 6, 64), (8, 8, 32), (16, 6, 64)):
        TAT.check_attention_kernel_shape(b, h, d)
    for n in (50, 196):
        for dt in (torch.float32, torch.bfloat16):
            warps, blocks = TAT.attention_plan(n, dt)
            assert warps * blocks * TAT._WARP_ROWS[dt] >= n
            assert TAT.attention_smem_bytes(64, warps, dt) <= 232448


def test_global_batchnorm_at_world_one_is_the_ports_bit_for_bit():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 5, 6, 3, generator=g) * 2 + 1
    ref = BatchNorm(3)
    ref.weight.data = torch.tensor([0.5, 1.5, 2.0])
    glob = TBN.GlobalBatchNorm(3, ref.eps, None)
    glob.load_state_dict(ref.state_dict())
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = ref(xa), glob(xb)
    (ya ** 2).sum().backward()
    (yb ** 2).sum().backward()
    assert torch.equal(ya, yb) and torch.equal(xa.grad, xb.grad)
    assert torch.equal(ref.weight.grad, glob.weight.grad)
    assert torch.equal(ref.running_var, glob.running_var)
    model = torch.nn.Sequential(BatchNorm(3))
    assert type(TBN.convert(model, None)[0]) is BatchNorm
    converted = TBN.convert(torch.nn.Sequential(ref), object())[0]
    assert type(converted) is TBN.GlobalBatchNorm
    assert converted.weight is ref.weight
    assert converted.running_mean is ref.running_mean


def test_sharded_draws_are_the_global_batchs_rows():
    """Rank r of w draws, for its b rows, rows r·b..(r+1)·b of what one
    process draws for the global batch: plain draws, the fusion and MAE
    policies' parameters and the MAE masks."""
    w, b = 3, 2

    def gen():
        return TR.generator(5, "cpu")

    full = torch.rand(w * b, 4, generator=gen())
    full_fusion = TA.fusion_train_draws(gen(), w * b, (8, 8), 3)
    full_mae = TA.mae_train_draws(gen(), w * b, (10, 12))
    full_mask = TM.random_masking(gen(), w * b, 16, 0.75)
    for r in range(w):
        rows = slice(r * b, (r + 1) * b)
        sg = TR.ShardedGenerator(gen(), w, r)
        assert torch.equal(TR.batch_rand(sg, (b, 4), "cpu"), full[rows])
        for draw, want in ((TA.fusion_train_draws, full_fusion),):
            got = TR.batch_draws(TR.ShardedGenerator(gen(), w, r), draw, b,
                                 (8, 8), 3)
            for k, d in got.items():
                for name, t in d.items():
                    assert torch.equal(t, want[k][name][rows]), (k, name)
        got = TR.batch_draws(TR.ShardedGenerator(gen(), w, r),
                             TA.mae_train_draws, b, (10, 12))
        for k, d in got.items():
            for name, t in d.items():
                assert torch.equal(t, full_mae[k][name][rows]), (k, name)
        masks = TM.random_masking(TR.ShardedGenerator(gen(), w, r), b, 16,
                                  0.75)
        for got_t, want_t in zip(masks, full_mask):
            assert torch.equal(got_t, want_t[rows])
    with pytest.raises(ValueError, match="outside"):
        TR.ShardedGenerator(gen(), 2, 2)


def _write(tmp_path, name, cfg):
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_process_rules(tmp_path, monkeypatch):
    """``setup_processes`` in one process: the config's device; ``mesh``
    model > 1 and data > 1 refused, naming the fix.  The three CLIs that
    run one process in the JAX package too keep refusing ``ISIC_*``."""
    from multimodal_isic_tpu_torch.cli import cluster_latents, save_latent
    from multimodal_isic_tpu_torch.cli import use_latent

    assert TC.setup_processes(config_from_dict({"device": "cpu"})) == (
        False, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="tensor parallelism"):
        TC.setup_processes(config_from_dict({"device": "cpu",
                                             "mesh": {"model": 2}}))
    with pytest.raises(ValueError, match="start 4 processes"):
        TC.setup_processes(config_from_dict({"device": "cpu",
                                             "mesh": {"data": 4}}))
    path = _write(tmp_path, "c", {"device": "cpu"})
    monkeypatch.setenv("ISIC_COORDINATOR", "localhost:1")
    monkeypatch.setenv("ISIC_NUM_PROCESSES", "2")
    monkeypatch.setenv("ISIC_PROCESS_ID", "0")
    for mod in (save_latent, use_latent, cluster_latents):
        with pytest.raises(ValueError, match="runs one process"):
            mod.main(["--config_path", path])
    monkeypatch.delenv("ISIC_NUM_PROCESSES")
    with pytest.raises(ValueError, match="multi-process"):
        TD.initialize(device="cpu")


def test_world_one_group_through_a_passed_store(monkeypatch):
    """A group of one rank on a store the caller passes (gloo on the CPU):
    joined, idempotent, the collectives are the identity, left again."""
    for key in ("ISIC_COORDINATOR", "ISIC_NUM_PROCESSES", "ISIC_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    try:
        assert TD.initialize(num_processes=1, process_id=0,
                             store=torch.distributed.HashStore(), device="cpu")
        assert TD.initialize(device="cpu")  # idempotent
        assert TD.process_count() == 1 and TD.is_coordinator()
        np.testing.assert_array_equal(TD.gather_to_host(torch.arange(3)),
                                      np.arange(3))
        assert TD.all_gather_object("x") == ["x"]
        assert TD.setup("cpu") == (False, None, torch.device("cpu"))
    finally:
        TD.shutdown()
    assert not TD.is_initialized()


def test_backend_rule(monkeypatch):
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert TD.choose_backend(None, cpu, 2)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TD.choose_backend(None, card, 2)[0] == "gloo"
    assert TD.choose_backend(None, card, 1)[0] == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TD.choose_backend(None, card, 4)[0] == "nccl"
    # an indexed card is every rank's card: shared, whatever the count
    pinned = torch.device("cuda", 0)
    assert TD.choose_backend(None, pinned, 2)[0] == "gloo"
    assert TD.choose_backend(None, pinned, 1)[0] == "nccl"
    assert TD.choose_backend("gloo", card, 4) == ("gloo", "asked for")
    with pytest.raises(ValueError, match="needs a CUDA"):
        TD.choose_backend("nccl", cpu, 1)
    with pytest.raises(ValueError, match="expected one of"):
        TD.choose_backend("mpi", cpu, 1)
    monkeypatch.delenv("ISIC_COORDINATOR", raising=False)
    monkeypatch.delenv("ISIC_NUM_PROCESSES", raising=False)
    assert TD.initialize(device="cpu") is False
    assert TD.process_count() == 1 and TD.is_coordinator()
    np.testing.assert_array_equal(TD.gather_to_host(torch.arange(3)),
                                  np.arange(3))
    assert TD.all_processes_equal(1.5)
