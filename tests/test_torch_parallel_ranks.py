"""The port's parallel programs in 2 ranks on the CPU (gloo, a ``FileStore``
under ``tmp_path``, each group under its own wall timeout) against the port
in one process and against the JAX package: the fusion data-parallel step
(EfficientNet-B3 at 64², global-batch BatchNorm, dropout and drop-connect
on; ``tests/test_parallel.py:60``), the MAE data-parallel step (the tiny
ConvMAE, SGD; :90), the collectives (the bucketed broadcast, the gathers,
the gradient all-reduce), the MIL bag-batch gradients (:116), checkpoints written
by rank 0 of a data-parallel and of a tensor-parallel run restored in one
process (:156), the tensor-parallel forward of the tiny ConvMAE on JAX's
weights and masking draws against JAX's replicated forward, and
``entry.dryrun_multichip(2)``'s programs (the MIL, MAE and fusion
data-parallel checks and the MAE tensor-parallel check, run in the same
group) and its recap."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_isic_tpu.models import convmae as JM
from multimodal_isic_tpu_torch.core import checkpoint as ckpt
from multimodal_isic_tpu_torch.entry import dryrun_recap
from multimodal_isic_tpu_torch.models import convmae as TM
from multimodal_isic_tpu_torch.models.convert import convmae_state_dict
from multimodal_isic_tpu_torch.parallel import checks as C
from multimodal_isic_tpu_torch.parallel import launch
from multimodal_isic_tpu_torch.parallel.launch import (rank_results,
                                                       run_ranks)

GROUP_TIMEOUT_S = 90
N_IMAGES = 4

RANK_CODE = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from multimodal_isic_tpu_torch.core import checkpoint as ckpt
from multimodal_isic_tpu_torch.entry import _dryrun_rank
from multimodal_isic_tpu_torch.models.convmae import ConvMAE
from multimodal_isic_tpu_torch.parallel import checks as C
from multimodal_isic_tpu_torch.parallel import distributed as D
from multimodal_isic_tpu_torch.parallel.sharding import (all_reduce_grads_,
                                                         make_grid, replicate_)
from multimodal_isic_tpu_torch.parallel.tp import gather_convmae, shard_convmae

work = sys.argv[1]
D.initialize(device="cpu")
grid = make_grid()
lin = torch.nn.Linear(3, 2)
torch.nn.init.constant_(lin.weight, float(grid.rank))
torch.nn.init.constant_(lin.bias, grid.rank + 1.0)
replicate_(lin)
collectives = {
    "replicated": lin.weight.detach().flatten().tolist()
    + lin.bias.detach().tolist(),
    "gathered": D.gather_to_host(torch.full((2,), float(grid.rank))).tolist(),
    "bools": D.gather_to_host(torch.tensor([grid.rank == 0])).tolist(),
    "equal": [D.all_processes_equal(1.0),
              D.all_processes_equal(float(grid.rank))],
    "objects": D.all_gather_object({"rank": grid.rank}),
    "broadcast": D.broadcast_object(f"from {grid.rank}"),
    "coordinator": D.is_coordinator()}
# gradients: used on both ranks, on rank 1 only, and on neither
lins = torch.nn.ModuleList(torch.nn.Linear(2, 1) for _ in range(3))
loss = lins[0](torch.full((1, 2), float(grid.rank))).sum()
if grid.rank == 1:
    loss = loss + lins[1](torch.ones(1, 2)).sum()
loss.backward()
all_reduce_grads_(lins, grid.data_group)
collectives["grads"] = [None if p.grad is None else p.grad.flatten().tolist()
                        for p in lins.parameters()]
out = {"dryrun": _dryrun_rank(2), "collectives": collectives}
images = C.mae_images(4, 64)
dp, _, _ = C.mae_step(grid, "cpu", images, C.TINY_MAE, 0.75, 0, False)
if grid.rank == 0:
    ckpt.save_checkpoint(work + "/dp_ckpt", dp.state_dict())
tgrid = make_grid(n_model=2)
tp, _, _ = C.mae_step(tgrid, "cpu", images, C.TINY_MAE, 0.75, 0, True)
full = gather_convmae(tp, tgrid)
if grid.rank == 0:
    ckpt.save_checkpoint(work + "/tp_ckpt", full)
out["qkv_rows"] = list(tp.blocks3[0].attn.qkv.weight.shape)
# the tensor-parallel forward on JAX's weights and masking draws
model = ConvMAE(**C.TINY_MAE)
model.load_state_dict(torch.load(work + "/jax_state.pt"))
shard_convmae(model, tgrid)
host = np.load(work + "/inputs.npz")
draws = tuple(torch.from_numpy(host[k]) for k in ("ids_keep", "mask",
                                                  "ids_restore"))
with torch.no_grad():
    loss, pred, _ = model.eval()(torch.from_numpy(host["images"]), 0.75,
                                 masking=draws)
if grid.rank == 0:
    np.savez(work + "/tp_forward.npz", loss=float(loss), pred=pred.numpy())
print("RANK-RESULT " + json.dumps(out), flush=True)
D.shutdown()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module (the ranks set their
    own): the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tiny():
    """JAX tiny-ConvMAE params drawn from a seed (shapes from
    ``eval_shape``: no compile of ``init``), its images and masking draws,
    and its replicated forward at mask 0.75."""
    model = JM.ConvMAE(**C.TINY_MAE)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.zeros((1, 64, 64, 3)), mask_ratio=0.0),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(1)

    def draw(path, leaf):
        z = rng.randn(*leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return z * np.float32(0.02) + np.float32(path[-1].key == "scale")

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    images = np.random.RandomState(2).randn(N_IMAGES, 64, 64, 3).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    loss, pred, _ = jax.jit(lambda p, x: model.apply(
        {"params": p}, x, 0.75, rng=key))(params, jnp.asarray(images))
    draws = JM.random_masking(key, N_IMAGES, 16, 0.75)
    return params, images, draws, float(loss), np.asarray(pred)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_ranks")
    params, images, draws, loss, pred = _jax_tiny()
    torch.save(convmae_state_dict(params), str(work / "jax_state.pt"))
    np.savez(str(work / "inputs.npz"), images=images,
             **{k: np.asarray(a) for k, a in zip(
                 ("ids_keep", "mask", "ids_restore"), draws)})
    outs = run_ranks(2, [sys.executable, "-c", RANK_CODE, str(work)],
                     str(work), GROUP_TIMEOUT_S, env={"OMP_NUM_THREADS": "1"})
    return work, rank_results(outs), (loss, pred)


def _held(result):
    assert result["err"]["ok"], result["err"]
    assert result["losses_ok"], result


def test_collectives_over_two_ranks(ranks):
    """rank 0's weights broadcast in one bucket, gathers in rank order
    (floats and bools through ``all_reduce`` slots), the agreement check,
    object gather and broadcast, one coordinator, the gradient
    all-reduce."""
    _, res, _ = ranks
    got = [r["collectives"] for r in res]
    for r, c in enumerate(got):
        assert c["replicated"] == [0.0] * 6 + [1.0, 1.0]
        assert c["gathered"] == [0.0, 0.0, 1.0, 1.0]
        assert c["bools"] == [True, False]
        assert c["equal"] == [True, False]
        assert c["objects"] == [{"rank": 0}, {"rank": 1}]
        assert c["broadcast"] == "from 0"
        assert c["coordinator"] == (r == 0)
        # the mean over ranks; None where no rank had a gradient (as in
        # one process, where the optimizer then skips the parameter)
        assert c["grads"] == [[0.5, 0.5], [1.0], [0.5, 0.5], [0.5],
                              None, None]


def test_fusion_dp_step_equals_one_process(ranks):
    """Two steps of the flagship fusion net (EfficientNet-B3) at 64²,
    global batch 4 (2 a rank), the fast policy, dropout and drop-connect
    on: parameters, BatchNorm running statistics and losses equal one
    process on the same global batches within ``compare_states``' rtol 1e-4,
    atol 1e-6 (losses rtol 1e-5)."""
    _, res, _ = ranks
    r0, r1 = res[0]["dryrun"]["fusion"], res[1]["dryrun"]["fusion"]
    _held(r0)
    assert r0["losses"] == r1["losses"]  # each rank logs the global loss
    assert len(r0["losses"]) == 2 and np.isfinite(r0["losses"]).all()


def test_mae_dp_step_equals_one_process(ranks):
    _, res, _ = ranks
    _held(res[0]["dryrun"]["mae"])
    assert res[0]["dryrun"]["mae"]["loss"] == res[1]["dryrun"]["mae"]["loss"]


def test_mae_tp_step_equals_one_process(ranks):
    """The tiny ConvMAE's SGD step with its blocks split over 2 model
    ranks, gathered, against one process."""
    _, res, _ = ranks
    got = [r["dryrun"]["mae tensor-parallel"] for r in res]
    _held(got[0])
    assert got[0]["loss"] == got[1]["loss"]


def test_mil_bag_batch_gradients_equal_one_process(ranks):
    _, res, _ = ranks
    _held(res[0]["dryrun"]["mil"])


@pytest.mark.parametrize("name", ["dp_ckpt", "tp_ckpt"])
def test_rank0_checkpoint_restores_in_one_process(ranks, name):
    """The checkpoint rank 0 wrote after one data-parallel step, and the
    one it wrote from the tensor-parallel run's gathered blocks, restore
    strictly into a replicated ConvMAE in this process and equal the
    one-process step's weights."""
    work, res, _ = ranks
    model = TM.ConvMAE(**C.TINY_MAE)
    model.load_state_dict(ckpt.restore_checkpoint(str(work / name),
                                                  model.state_dict()))
    ref, _, _ = C.mae_step(None, "cpu", C.mae_images(4, 64), C.TINY_MAE,
                           0.75, 0, False)
    err = C.compare_states(model.state_dict(), ref.state_dict(), 1e-4, 1e-6)
    assert err["ok"], err
    if name == "tp_ckpt":  # the run really held half the heads a rank
        assert res[0]["qkv_rows"] == [48, 32]


def test_tp_forward_matches_jax_replicated(ranks):
    """The tiny ConvMAE with its encoder and decoder blocks split over 2
    ranks, on JAX's weights (``convmae_state_dict``) and masking draws,
    gives JAX's replicated forward: predictions rtol/atol 1e-4 (float32
    through ~10 layers in another order), loss rtol 1e-5."""
    work, _, (loss, pred) = ranks
    got = np.load(str(work / "tp_forward.npz"))
    np.testing.assert_allclose(got["pred"], pred, rtol=1e-4, atol=1e-4)
    assert float(got["loss"]) == pytest.approx(loss, rel=1e-5)


def test_dryrun_multichip_two_ranks(ranks, capsys):
    """``dryrun_multichip(2)``'s ranks (``entry._dryrun_rank``, run by the
    fixture's group) and its recap; a disagreeing program fails it."""
    _, res, _ = ranks
    results = res[0]["dryrun"]
    assert set(results) == {"mil", "mae", "fusion", "mae tensor-parallel"}
    assert dryrun_recap(2, results, 0.0) is results
    assert "RECAP: mil: OK | mae: OK | fusion: OK | mae tensor-parallel: OK" \
        in capsys.readouterr().out
    bad = dict(results, mae=dict(results["mae"], losses_ok=False))
    with pytest.raises(AssertionError, match="mae"):
        dryrun_recap(2, bad, 0.0)


def test_launcher_runs_one_rank_function(capsys):
    """``python -m ...parallel.launch MODULE:FUNCTION JSON`` (the command
    ``rank_command`` builds, which ``dryrun_multichip`` starts a rank
    with) calls the function and prints its result line."""
    target = "multimodal_isic_tpu_torch.parallel.launch:rank_command"
    cmd = launch.rank_command(target, {"target": "m:f"})
    assert cmd[1:3] == ["-m", "multimodal_isic_tpu_torch.parallel.launch"]
    assert launch._main(cmd[3:]) == 0
    got = rank_results([capsys.readouterr().out])[0]
    assert got == launch.rank_command("m:f")
