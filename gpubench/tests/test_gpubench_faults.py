"""A run with its timed path broken comes out not correct, and so does the
control (the reference in the next lower precision put in the program's
place).  The harness's look for a card is skipped: these runs drive the
rest of a run on the CPU at a small size, against the committed limits."""

import time

import pytest
import torch

from conftest import CELLS, tiny

from gpubench import common, harness
# half the batch left out, the mean taken over the rest
from gpubench.calibrate import half_batch as half_batch_mean

INFER = CELLS[:2]
TRAIN = CELLS[2:]
SEED = 2 ** 31 + 11


def run(cell, fault=None):
    return harness.run_cell(cell, SEED, 0.3, False, time.perf_counter(),
                            device="cpu", resolved=tiny(cell), fault=fault)


def altered_answer(task):
    """One answer replaced by another where it is produced."""
    model = task.model

    def broken(x, batch):
        y = model(x, batch).clone()
        y[0] = y[1]
        return y

    task.model = broken


def half_left_out(task):
    """The second half of the batch never computed: its rows repeat the
    first half's answers."""
    model = task.model

    def broken(x, batch):
        h = x.shape[0] // 2
        y = model(x[:h], {k: v[:h] for k, v in batch.items()})
        return torch.cat([y, y[:x.shape[0] - h]])

    task.model = broken


def state_unchanged(task):
    """A step that returns its state unchanged: no optimizer update."""
    task.optimizer.step = lambda *a, **k: None




@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", INFER)
@pytest.mark.parametrize("fault", [altered_answer, half_left_out])
def test_inference_faults(cell, fault):
    assert not run(cell, fault)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch_mean])
def test_training_faults(cell, fault):
    assert not run(cell, fault)["correct"]


@pytest.mark.parametrize("cell", INFER)
def test_fp8_control_fails(cell):
    """The float8 reference in the program's place on the same sampled
    batches fails the cell's limit."""
    r = tiny(cell)
    builder, driver = common.builder(r["builder"]), common.driver(r["driver"])
    task = builder.make(r["traffic"]["task"], r["config"], r["traffic"],
                        SEED, torch.device("cpu"))
    readings = driver.run(task, r["traffic"], SEED, 0.3, False, "cpu")
    task.release()
    numbers = driver.control(task, readings, "cpu")
    assert any(v > r["limits"][k]["limit"] for k, v in numbers.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN)
def test_tf32_control_fails_on_the_card(cell):
    """TF32 changes nothing on the CPU: the training cells' control runs on
    the card, at a batch of 8 of the cell's full widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 is a tensor-core precision")
    r = common.resolve(cell)
    r["traffic"].update(batch=8, pool=64)
    builder, driver = common.builder(r["builder"]), common.driver(r["driver"])
    task = builder.make(r["traffic"]["task"], r["config"], r["traffic"],
                        SEED, torch.device("cuda:0"))
    task.release()
    numbers = driver.control(task, {}, "cuda:0")
    assert any(v > r["limits"][k]["limit"] for k, v in numbers.items()), numbers
