"""The program ``bench.py`` measures, on the card.

Counterpart of ``__graft_entry__.py::entry`` (:58-90): uint8 450² crops →
``preprocess_eval_batch`` to 380² in bf16 → the bf16 four-modality
EfficientNet-B3 fusion net (the JAX entry's defaults: intermediate
attention fusion, 780 radiomics features) in eval mode, with weights from a
seed.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.py::dryrun_multichip``: the parallel programs in ranks on
the CPU, each against one process.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from .core.rng import generator
from .data.augment import preprocess_eval_batch
from .train.fusion import BATCH_KEYS, build_fusion


def _example_batch(n: int, hw: int) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(0)
    return {
        "image": rng.rand(n, hw, hw, 3).astype(np.float32),
        "radiomics": rng.randn(n, 780).astype(np.float32),
        "age": rng.randn(n).astype(np.float32),
        "sex": rng.randint(0, 3, n).astype(np.int32),
        "loc": rng.randint(0, 15, n).astype(np.int32),
        "artifacts": rng.randint(0, 2, (n, 6)).astype(np.int32),
        "target": rng.randint(0, 7, n).astype(np.int32),
    }


def entry(device: Union[str, torch.device] = "cuda"
          ) -> Tuple[Callable, Tuple[torch.nn.Module, Dict[str, torch.Tensor]]]:
    """→ ``(forward, (model, inputs))``; ``forward(model, inputs)`` gives
    the [2, 7] logits of two uint8 450² requests."""
    device = torch.device(device)
    model = build_fusion(generator(0, device), dtype=torch.bfloat16).eval()

    @torch.inference_mode()
    def forward(model, batch):
        inputs = {k: batch[k] for k in BATCH_KEYS if k in batch}
        inputs["image"] = preprocess_eval_batch(batch["image"], (380, 380),
                                                dtype=torch.bfloat16)
        return model(**inputs)

    host = _example_batch(2, 450)
    host["image"] = np.random.RandomState(0).randint(0, 255, (2, 450, 450, 3),
                                                     np.uint8)
    inputs = {k: torch.from_numpy(host[k]).to(device) for k in BATCH_KEYS}
    for k in ("sex", "loc", "artifacts"):
        inputs[k] = inputs[k].long()
    return forward, (model, inputs)


def _dryrun_rank(n: int) -> Dict:
    """One rank of :func:`dryrun_multichip`: the MIL, MAE and fusion
    data-parallel checks over the ``n`` ranks, then the MAE tensor-parallel
    check on a grid of ``n / 2`` data × 2 model ranks (n even)."""
    from .parallel import checks as C
    from .parallel import distributed as D
    from .parallel.sharding import make_grid

    torch.set_num_threads(1)
    D.initialize(device="cpu")
    grid = make_grid()
    out = {"mil": C.mil_check(grid, "cpu", bags=2 * n),
           "mae": C.mae_check(grid, "cpu", batch=2 * n),
           "fusion": C.fusion_dp_check(grid, "cpu", batch=2 * n, steps=2)}
    if n % 2 == 0:
        out["mae tensor-parallel"] = C.mae_check(
            make_grid(n_model=2), "cpu", batch=2 * n, tp=True)
    return out


def dryrun_multichip(n: int = 2, timeout_s: float = 240.0) -> Dict:
    """Start ``n`` ranks on the CPU (gloo, a ``FileStore``) and hold each
    parallel program against one process: the MIL bag-batch gradients, the
    MAE data-parallel step, the fusion data-parallel step (EfficientNet-B3
    at 64², global-batch BatchNorm, dropout on) and the MAE
    tensor-parallel step (the blocks split over 2 model ranks); prints a
    recap and raises ``AssertionError`` when a program disagrees (the
    counterpart of ``__graft_entry__.py::dryrun_multichip`` :127-352) →
    rank 0's results."""
    import tempfile

    from .parallel.launch import rank_command, rank_results, run_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        outs = run_ranks(n, rank_command(
            "multimodal_isic_tpu_torch.entry:_dryrun_rank", {"n": n}),
            work, timeout_s, env={"OMP_NUM_THREADS": "1"})
    return dryrun_recap(n, rank_results(outs)[0], time.perf_counter() - t0)


def dryrun_recap(n: int, results: Dict, seconds: float) -> Dict:
    """Print one line a program of rank 0's :func:`_dryrun_rank` results
    and the recap; raise ``AssertionError`` when a program disagrees with
    one process → ``results``."""
    recap, bad = [], []
    for name, r in results.items():
        loss = r.get("losses", [r.get("loss")])[-1]
        ref = r.get("ref_losses", [r.get("ref_loss")])[-1]
        ok = r["err"]["ok"] and r["losses_ok"]
        print(f"dryrun_multichip({n}) {name}: loss {loss:.6f} vs one "
              f"process {ref:.6f}; state max_abs_err "
              f"{r['err']['max_abs']:.3e} (rtol {r['err']['rtol']}, atol "
              f"{r['err']['atol']}) {'OK' if ok else 'MISMATCH'}",
              flush=True)
        recap.append(f"{name}: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            bad.append(name)
    print(f"dryrun_multichip({n}) RECAP: " + " | ".join(recap)
          + f" [{seconds:.1f} s]", flush=True)
    if bad:
        raise AssertionError(f"dryrun_multichip({n}): {bad} disagree with "
                             "one process")
    return results
