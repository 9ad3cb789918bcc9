"""The program ``bench.py`` measures, on the card.

Counterpart of ``__graft_entry__.py::entry`` (:58-90): uint8 450² crops →
``preprocess_eval_batch`` to 380² in bf16 → the bf16 four-modality
EfficientNet-B3 fusion net (the JAX entry's defaults: intermediate
attention fusion, 780 radiomics features) in eval mode, with weights from a
seed.
"""

from __future__ import annotations

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
