"""Early stopping with the reference's exact counter semantics.

Counterpart of ``multimodal_isic_tpu/core/early_stopping.py`` (rule
:28-44, from ``net_utils.py:130-158``): the counter starts at ``patience``;
an improvement resets it and snapshots the weights, otherwise it decrements;
the call returns True (stop) exactly when the counter reaches zero.

The snapshot is a deep copy (``detach().clone()`` of every tensor of the
state dict), as the reference deep-copies its ``state_dict``: the next SGD
step updates the live parameters in place, which the JAX version's
immutable arrays made moot.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

StateDict = Dict[str, torch.Tensor]


class EarlyStopping:
    def __init__(self, patience: int = 5,
                 log: Optional[Callable[[str, float], None]] = None):
        self.patience = patience
        self.counter = patience
        self.best_loss = float("inf")
        self.best_params: Optional[StateDict] = None
        self._log = log

    def __call__(self, current_loss: float, state_dict: StateDict) -> bool:
        improved = current_loss < self.best_loss
        if improved:
            self.best_loss = float(current_loss)
            self.counter = self.patience
        else:
            self.counter -= 1

        if self._log is not None:
            self._log("val/patience_counter", self.counter)

        if improved:
            self.best_params = {k: v.detach().clone()
                                for k, v in state_dict.items()}

        return not self.counter

    def get_best_params(self) -> Optional[StateDict]:
        return self.best_params
