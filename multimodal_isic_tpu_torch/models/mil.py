"""Gated-attention MIL over patch bags.

Counterpart of ``multimodal_isic_tpu/models/mil.py`` (:24-56), the
reference's ``AttentionMIL`` (``utils_g_mil.py:15-36``): Linear + ReLU +
dropout features, a Tanh-gated attention score a patch, softmax over the
bag's patches, the attention-weighted sum, a linear head and **softmax
probabilities** out (the reference trains on ``CE(log(probs + 1e-9), y)``,
so the probabilities are the module's contract).

Bags are fixed-shape ``[..., N, F]`` with an optional validity mask
``[..., N]``: padded patches get a score of ``NEG_INF`` and so exactly zero
weight.  One bag (``[N, F]``) trains a step; a batch of padded bags
(``[B, N, F]``) evaluates at once.  Dropout draws from a passed
``torch.Generator`` (:func:`models.graph_mil._dropout`).  Parameter names are
flax's (``feat_fc``, ``att_fc1``, ``att_fc2``, ``classifier``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .graph_mil import NEG_INF, Draws, Rate, _dropout


class AttentionMIL(nn.Module):
    def __init__(self, input_dim: int = 76, hidden_dim: int = 128,
                 att_dim: int = 64, dropout: float = 0.5,
                 num_classes: int = 7):
        super().__init__()
        self.dropout = dropout
        self.feat_fc = nn.Linear(input_dim, hidden_dim)
        self.att_fc1 = nn.Linear(hidden_dim, att_dim)
        self.att_fc2 = nn.Linear(att_dim, 1)
        self.classifier = nn.Linear(hidden_dim, num_classes)

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[Draws] = None,
                dropout_rate: Optional[Rate] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [..., N, input_dim]; valid [..., N] bool → (probs [...,
        num_classes], attention [..., N, 1]).  ``dropout_rate`` overrides
        the module's rate (a 0-d tensor: the HPO cohorts' per-trial rate,
        JAX ``hpo/population.py:71-87``)."""
        h = F.relu(self.feat_fc(x))
        h = _dropout(h, self.dropout if dropout_rate is None
                     else dropout_rate, train, generator)
        scores = self.att_fc2(torch.tanh(self.att_fc1(h)))  # [..., N, 1]
        if valid is not None:
            scores = scores.masked_fill(~valid[..., None], NEG_INF)
        a = torch.softmax(scores, dim=-2)
        z = torch.sum(a * h, dim=-2)
        probs = torch.softmax(self.classifier(z), dim=-1)
        return probs, a


def mil_loss(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The reference's idiom, ``CrossEntropy(log(probs + 1e-9), y)``
    (``utils_g_mil.py:160,208``): ``-log_softmax(log(p + 1e-9))[y]``,
    epsilon included.  probs [..., C], target [...] → loss [...]."""
    logp = torch.log(probs + 1e-9)
    return -torch.gather(torch.log_softmax(logp, dim=-1), -1,
                         target[..., None].long())[..., 0]
