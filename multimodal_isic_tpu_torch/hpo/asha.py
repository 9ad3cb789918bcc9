"""Asynchronous Successive Halving (ASHA) in stopping mode.

Counterpart of ``multimodal_isic_tpu/hpo/asha.py`` (:1-62), pure numpy: the
reference's ``ASHAScheduler(metric='val_bacc', mode='max',
grace_period=10, reduction_factor=2)`` (``tune_mil.py:144-149``).  Rungs sit
at ``grace·rf^k`` epochs; when a trial first reports at a rung it is stopped
unless its metric is in the top ``1/rf`` fraction of the results recorded
at that rung so far (asynchronous: no waiting for a full bracket).  A NaN
value stops the trial.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class ASHAScheduler:
    metric: str = "val_bacc"
    mode: str = "max"
    grace_period: int = 10
    reduction_factor: int = 2
    max_t: int = 200
    # rung -> list of recorded metric values
    _rungs: Dict[int, List[float]] = field(default_factory=dict)
    # optional cross-process rung storage (``hpo.distributed``): append()
    # returns every value recorded at the rung ACROSS processes, making stop
    # decisions global exactly as under Ray's shared scheduler
    board: object = None

    def milestones(self) -> List[int]:
        out = []
        t = self.grace_period
        while t < self.max_t:
            out.append(t)
            t *= self.reduction_factor
        return out

    def on_result(self, trial_id: str, step: int, result: Dict[str, float]) -> str:
        """→ 'continue' or 'stop'.  ``step`` is 1-based epoch count."""
        value = float(result[self.metric])
        if np.isnan(value):
            return "stop"  # degenerate trial: no useful signal, free the slot
        if self.mode == "min":
            value = -value
        decision = "continue"
        for rung in self.milestones():
            if step == rung:
                if self.board is not None:
                    recorded = self.board.append(rung, value)
                    self._rungs[rung] = recorded
                else:
                    recorded = self._rungs.setdefault(rung, [])
                    recorded.append(value)
                cutoff = np.nanpercentile(
                    recorded, (1.0 - 1.0 / self.reduction_factor) * 100.0)
                if value < cutoff:
                    decision = "stop"
        if step >= self.max_t:
            decision = "stop"
        return decision
