"""Stratified K-fold with sklearn-identical fold membership (numpy only).

Counterpart of ``multimodal_isic_tpu/core/splits.py::StratifiedKFold``
(:24-66): the reference's protocol is ``StratifiedKFold(10, shuffle=True)``
(``main.py:100``), and this reimplements sklearn's allocation on
``np.random.RandomState`` so the same seed puts the same samples in the same
folds.  The other splitters come with the modules that use them.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


class StratifiedKFold:
    """K-fold with per-class balanced fold sizes; identical membership to
    sklearn's ``StratifiedKFold`` for the same ``random_state``."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False,
                 random_state: Optional[int] = None):
        if n_splits < 2:
            raise ValueError("n_splits must be >= 2")
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def _test_fold_assignment(self, y: np.ndarray) -> np.ndarray:
        rng = np.random.RandomState(self.random_state)
        # classes are encoded by order of FIRST APPEARANCE in y (sklearn):
        # the per-class shuffles consume the RNG stream in that order
        _, first_idx, y_inv = np.unique(y, return_index=True,
                                        return_inverse=True)
        _, class_perm = np.unique(first_idx, return_inverse=True)
        y_idx = class_perm[y_inv]
        n_classes = y_idx.max() + 1
        y_order = np.sort(y_idx)
        # fold k receives every n_splits-th sample of the sorted class list:
        # sklearn's per-fold class allocation counts
        allocation = np.asarray(
            [np.bincount(y_order[i::self.n_splits], minlength=n_classes)
             for i in range(self.n_splits)])
        test_folds = np.empty(len(y_idx), dtype=int)
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_idx == k] = folds_for_class
        return test_folds

    def split(self, X, y) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        y = np.asarray(y)
        test_folds = self._test_fold_assignment(y)
        indices = np.arange(len(y))
        for k in range(self.n_splits):
            test_mask = test_folds == k
            yield indices[~test_mask], indices[test_mask]
