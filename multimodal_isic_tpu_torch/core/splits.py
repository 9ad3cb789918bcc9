"""Stratified K-fold with sklearn-identical fold membership (numpy only).

Counterpart of ``multimodal_isic_tpu/core/splits.py::StratifiedKFold``
(:24-66): the reference's protocol is ``StratifiedKFold(10, shuffle=True)``
(``main.py:100``), and this reimplements sklearn's allocation on
``np.random.RandomState`` so the same seed puts the same samples in the same
folds.  :class:`StratifiedShuffleSplit` (:69-140) is the inner 80/20 split
of every MIL trainable (``utils_g_mil.py:105``), with sklearn's membership
for the same seed.  :func:`weighted_sample_indices` (:143-154) is the
per-epoch inverse-class-frequency resampler of the MAE and the MIL
trainables, drawn from the same ``RandomState`` calls as the JAX one, so one
seed gives the same indices.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

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


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Round class-proportional allocations to integers summing to
    ``n_draws`` (largest remainder, random tie-breaking): the allocation
    rule of sklearn's stratified shuffle splits."""
    # operation order matters for float rounding (and so the floor below)
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


class StratifiedShuffleSplit:
    """Random stratified train/test splits; identical membership to
    sklearn's ``StratifiedShuffleSplit`` for the same ``random_state``."""

    def __init__(self, n_splits: int = 10, test_size: float = 0.2,
                 train_size: Optional[float] = None,
                 random_state: Optional[int] = None):
        self.n_splits = n_splits
        self.test_size = test_size
        self.train_size = train_size
        self.random_state = random_state

    def split(self, X, y) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        y = np.asarray(y)
        n_samples = len(y)
        n_test = int(np.ceil(self.test_size * n_samples))
        n_train = (n_samples - n_test if self.train_size is None
                   else int(np.floor(self.train_size * n_samples)))
        classes, y_indices = np.unique(y, return_inverse=True)
        class_counts = np.bincount(y_indices)
        if np.min(class_counts) < 2:
            raise ValueError("The least populated class needs at least 2 "
                             "members")
        # sklearn splits class_indices from the sorted order of y
        class_indices = np.split(np.argsort(y_indices, kind="mergesort"),
                                 np.cumsum(class_counts)[:-1])
        rng = np.random.RandomState(self.random_state)
        for _ in range(self.n_splits):
            n_i = _approximate_mode(class_counts, n_train, rng)
            t_i = _approximate_mode(class_counts - n_i, n_test, rng)
            train: List[int] = []
            test: List[int] = []
            for i in range(len(classes)):
                permutation = rng.permutation(class_counts[i])
                perm = class_indices[i].take(permutation, mode="clip")
                train.extend(perm[:n_i[i]])
                test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
            yield (np.asarray(rng.permutation(train)),
                   np.asarray(rng.permutation(test)))


def weighted_sample_indices(labels: np.ndarray, num_samples: Optional[int],
                            rng: np.random.RandomState) -> np.ndarray:
    """Inverse-class-frequency resampling with replacement, the behaviour of
    ``WeightedRandomSampler(1/class_count, len(dataset), replacement=True)``
    (``train_ae.py:122-127``): ``num_samples`` (default ``len(labels)``)
    indices drawn by ``rng.choice`` with p ∝ 1/count[label]."""
    labels = np.asarray(labels)
    counts = np.bincount(labels)
    weights = 1.0 / counts[labels]
    p = weights / weights.sum()
    n = len(labels) if num_samples is None else num_samples
    return rng.choice(len(labels), size=n, replace=True, p=p)
