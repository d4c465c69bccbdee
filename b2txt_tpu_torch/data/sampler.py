"""Batch index creation: random days-per-batch training sampler + deterministic
validation chunks.

Parity target: ``model_training/dataset.py:16-242`` (BrainToTextDataset's
create_batch_index_train / create_batch_index_test), including the legacy
np.random seeding, days sampled without replacement, trials with replacement,
and the trim-extras loop.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

BatchIndex = Dict[int, Dict[int, np.ndarray]]


class BatchSampler:
    """Precomputes the batch→(day→trials) map for a whole training run."""

    def __init__(
        self,
        trial_indices: Dict[int, Dict],
        n_batches: Optional[int],
        split: str = "train",
        batch_size: int = 64,
        days_per_batch: int = 1,
        random_seed: int = -1,
        must_include_days: Optional[List[int]] = None,
        feature_subset: Optional[Sequence[int]] = None,
    ):
        if random_seed != -1:
            np.random.seed(random_seed)

        if split not in ("train", "test"):
            raise ValueError(f'split must be "train" or "test", got {split!r}')
        self.split = split
        self.days_per_batch = days_per_batch
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.trial_indices = trial_indices
        self.n_days = len(trial_indices)
        self.feature_subset = list(feature_subset) if feature_subset else None

        self.n_trials = sum(len(v["trials"]) for v in trial_indices.values())

        if must_include_days is not None:
            if len(must_include_days) > days_per_batch:
                raise ValueError(
                    f"must_include_days ({must_include_days}) longer than days_per_batch {days_per_batch}"
                )
            must_include_days = [
                d if d >= 0 else self.n_days + d for d in must_include_days
            ]
        self.must_include_days = must_include_days

        if split == "train" and self.days_per_batch > self.n_days:
            raise ValueError(
                f"days_per_batch {days_per_batch} > available days {self.n_days}"
            )

        if split == "train":
            self.batch_index = self._create_train_index()
        else:
            self.batch_index = self._create_test_index()
            self.n_batches = len(self.batch_index)

    def __len__(self) -> int:
        return self.n_batches

    def _create_train_index(self) -> BatchIndex:
        batch_index: BatchIndex = {}
        if self.must_include_days is not None:
            non_must = [
                d for d in self.trial_indices.keys() if d not in self.must_include_days
            ]

        for b in range(self.n_batches):
            batch: Dict[int, np.ndarray] = {}
            if self.must_include_days is not None and len(self.must_include_days) > 0:
                days = np.concatenate(
                    (
                        self.must_include_days,
                        np.random.choice(
                            non_must,
                            size=self.days_per_batch - len(self.must_include_days),
                            replace=False,
                        ),
                    )
                )
            else:
                days = np.random.choice(
                    list(self.trial_indices.keys()),
                    size=self.days_per_batch,
                    replace=False,
                )

            num_trials = math.ceil(self.batch_size / self.days_per_batch)
            for d in days:
                batch[d] = np.random.choice(
                    self.trial_indices[d]["trials"], size=num_trials, replace=True
                )

            extra = num_trials * len(days) - self.batch_size
            while extra > 0:
                d = np.random.choice(days)
                batch[d] = batch[d][:-1]
                extra -= 1

            batch_index[b] = batch
        return batch_index

    def _create_test_index(self) -> BatchIndex:
        batch_index: BatchIndex = {}
        b = 0
        for d in self.trial_indices.keys():
            trials = self.trial_indices[d]["trials"]
            n = len(trials)
            for i in range((n + self.batch_size - 1) // self.batch_size):
                chunk = trials[i * self.batch_size : min((i + 1) * self.batch_size, n)]
                batch_index[b] = {d: np.asarray(chunk)}
                b += 1
        return batch_index
