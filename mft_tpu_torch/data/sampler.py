"""Episodic samplers (a copy of ``mft_tpu/data/sampler.py``: the same
(seed, episode index) gives the same episode in both packages).

One parameterized implementation of the reference's sampling mechanics
(SURVEY.md §2.4):

* ``EpisodicBatchSampler``: per episode, a fresh random choice of ``n_way``
  classes (``randperm(n_classes)[:n_way]``, data/dataset.py:77-88), then a
  fresh random batch of ``n_support + n_query`` items from each class (the
  nested shuffling per-class loaders, data/dataset.py:28-56),
* ``EpisodicBatchSampler2``: the deterministic eval variant — all episode
  class choices precomputed under a fixed seed so ensemble members and
  augmented replicas see identical episodes (seed 10;
  datasets/CropDisease_few_shot.py:100-110, 191-209).

Here both are one class with an explicit ``numpy.random.Generator``; eval
determinism comes from seeding rather than precomputation (same contract:
a given (seed, episode_index) always yields the same episode).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from mft_tpu_torch.core.episode import EpisodeSpec

#: the reference's global eval seed (CropDisease_few_shot.py:100, train.py:69)
REFERENCE_SEED = 10


class EpisodeIndices(NamedTuple):
    classes: np.ndarray  # [n_way]
    items: np.ndarray  # [n_way, n_support + n_query] indices into the manifest


class EpisodicSampler:
    """Yields :class:`EpisodeIndices` for a manifest's per-class index lists."""

    def __init__(self, class_indices: List[np.ndarray], spec: EpisodeSpec, n_episodes: int, seed: int = REFERENCE_SEED):
        self.class_indices = class_indices
        self.spec = spec
        self.n_episodes = n_episodes
        self.seed = seed
        for c, idx in enumerate(class_indices):
            if len(idx) == 0:
                raise ValueError(f"class {c} has no items")

    def __len__(self):
        return self.n_episodes

    def episode(self, i: int) -> EpisodeIndices:
        """Deterministic function of (seed, i)."""
        rs = np.random.Generator(np.random.Philox(key=self.seed, counter=[0, 0, 0, i]))
        n_classes = len(self.class_indices)
        classes = rs.permutation(n_classes)[: self.spec.n_way]
        per = self.spec.n_per_class
        items = np.empty((self.spec.n_way, per), np.int64)
        for k, c in enumerate(classes):
            pool = self.class_indices[c]
            # sample without replacement when possible (a DataLoader batch
            # never repeats an item); fall back to replacement for tiny classes
            if len(pool) >= per:
                items[k] = rs.choice(pool, size=per, replace=False)
            else:
                items[k] = rs.choice(pool, size=per, replace=True)
        return EpisodeIndices(classes, items)

    def __iter__(self):
        for i in range(self.n_episodes):
            yield self.episode(i)
