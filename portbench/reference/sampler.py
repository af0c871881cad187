"""Which images an episode holds and which generator it draws from.

Restated from the port's conventions, which follow the JAX package: episode
``i`` of an eval seeded ``seed`` picks its classes and images with a Philox
generator keyed by the seed at counter ``[0, 0, 0, i]``
(``numpy.random.Generator``: a permutation of the classes, its first
``n_way``, then ``n_support + n_query`` images of each class without
replacement), and draws its augmentations, schedules and head init from a
``torch.Generator`` seeded ``seed * 1_000_003 + i`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def episode_items(labels: np.ndarray, n_classes: int, n_way: int, per_class: int, seed: int, index: int) -> np.ndarray:
    """Indices into the dataset ``[n_way, per_class]`` of episode ``index``."""
    pools = [np.nonzero(labels == c)[0] for c in range(n_classes)]
    rs = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, index]))
    classes = rs.permutation(n_classes)[:n_way]
    items = np.empty((n_way, per_class), np.int64)
    for k, c in enumerate(classes):
        items[k] = rs.choice(pools[c], size=per_class, replace=len(pools[c]) < per_class)
    return items


def episode_generator(seed: int, index: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed * 1_000_003 + index)
