"""Episode geometry and labels (port of ``mft_tpu/core/episode.py``).

An episode is ``[n_way, n_support + n_query, ...]`` with the support slots
first in every class (reference meta_template.py:33-47).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class EpisodeSpec(NamedTuple):
    n_way: int
    n_support: int
    n_query: int

    @property
    def n_per_class(self) -> int:
        return self.n_support + self.n_query

    @property
    def support_size(self) -> int:
        return self.n_way * self.n_support

    @property
    def query_size(self) -> int:
        return self.n_way * self.n_query

    @property
    def total(self) -> int:
        return self.n_way * self.n_per_class


def support_labels(spec: EpisodeSpec, device="cpu") -> torch.Tensor:
    """``[n_way * n_support]``: class c repeated n_support times."""
    return torch.arange(spec.n_way, device=device).repeat_interleave(spec.n_support)


def query_labels(spec: EpisodeSpec, device="cpu") -> torch.Tensor:
    """``[n_way * n_query]`` (reference meta_template.py:51)."""
    return torch.arange(spec.n_way, device=device).repeat_interleave(spec.n_query)


def support_onehot_with_query_slot(spec: EpisodeSpec, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """GNN node labels ``[n_way * (n_support + 1), n_way]``: per class,
    n_support one-hot rows then one zero row for the query slot
    (reference methods/gnnnet.py:35-38)."""
    eye = np.eye(spec.n_way, dtype=np.float32)
    per_class = np.concatenate(
        [np.repeat(eye[:, None, :], spec.n_support, axis=1), np.zeros((spec.n_way, 1, spec.n_way), np.float32)],
        axis=1,
    )
    return torch.from_numpy(per_class.reshape(-1, spec.n_way)).to(device=device, dtype=dtype)


def flatten_episode(x: torch.Tensor) -> torch.Tensor:
    """``[n_way, s+q, ...] -> [n_way * (s+q), ...]``."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
