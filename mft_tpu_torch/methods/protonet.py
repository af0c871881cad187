"""Prototypical networks (port of ``mft_tpu/methods/protonet.py``; reference
methods/protonet.py).

Class prototypes are support-embedding means; scores are negative squared
Euclidean distances in the expanded ``q^2 + p^2 - 2qp`` form the JAX module
uses (one matmul instead of a ``[N, M, F]`` broadcast), not ``cdist``.
"""

from __future__ import annotations

import torch

from mft_tpu_torch.core.episode import EpisodeSpec, query_labels
from mft_tpu_torch.methods.baseline import ce_loss


def proto_scores(z_support: torch.Tensor, z_query: torch.Tensor, spec: EpisodeSpec) -> torch.Tensor:
    """z_support ``[n_way, n_support, F]``, z_query ``[n_way, n_query, F]``
    -> scores ``[n_way * n_query, n_way] = -||q - proto||^2``."""
    protos = z_support.mean(dim=1)
    q = z_query.reshape(spec.n_way * spec.n_query, -1)
    q2 = q.square().sum(dim=1, keepdim=True)
    p2 = protos.square().sum(dim=1)[None, :]
    acc = torch.promote_types(q.dtype, torch.float32)
    qp = torch.matmul(q.to(acc), protos.to(acc).t()).to(q.dtype)
    return -(q2 + p2 - 2.0 * qp)


def protonet_loss(scores: torch.Tensor, spec: EpisodeSpec) -> torch.Tensor:
    """Mean CE against ``repeat(range(n_way), n_query)`` (reference protonet.py:42-48)."""
    return ce_loss(scores, query_labels(spec, scores.device))
