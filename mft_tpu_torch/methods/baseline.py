"""Linear classifier head and weighted CE (port of ``mft_tpu/methods/baseline.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mft_tpu_torch.ops.convpool import linear
from mft_tpu_torch.ops.initializers import torch_linear


def init_classifier(gen: torch.Generator, feat_dim: int, num_classes: int, *, dtype=torch.float32,
                    device="cpu", zero_bias: bool = True) -> dict:
    """Linear CE head; the pretraining head zeroes its bias
    (reference baselinetrain.py:17)."""
    p = torch_linear(gen, feat_dim, num_classes, dtype=dtype, device=device)
    if zero_bias:
        p["b"] = torch.zeros_like(p["b"])
    return p


def classifier_logits(p: dict, feats: torch.Tensor) -> torch.Tensor:
    return linear(feats, p)


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE, or with per-row ``weights`` the weighted mean (the ragged
    last minibatch under static shapes).  Taken in at least f32."""
    ce = F.cross_entropy(logits.to(torch.promote_types(logits.dtype, torch.float32)), labels, reduction="none")
    if weights is None:
        return ce.mean()
    return (ce * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def top1_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax is the label (a fraction, not a percent)."""
    return (logits.argmax(dim=-1) == labels).float().mean()
