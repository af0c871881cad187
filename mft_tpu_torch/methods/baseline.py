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
    """``feats @ w.T + b``; with lane-stacked heads (``w [L, C, F]``, ``b [L,
    C]``) and ``feats [L, B, F]``, each lane's logits ``[L, B, C]`` from one
    batched product (the eval's episode lanes)."""
    if p["w"].dim() == 2:
        return linear(feats, p)
    acc = torch.promote_types(feats.dtype, torch.float32)
    y = torch.bmm(feats.to(acc), p["w"].to(feats.dtype).to(acc).transpose(1, 2)).to(feats.dtype)
    return y + p["b"].to(feats.dtype)[:, None, :]


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE, or with per-row ``weights`` the weighted mean (the ragged
    last minibatch under static shapes).  Taken in at least f32.  With
    ``logits [L, B, C]`` and ``labels [L, B]`` (episode lanes; ``weights
    [B]`` shared) each lane's loss, ``[L]``."""
    c = logits.shape[-1]
    ce = F.cross_entropy(logits.to(torch.promote_types(logits.dtype, torch.float32)).reshape(-1, c),
                         labels.reshape(-1), reduction="none").reshape(labels.shape)
    if weights is None:
        return ce.mean(dim=-1)
    return (ce * weights).sum(dim=-1) / torch.clamp(weights.sum(), min=1.0)


def top1_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax is the label (a fraction, not a percent)."""
    return (logits.argmax(dim=-1) == labels).float().mean()
