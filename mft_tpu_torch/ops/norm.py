"""Functional batch normalization (port of ``mft_tpu/ops/norm.py``).

A function, not ``nn.BatchNorm2d``: running statistics are explicit inputs
and outputs and nothing mutates a module buffer.  Statistics are taken in
>= f32 with the biased variance; ``sample_mask`` weighs rows along axis 0
(masked rows still pass through the layer but count 0 in the moments), which
is how the inner loop's ragged last minibatch keeps static shapes.
``groups`` takes batch statistics per contiguous group of leading rows: the
eval's episode lanes (and replica groups) share one call and keep their own
statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-5  # torch default


def _masked_moments(x: torch.Tensor, reduce_dims, mask: Optional[torch.Tensor]):
    """Mean / biased var over ``reduce_dims``, rows weighted by ``mask``
    along dim 0.  Returns (mean, var, count) with keepdim shapes."""
    if mask is None:
        count = 1.0
        for d in reduce_dims:
            count *= x.shape[d]
        mean = x.mean(dim=reduce_dims, keepdim=True)
        var = (x - mean).square().mean(dim=reduce_dims, keepdim=True)
        return mean, var, torch.tensor(count, dtype=x.dtype, device=x.device)
    shape = [1] * x.ndim
    shape[0] = x.shape[0]
    w = mask.reshape(shape).to(x.dtype)
    per_row = 1
    for d in reduce_dims:
        if d != 0:
            per_row *= x.shape[d]
    count = mask.to(x.dtype).sum() * per_row
    mean = (x * w).sum(dim=reduce_dims, keepdim=True) / count
    var = ((x - mean).square() * w).sum(dim=reduce_dims, keepdim=True) / count
    return mean, var, count


def batch_norm(
    x: torch.Tensor,
    params: dict,
    stats: Optional[dict] = None,
    *,
    use_batch_stats: bool,
    update_stats: bool = False,
    momentum: float = 0.1,
    sample_mask: Optional[torch.Tensor] = None,
    eps: float = EPS,
    channel_dim: int = 1,
    groups: int = 1,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Normalize over every dim but ``channel_dim`` (1 for NCHW and
    ``[N, C]``; -1 for the GNN's channels-last edge tensor).

    ``groups > 1``: batch statistics per contiguous group of ``N / groups``
    rows along dim 0, equal to separate calls on the groups (JAX
    ``ops/norm.py`` ``groups``); batch statistics only, with no running-stat
    update and no mask, as there.

    Returns ``(y, new_stats)``; ``new_stats`` is ``stats`` unless
    ``use_batch_stats and update_stats``, where the running update uses the
    unbiased batch variance with torch's ``new = (1-m)*old + m*batch``,
    detached from the autograd graph."""
    in_dtype = x.dtype
    x = x.to(torch.promote_types(in_dtype, torch.float32))
    cd = channel_dim % x.ndim
    reduce_dims = tuple(d for d in range(x.ndim) if d != cd)
    bshape = [1] * x.ndim
    bshape[cd] = x.shape[cd]
    shape = x.shape
    if groups > 1:
        if not use_batch_stats or update_stats or sample_mask is not None:
            raise ValueError("grouped BN takes batch statistics only, with no running-stat update and no mask")
        if x.shape[0] % groups:
            raise ValueError(f"{x.shape[0]} rows do not split into {groups} groups")
        # [G, N/G, ...]: the moments over every dim but the group and channel ones
        x = x.reshape((groups, x.shape[0] // groups) + tuple(x.shape[1:]))
        red = tuple(d + 1 for d in reduce_dims)
        mean = x.mean(dim=red, keepdim=True)
        var = (x - mean).square().mean(dim=red, keepdim=True)
        bshape = [1] + bshape
        new_stats = stats
    elif use_batch_stats:
        mean, var, count = _masked_moments(x, reduce_dims, sample_mask)
        new_stats = stats
        if update_stats and stats is not None:
            # running statistics are never differentiated: built without a
            # graph, so a training step's graph does not live on in them
            with torch.no_grad():
                unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
                new_stats = {
                    "mean": (1.0 - momentum) * stats["mean"] + momentum * mean.reshape(-1),
                    "var": (1.0 - momentum) * stats["var"] + momentum * unbiased.reshape(-1),
                }
    else:
        if stats is None:
            raise ValueError("eval-mode BN requires running stats")
        mean = stats["mean"].to(x.dtype).reshape(bshape)
        var = stats["var"].to(x.dtype).reshape(bshape)
        new_stats = stats
    inv = 1.0 / torch.sqrt(var + eps)
    scale = params["scale"].to(x.dtype).reshape(bshape)
    bias = params["bias"].to(x.dtype).reshape(bshape)
    y = (x - mean) * (inv * scale) + bias
    return y.reshape(shape).to(in_dtype), new_stats


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """``F.softplus(x, beta=100)`` (reference backbone.py:154-155), written
    as the JAX package's ``ops/norm.py`` writes it: linear once ``100 x``
    exceeds 20."""
    bx = 100.0 * x
    return torch.where(bx > 20.0, x, torch.log1p(torch.exp(torch.clamp(bx, max=20.0))) / 100.0)
