"""Convolution and pooling (NCHW activations, OIHW weights).

Port of ``mft_tpu/ops/convpool.py``.  The bf16 rounding points are kept: a
bf16 conv takes bf16 operands and rounds its output to bf16 (the card
accumulates in f32 inside the product), ``linear`` accumulates in f32 and
rounds to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0, compute_dtype=None,
           groups: int = 1) -> torch.Tensor:
    """2-D convolution, square stride/padding, no bias.  ``w`` is OIHW.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) sets the operand and output
    dtype; ``None`` keeps the input dtype.  ``groups``: a grouped conv (the
    eval's episode lanes stacked on the channel axis)."""
    cd = compute_dtype if compute_dtype is not None else x.dtype
    return F.conv2d(x.to(cd), w.to(cd), stride=stride, padding=padding, groups=groups)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """``nn.MaxPool2d(window, stride, padding)`` (padding acts as -inf)."""
    return F.max_pool2d(x, window, stride, padding)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W] -> [N, C]`` spatial mean, accumulated in >= f32 and
    returned in the input dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc).mean(dim=(2, 3)).to(x.dtype)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ w.T + b`` for a torch-layout ``w [out, in]``; the product
    accumulates in >= f32 and rounds to ``x.dtype`` before the bias."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.matmul(x.to(acc), p["w"].to(x.dtype).to(acc).t()).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """torch ``F.leaky_relu`` default slope 0.01 (the GNN head)."""
    return F.leaky_relu(x, negative_slope)
