"""Parameter initializers (port of ``mft_tpu/ops/initializers.py``).

* trunk convs: the reference's fan-in normal, ``std = sqrt(2 / (kh*kw*out))``
  (computed from the OUTPUT channel count), OIHW layout,
* linear layers and the GNN's 1x1 convs: torch defaults,
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, ``w [out, in]``,
* BN: scale 1 / bias 0, running mean 0 / var 1.

Every draw takes an explicit ``torch.Generator``; the tensors are drawn on
the CPU (so one seed gives one model on any device) and moved to ``device``.
"""

from __future__ import annotations

import math

import torch


def conv_fanin_normal(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int, *,
                      dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Reference trunk-conv init (backbone.py:11-13), OIHW."""
    std = math.sqrt(2.0 / float(kh * kw * cout))
    w = torch.randn((cout, cin, kh, kw), generator=gen, dtype=torch.float32) * std
    return w.to(device=device, dtype=dtype)


def torch_linear(gen: torch.Generator, fan_in: int, fan_out: int, *, dtype=torch.float32,
                 device="cpu", bias: bool = True) -> dict:
    """torch.nn.Linear default init -> ``{"w": [fan_out, fan_in], "b": [fan_out]}``."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    w = (torch.rand((fan_out, fan_in), generator=gen) * 2.0 - 1.0) * bound
    p = {"w": w.to(device=device, dtype=dtype)}
    if bias:
        b = (torch.rand((fan_out,), generator=gen) * 2.0 - 1.0) * bound
        p["b"] = b.to(device=device, dtype=dtype)
    return p


def torch_conv1x1(gen: torch.Generator, cin: int, cout: int, **kw) -> dict:
    """torch.nn.Conv2d(k=1) default init, stored as the ``[cout, cin]``
    matrix of a channel matmul."""
    return torch_linear(gen, cin, cout, **kw)


def bn_params(c: int, *, dtype=torch.float32, device="cpu") -> dict:
    return {"scale": torch.ones(c, dtype=dtype, device=device), "bias": torch.zeros(c, dtype=dtype, device=device)}


def bn_stats(c: int, *, dtype=torch.float32, device="cpu") -> dict:
    return {"mean": torch.zeros(c, dtype=dtype, device=device), "var": torch.ones(c, dtype=dtype, device=device)}
