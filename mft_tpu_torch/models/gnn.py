"""Episodic GNN head (port of ``mft_tpu/models/gnn.py``; reference
methods/gnn.py: ``Wcompute``, ``Gconv``, ``GNN_nl``).

Node features are ``[B, N, F]`` and the edge tensor ``[B, N, N, C]`` is
channels-last: every 1x1 conv of the adjacency network is a matmul on the
last dim, and every BN is the reference's ``track_running_stats=False``
flavour (batch statistics always).  With ``use_pallas`` the first edge conv
runs through the hand-written CUDA edge kernel (``kernels/edge_mlp.py``)
in f32, as the JAX package runs it through its Pallas kernel.

``bn_groups``: the graphs of that many episodes share one call (``B`` =
their graphs, episode-major) and every BN keeps each episode's statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mft_tpu_torch.ops.convpool import leaky_relu, linear
from mft_tpu_torch.ops.initializers import bn_params, torch_conv1x1, torch_linear
from mft_tpu_torch.ops.norm import batch_norm


class GNNCfg(NamedTuple):
    in_features: int
    nf: int
    n_way: int
    num_layers: int = 2
    ratio: tuple = (2, 2, 1, 1)


def init_wcompute(gen, cin: int, nf: int, ratio=(2, 2, 1, 1), **kw) -> dict:
    p, c = {}, cin
    for i, r in enumerate(ratio, start=1):
        w = int(nf * r)
        p[f"conv{i}"] = torch_conv1x1(gen, c, w, **kw)
        p[f"bn{i}"] = bn_params(w, **kw)
        c = w
    p["conv_last"] = torch_conv1x1(gen, c, 1, **kw)
    return p


def _bn_last(h: torch.Tensor, p: dict, groups: int = 1) -> torch.Tensor:
    return batch_norm(h, p, None, use_batch_stats=True, channel_dim=-1, groups=groups)[0]


def apply_wcompute(p: dict, x: torch.Tensor, use_pallas: bool = False, bn_groups: int = 1) -> torch.Tensor:
    """x ``[B, N, F]`` -> operator stack ``[B, N, N, 2]`` = (identity,
    row-softmax adjacency with self-edges masked by -1e8).  One edge-kernel
    call for all ``B`` graphs."""
    if use_pallas:
        from mft_tpu_torch.kernels.edge_mlp import edge_abs_diff_matmul

        c1 = p["conv1"]
        h = edge_abs_diff_matmul(x.float(), c1["w"].float(), c1["b"].float())
    else:
        h = linear((x[:, :, None, :] - x[:, None, :, :]).abs(), p["conv1"])
    h = leaky_relu(_bn_last(h, p["bn1"], bn_groups))
    for i in range(2, 5):
        h = leaky_relu(_bn_last(linear(h, p[f"conv{i}"]), p[f"bn{i}"], bn_groups))
    w = linear(h, p["conv_last"])[..., 0]  # [B, N, N]
    # w is f32 whenever x is or the edge kernel ran, so this is JAX's promotion
    eye = torch.eye(x.shape[1], dtype=w.dtype, device=x.device)
    w = torch.softmax(w - eye * 1e8, dim=2)  # mask self-edges (reference gnn.py:106)
    return torch.stack([eye.expand_as(w), w], dim=-1)


def init_gconv(gen, cin: int, cout: int, j: int = 2, bn: bool = True, **kw) -> dict:
    p = {"fc": torch_linear(gen, j * cin, cout, **kw)}
    if bn:
        p["bn"] = bn_params(cout, **kw)
    return p


def apply_gconv(p: dict, w_ops: torch.Tensor, x: torch.Tensor, bn_groups: int = 1) -> torch.Tensor:
    """``gmul`` + linear + optional BN1d over the ``B*N`` rows
    (reference methods/gnn.py:16-56).  w_ops ``[B, N, N, J]``, x ``[B, N, F]``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    prod = torch.einsum("bijk,bjf->bikf", w_ops.to(acc), x.to(acc)).to(x.dtype)
    b, n, j, f = prod.shape
    h = linear(prod.reshape(b, n, j * f), p["fc"])
    if "bn" in p:
        h = batch_norm(h.reshape(b * n, -1), p["bn"], None, use_batch_stats=True, groups=bn_groups)[0]
        h = h.reshape(b, n, -1)
    return h


def init_gnn(gen, cfg: GNNCfg, **kw) -> dict:
    p = {"layers": []}
    c, half = cfg.in_features, cfg.nf // 2
    for _ in range(cfg.num_layers):
        p["layers"].append({"w": init_wcompute(gen, c, cfg.nf, cfg.ratio, **kw), "l": init_gconv(gen, c, half, 2, True, **kw)})
        c += half  # dense concatenation
    p["w_last"] = init_wcompute(gen, c, cfg.nf, cfg.ratio, **kw)
    p["l_last"] = init_gconv(gen, c, cfg.n_way, 2, False, **kw)
    return p


def apply_gnn(p: dict, nodes: torch.Tensor, use_pallas: bool = False, bn_groups: int = 1) -> torch.Tensor:
    """nodes ``[B, N, in_features]`` -> logits ``[B, N, n_way]``
    (reference methods/gnn.py:154-166)."""
    x = nodes
    for layer in p["layers"]:
        w_ops = apply_wcompute(layer["w"], x, use_pallas, bn_groups)
        x = torch.cat([x, leaky_relu(apply_gconv(layer["l"], w_ops, x, bn_groups))], dim=2)
    return apply_gconv(p["l_last"], apply_wcompute(p["w_last"], x, use_pallas, bn_groups), x, bn_groups)
