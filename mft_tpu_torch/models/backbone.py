"""Functional ResNet10 backbone (port of ``mft_tpu/models/backbone.py``).

Parameters and BN running statistics are separate trees of tensors (dicts
and lists), threaded explicitly; nothing mutates a module's buffers, so an
adapted copy of the final block is just another tree passed to the same
``apply``.  Layout is NCHW with OIHW conv weights.  This slice ports the
ResNet10 ``simple`` block only; the other zoo members come later.

Adaptation contract: the eval fine-tunes the final residual block
(reference finetune.py:117); :func:`adapt_split` / :func:`adapt_merge`
partition it out of a tree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from mft_tpu_torch.ops.convpool import conv2d, global_avg_pool, max_pool
from mft_tpu_torch.ops.initializers import bn_params, bn_stats, conv_fanin_normal
from mft_tpu_torch.ops.norm import batch_norm


class ResNetCfg(NamedTuple):
    """Static backbone description.  ``compute_dtype``: conv operand and
    output dtype ('bfloat16' = the fast path); BN statistics, residual
    adds and parameters follow the activations."""

    stage_sizes: Tuple[int, ...]
    widths: Tuple[int, ...]
    flatten: bool = True
    compute_dtype: str = "float32"

    @property
    def feat_dim(self) -> int:
        return self.widths[-1]


def resnet10(flatten: bool = True) -> ResNetCfg:
    return ResNetCfg((1, 1, 1, 1), (64, 128, 256, 512), flatten)


MODEL_REGISTRY = {"ResNet10": resnet10}


def init_backbone(gen: torch.Generator, cfg: ResNetCfg, *, dtype=torch.float32, device="cpu"):
    """Returns ``(params, stats)`` trees, drawn from ``gen``."""
    kw = dict(dtype=dtype, device=device)
    params = {"stem_conv": conv_fanin_normal(gen, 7, 7, 3, 64, **kw), "stem_bn": bn_params(64, **kw), "stages": []}
    stats = {"stem_bn": bn_stats(64, **kw), "stages": []}
    cin = 64
    for n, cout in zip(cfg.stage_sizes, cfg.widths):
        sp, ss = [], []
        for _ in range(n):
            p = {
                "conv1": conv_fanin_normal(gen, 3, 3, cin, cout, **kw),
                "bn1": bn_params(cout, **kw),
                "conv2": conv_fanin_normal(gen, 3, 3, cout, cout, **kw),
                "bn2": bn_params(cout, **kw),
            }
            s = {"bn1": bn_stats(cout, **kw), "bn2": bn_stats(cout, **kw)}
            if cin != cout:
                p["conv_sc"] = conv_fanin_normal(gen, 1, 1, cin, cout, **kw)
                p["bn_sc"] = bn_params(cout, **kw)
                s["bn_sc"] = bn_stats(cout, **kw)
            sp.append(p)
            ss.append(s)
            cin = cout
        params["stages"].append(sp)
        stats["stages"].append(ss)
    return params, stats


class BNCtx(NamedTuple):
    use_batch_stats: bool
    update_stats: bool
    momentum: float
    sample_mask: Optional[torch.Tensor]
    #: >1: batch statistics per contiguous group of N/groups rows (ops/norm.py)
    groups: int = 1


def _bn(x, p, s, ctx: BNCtx):
    return batch_norm(
        x, p, s, use_batch_stats=ctx.use_batch_stats, update_stats=ctx.update_stats,
        momentum=ctx.momentum, sample_mask=ctx.sample_mask, groups=ctx.groups,
    )


def _cd(cfg: ResNetCfg):
    return None if cfg.compute_dtype == "float32" else getattr(torch, cfg.compute_dtype)


def _apply_block(p, s, x, half_res: bool, ctx: BNCtx, cd=None, conv_groups: int = 1):
    """SimpleBlock (reference backbone.py:216-261) -> ``(y, new_stats)``.
    ``conv_groups``: grouped convs (:func:`apply_final_block_lanes`)."""
    stride = 2 if half_res else 1
    out = conv2d(x, p["conv1"], stride=stride, padding=1, compute_dtype=cd, groups=conv_groups)
    out, s1 = _bn(out, p["bn1"], s["bn1"], ctx)
    out = torch.relu(out)
    out = conv2d(out, p["conv2"], stride=1, padding=1, compute_dtype=cd, groups=conv_groups)
    out, s2 = _bn(out, p["bn2"], s["bn2"], ctx)
    new_s = {"bn1": s1, "bn2": s2}
    if "conv_sc" in p:
        short = conv2d(x, p["conv_sc"], stride=stride, padding=0, compute_dtype=cd, groups=conv_groups)
        short, new_s["bn_sc"] = _bn(short, p["bn_sc"], s["bn_sc"], ctx)
    else:
        short = x
    return torch.relu(out + short), new_s


def _stem(params, stats, x, ctx: BNCtx, cd):
    x = conv2d(x, params["stem_conv"], stride=2, padding=3, compute_dtype=cd)
    x, s = _bn(x, params["stem_bn"], stats["stem_bn"], ctx)
    return max_pool(torch.relu(x), 3, 2, 1), s


def apply_backbone(params, stats, x: torch.Tensor, *, cfg: ResNetCfg, train: bool,
                   update_stats: bool = False, momentum: float = 0.1,
                   sample_mask: Optional[torch.Tensor] = None, bn_groups: int = 1):
    """``x [N, 3, H, W]`` -> ``(features [N, feat_dim], new_stats)``.

    ``train=True``: batch statistics (with ``sample_mask`` folded in) and,
    with ``update_stats``, running-stat updates; ``train=False``: running
    statistics.  ``bn_groups > 1``: ``x`` stacks that many groups (the
    eval's episode lanes) and every BN takes statistics per group."""
    cd = _cd(cfg)
    ctx = BNCtx(train, train and update_stats, momentum, sample_mask, bn_groups)
    new_stats = {"stages": [list(s) for s in stats["stages"]]}
    x, new_stats["stem_bn"] = _stem(params, stats, x, ctx, cd)
    for i, n in enumerate(cfg.stage_sizes):
        for j in range(n):
            half_res = i >= 1 and j == 0  # reference backbone.py:421-422
            x, new_stats["stages"][i][j] = _apply_block(params["stages"][i][j], stats["stages"][i][j], x, half_res, ctx, cd)
    if cfg.flatten:
        x = global_avg_pool(x)
    return x, new_stats


def apply_trunk(params, stats, x: torch.Tensor, *, cfg: ResNetCfg, train: bool,
                sample_mask: Optional[torch.Tensor] = None, bn_groups: int = 1) -> torch.Tensor:
    """Stem + every residual block except the final one -> feature map.
    The frozen half of the adaptation split: its output is computed once
    per support bank instead of once per inner minibatch.  ``bn_groups >
    1``: ``x`` stacks that many groups (replica groups, episode lanes), each
    with its own BN statistics (JAX ``apply_trunk``'s ``bn_groups``)."""
    cd = _cd(cfg)
    ctx = BNCtx(train, False, 0.1, sample_mask, bn_groups)
    x, _ = _stem(params, stats, x, ctx, cd)
    last = len(cfg.stage_sizes) - 1
    for i, n in enumerate(cfg.stage_sizes):
        for j in range(n):
            if i == last and j == n - 1:
                continue
            x, _ = _apply_block(params["stages"][i][j], stats["stages"][i][j], x, i >= 1 and j == 0, ctx, cd)
    return x


def apply_final_block(block_params, block_stats, fmap: torch.Tensor, *, cfg: ResNetCfg, train: bool,
                      sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The adapted half: final residual block (+ global pool).
    ``apply_final_block(last, apply_trunk(trunk, x)) == apply_backbone(x)``
    under batch-stats BN."""
    ctx = BNCtx(train, False, 0.1, sample_mask)
    half_res = len(cfg.stage_sizes) > 1 and cfg.stage_sizes[-1] == 1
    out, _ = _apply_block(block_params, block_stats, fmap, half_res, ctx, _cd(cfg))
    return global_avg_pool(out) if cfg.flatten else out


def apply_final_block_lanes(block_params, block_stats, fmap: torch.Tensor, *, cfg: ResNetCfg, train: bool,
                            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`apply_final_block` for ``L`` episode lanes in one call: every
    leaf of ``block_params`` carries a leading ``[L]``, ``fmap [L, B, C, H,
    W]`` -> ``[L, B, feat]`` (``flatten``).  The lanes are stacked on the
    channel axis, ``[B, L*C, H, W]``, so each conv is one grouped conv and
    each BN one call whose ``L*C`` channels are the lanes' own (batch
    statistics per lane, ``sample_mask [B]`` shared); ``block_stats`` (the
    running statistics of ``train=False``) are shared by the lanes."""
    lanes, b = fmap.shape[:2]
    x = fmap.transpose(0, 1).reshape((b, -1) + tuple(fmap.shape[3:]))
    p = pytree.tree_map(lambda t: t.reshape((-1,) + tuple(t.shape[2:])), block_params)  # [L, O, ...] -> [L*O, ...]
    s = pytree.tree_map(lambda t: t.repeat(lanes), block_stats)
    ctx = BNCtx(train, False, 0.1, sample_mask)
    half_res = len(cfg.stage_sizes) > 1 and cfg.stage_sizes[-1] == 1
    out, _ = _apply_block(p, s, x, half_res, ctx, _cd(cfg), conv_groups=lanes)
    out = out.reshape((b, lanes, -1) + tuple(out.shape[2:])).transpose(0, 1)  # [L, B, C', h, w]
    if not cfg.flatten:
        return out
    return global_avg_pool(out.reshape((lanes * b,) + tuple(out.shape[2:]))).reshape(lanes, b, -1)


def adapt_split(tree):
    """``tree`` (params or stats) -> ``(trunk, last_block)``; the trunk keeps
    an empty placeholder where the last block was."""
    last = tree["stages"][-1][-1]
    trunk = {k: v for k, v in tree.items() if k != "stages"}
    trunk["stages"] = [list(s) for s in tree["stages"]]
    trunk["stages"][-1][-1] = {}
    return trunk, last


def adapt_merge(trunk, last):
    """Inverse of :func:`adapt_split`."""
    full = {k: v for k, v in trunk.items() if k != "stages"}
    full["stages"] = [list(s) for s in trunk["stages"]]
    full["stages"][-1][-1] = last
    return full
