"""Functional ResNet backbone zoo (port of ``mft_tpu/models/backbone.py``).

Parameters and BN running statistics are separate trees of tensors (dicts
and lists), threaded explicitly; nothing mutates a module's buffers, so an
adapted copy of the final block is just another tree passed to the same
``apply``.  Layout is NCHW with OIHW conv weights.

The zoo is the reference's (backbone.py, io_utils.py:7-8 ``model_dict``):
ResNet10 / ResNet18 / ResNet34 of ``SimpleBlock``\\ s, ResNet10_FW whose
blocks carry the feature-wise transformation (``SimpleBlock2``: sampled
per-channel affine noise after the second BN and the shortcut BN, in
training only), the split-backbone pieces ResNet8 / ResNet_3 (three stages,
feature maps out) and the stem-less ResNet_fin (one stage on 256-channel
maps), and the ``BottleneckBlock`` that no shipped config uses.

FWT noise has an explicit source: ``apply_backbone``'s ``fwt_noise`` takes
the draws, one dict per block (:func:`draw_fwt_noise` makes them from a
``torch.Generator``; the tests feed JAX's).  Without them (the eval, the meta fine-tune,
every step but the episodic one, as in the JAX package) the FWT blocks are
plain ``SimpleBlock``\\ s.

Adaptation contract: the eval fine-tunes the final residual block
(reference finetune.py:117); :func:`adapt_split` / :func:`adapt_merge`
partition it out of a tree.  For ResNet18/34 the reference's "last 9
tensors" slice straddles the last stage's two final blocks; here, as in the
JAX package (README "Documented deviations"), the boundary is the final
block.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from mft_tpu_torch.ops.convpool import conv2d, global_avg_pool, max_pool
from mft_tpu_torch.ops.initializers import bn_params, bn_stats, conv_fanin_normal
from mft_tpu_torch.ops.norm import batch_norm, softplus100


class ResNetCfg(NamedTuple):
    """Static backbone description.  ``compute_dtype``: conv operand and
    output dtype ('bfloat16' = the fast path); BN statistics, residual
    adds and parameters follow the activations.  ``block``: 'simple',
    'fwt' (ResNet10_FW's feature-wise transformation block) or
    'bottleneck'.  ``stem=False`` (ResNet_fin) drops the stem: the first
    stage reads ``stem_in``-channel feature maps.

    The fields the JAX ``ResNetCfg`` has besides the port's first four
    (``block``, ``stem``, ``stem_in``) come after them here, so a
    positional ``flatten`` stands third in the port and fourth in JAX."""

    stage_sizes: Tuple[int, ...]
    widths: Tuple[int, ...]
    flatten: bool = True
    compute_dtype: str = "float32"
    block: str = "simple"
    stem: bool = True
    stem_in: int = 3

    @property
    def feat_dim(self):
        """The reference's ``final_feat_dim`` (backbone.py:427-433): the
        width, or with ``flatten=False`` the map ``(C, 7, 7)``, the NCHW
        counterpart of the JAX package's NHWC ``(7, 7, C)``."""
        if self.flatten:
            return self.widths[-1]
        return (self.widths[-1], 7, 7)


def resnet10(flatten: bool = True) -> ResNetCfg:
    return ResNetCfg((1, 1, 1, 1), (64, 128, 256, 512), flatten)


def resnet10_fw(flatten: bool = True) -> ResNetCfg:
    return ResNetCfg((1, 1, 1, 1), (64, 128, 256, 512), flatten, block="fwt")


def resnet18(flatten: bool = True) -> ResNetCfg:
    return ResNetCfg((2, 2, 2, 2), (64, 128, 256, 512), flatten)


def resnet34(flatten: bool = True) -> ResNetCfg:
    return ResNetCfg((3, 4, 6, 3), (64, 128, 256, 512), flatten)


def resnet8(flatten: bool = True) -> ResNetCfg:
    """Three stages (reference backbone.py:515-517, which ignores its
    flatten argument and always returns maps)."""
    return ResNetCfg((1, 1, 1), (64, 128, 256), False)


def resnet_3(flatten: bool = False) -> ResNetCfg:
    """ResNet_3 (reference backbone.py:441-479)."""
    return ResNetCfg((1, 1, 1), (64, 128, 256), flatten)


def resnet_fin(flatten: bool = True) -> ResNetCfg:
    """One final stage on 256-channel stage-3 maps, no stem (reference
    backbone.py:481-513, ResNet_fin_func)."""
    return ResNetCfg((1,), (512,), flatten, stem=False, stem_in=256)


#: the reference's io_utils.py:7-8 ``model_dict`` and the split-backbone
#: pieces of backbone.py:512-517
MODEL_REGISTRY = {
    "ResNet10": resnet10,
    "ResNet10_FW": resnet10_fw,
    "ResNet18": resnet18,
    "ResNet34": resnet34,
    "ResNet8": resnet8,
    "ResNet_3": resnet_3,
    "ResNet_fin": resnet_fin,
}


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_block(gen, cin: int, cout: int, fwt: bool, kw):
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
    if fwt:
        # the noise strengths, init 0.3 / 0.5 and never trained (reference
        # backbone.py:322-325); on the second BN and the shortcut BN only
        p["fwt_gamma2"] = torch.full((cout,), 0.3, **kw)
        p["fwt_beta2"] = torch.full((cout,), 0.5, **kw)
        if cin != cout:
            p["fwt_gamma_sc"] = torch.full((cout,), 0.3, **kw)
            p["fwt_beta_sc"] = torch.full((cout,), 0.5, **kw)
    return p, s


def _init_bottleneck_block(gen, cin: int, cout: int, kw):
    """BottleneckBlock (reference backbone.py:264-291): 1x1 reduce, 3x3
    with a bias (C2 keeps torch's Conv2d default, U(+-1/sqrt(mid*9))), 1x1
    expand, each followed by BN; a 1x1 conv shortcut without BN where cin !=
    cout.  Every conv weight takes the fan-in normal init (:293-294)."""
    mid = cout // 4
    bound = 1.0 / math.sqrt(mid * 3 * 3)
    p = {
        "conv1": conv_fanin_normal(gen, 1, 1, cin, mid, **kw),
        "bn1": bn_params(mid, **kw),
        "conv2": conv_fanin_normal(gen, 3, 3, mid, mid, **kw),
        "conv2_b": ((torch.rand((mid,), generator=gen) * 2.0 - 1.0) * bound).to(**kw),
        "bn2": bn_params(mid, **kw),
        "conv3": conv_fanin_normal(gen, 1, 1, mid, cout, **kw),
        "bn3": bn_params(cout, **kw),
    }
    s = {"bn1": bn_stats(mid, **kw), "bn2": bn_stats(mid, **kw), "bn3": bn_stats(cout, **kw)}
    if cin != cout:
        p["conv_sc"] = conv_fanin_normal(gen, 1, 1, cin, cout, **kw)
    return p, s


def init_backbone(gen: torch.Generator, cfg: ResNetCfg, *, dtype=torch.float32, device="cpu"):
    """Returns ``(params, stats)`` trees, drawn from ``gen`` (on the CPU,
    so one seed gives one model on any device)."""
    kw = dict(dtype=dtype, device=device)
    if cfg.stem:
        params = {"stem_conv": conv_fanin_normal(gen, 7, 7, cfg.stem_in, 64, **kw), "stem_bn": bn_params(64, **kw),
                  "stages": []}
        stats = {"stem_bn": bn_stats(64, **kw), "stages": []}
        cin = 64
    else:  # ResNet_fin (backbone.py:481-509)
        params, stats, cin = {"stages": []}, {"stages": []}, cfg.stem_in
    for n, cout in zip(cfg.stage_sizes, cfg.widths):
        sp, ss = [], []
        for _ in range(n):
            if cfg.block == "bottleneck":
                p, s = _init_bottleneck_block(gen, cin, cout, kw)
            else:
                p, s = _init_block(gen, cin, cout, cfg.block == "fwt", kw)
            sp.append(p)
            ss.append(s)
            cin = cout
        params["stages"].append(sp)
        stats["stages"].append(ss)
    return params, stats


def fwt_trainable_mask(params):
    """A tree of bools like ``params``: False for the FWT noise strengths
    (``fwt_*``, requires_grad=False in the reference, backbone.py:324-325),
    True elsewhere (JAX ``fwt_trainable_mask``)."""

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (False if k.startswith("fwt_") else walk(v)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return True

    return walk(params)


def _block_shortcuts(cfg: ResNetCfg):
    """For every block, in order: ``(cout, has a shortcut conv)``."""
    cin = 64 if cfg.stem else cfg.stem_in
    out = []
    for n, cout in zip(cfg.stage_sizes, cfg.widths):
        for _ in range(n):
            out.append((cout, cin != cout))
            cin = cout
    return out


def final_block_has_shortcut(cfg: ResNetCfg) -> bool:
    """Whether the adapted final block has a shortcut conv (ResNet10 and
    ResNet10_FW: 256 -> 512; ResNet18/34's is 512 -> 512 with an identity
    shortcut)."""
    return _block_shortcuts(cfg)[-1][1]


def draw_fwt_noise(gen: torch.Generator, cfg: ResNetCfg, *, dtype=torch.float32, device="cpu"):
    """One pass's FWT noise: for every block, in order, a dict of standard
    normal draws per channel, ``gamma2`` and ``beta2`` and, where the block
    has a shortcut conv, ``gamma_sc`` and ``beta_sc`` (drawn on the CPU in
    that order from ``gen``, then moved)."""
    out = []
    for cout, sc in _block_shortcuts(cfg):
        names = ("gamma2", "beta2", "gamma_sc", "beta_sc") if sc else ("gamma2", "beta2")
        out.append({k: torch.randn((cout,), generator=gen).to(device=device, dtype=dtype) for k in names})
    return out


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------


class BNCtx(NamedTuple):
    use_batch_stats: bool
    update_stats: bool
    momentum: float
    sample_mask: Optional[torch.Tensor]
    #: >1: batch statistics per contiguous group of N/groups rows (ops/norm.py);
    #: ``sample_mask`` is then one group's ``[N/groups]``, shared by the groups
    groups: int = 1
    #: a process group: batch statistics over every rank's rows (ops/norm.py)
    group: object = None


def _bn(x, p, s, ctx: BNCtx):
    return batch_norm(
        x, p, s, use_batch_stats=ctx.use_batch_stats, update_stats=ctx.update_stats,
        momentum=ctx.momentum, sample_mask=ctx.sample_mask, groups=ctx.groups, group=ctx.group,
    )


def _cd(cfg: ResNetCfg):
    return None if cfg.compute_dtype == "float32" else getattr(torch, cfg.compute_dtype)


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))


def _fwt_noise(x, gamma_p, beta_p, eps_gamma, eps_beta):
    """Sampled per-channel affine noise (reference backbone.py:345-349):
    ``(1 + eps_g * softplus100(gamma)) * x + eps_b * softplus100(beta)``."""
    gamma = 1.0 + _per_channel(eps_gamma, x) * softplus100(_per_channel(gamma_p, x))
    beta = _per_channel(eps_beta, x) * softplus100(_per_channel(beta_p, x))
    return gamma * x + beta


def _apply_bottleneck(p, s, x, half_res: bool, ctx: BNCtx, cd=None, conv_groups: int = 1):
    """BottleneckBlock (reference backbone.py:297-311): the stride sits on
    C2 and on the shortcut conv; the shortcut has no BN."""
    stride = 2 if half_res else 1
    out = conv2d(x, p["conv1"], stride=1, padding=0, compute_dtype=cd, groups=conv_groups)
    out, s1 = _bn(out, p["bn1"], s["bn1"], ctx)
    out = torch.relu(out)
    out = conv2d(out, p["conv2"], stride=stride, padding=1, compute_dtype=cd, groups=conv_groups)
    out = out + _per_channel(p["conv2_b"], out)
    out, s2 = _bn(out, p["bn2"], s["bn2"], ctx)
    out = torch.relu(out)
    out = conv2d(out, p["conv3"], stride=1, padding=0, compute_dtype=cd, groups=conv_groups)
    out, s3 = _bn(out, p["bn3"], s["bn3"], ctx)
    short = x
    if "conv_sc" in p:
        short = conv2d(x, p["conv_sc"], stride=stride, padding=0, compute_dtype=cd, groups=conv_groups)
    return torch.relu(out + short), {"bn1": s1, "bn2": s2, "bn3": s3}


def _apply_block(p, s, x, half_res: bool, ctx: BNCtx, cd=None, conv_groups: int = 1, noise=None):
    """SimpleBlock (reference backbone.py:216-261), SimpleBlock2 (:90-130)
    or BottleneckBlock -> ``(y, new_stats)``.  ``noise``: this block's FWT
    draws (:func:`draw_fwt_noise`), applied after the second BN and the
    shortcut BN; None runs an FWT block as a plain one.  ``conv_groups``:
    grouped convs (:func:`apply_final_block_lanes`)."""
    if "conv3" in p:
        return _apply_bottleneck(p, s, x, half_res, ctx, cd, conv_groups)
    stride = 2 if half_res else 1
    out = conv2d(x, p["conv1"], stride=stride, padding=1, compute_dtype=cd, groups=conv_groups)
    out, s1 = _bn(out, p["bn1"], s["bn1"], ctx)
    out = torch.relu(out)
    out = conv2d(out, p["conv2"], stride=1, padding=1, compute_dtype=cd, groups=conv_groups)
    out, s2 = _bn(out, p["bn2"], s["bn2"], ctx)
    if noise is not None:
        out = _fwt_noise(out, p["fwt_gamma2"], p["fwt_beta2"], noise["gamma2"], noise["beta2"])
    new_s = {"bn1": s1, "bn2": s2}
    if "conv_sc" in p:
        short = conv2d(x, p["conv_sc"], stride=stride, padding=0, compute_dtype=cd, groups=conv_groups)
        short, new_s["bn_sc"] = _bn(short, p["bn_sc"], s["bn_sc"], ctx)
        if noise is not None:
            short = _fwt_noise(short, p["fwt_gamma_sc"], p["fwt_beta_sc"], noise["gamma_sc"], noise["beta_sc"])
    else:
        short = x
    return torch.relu(out + short), new_s


def _stem(params, stats, x, ctx: BNCtx, cd):
    x = conv2d(x, params["stem_conv"], stride=2, padding=3, compute_dtype=cd)
    x, s = _bn(x, params["stem_bn"], stats["stem_bn"], ctx)
    return max_pool(torch.relu(x), 3, 2, 1), s


def _half_res(i: int, j: int) -> bool:
    return i >= 1 and j == 0  # reference backbone.py:421-422


def _final_half_res(cfg: ResNetCfg) -> bool:
    return _half_res(len(cfg.stage_sizes) - 1, cfg.stage_sizes[-1] - 1)


def _noise_of(cfg: ResNetCfg, train: bool, fwt_noise):
    """Per-block FWT draws (or Nones): only an FWT backbone in training with
    draws gets any (JAX: ``fwt and train and rng is not None``)."""
    n_blocks = sum(cfg.stage_sizes)
    if cfg.block != "fwt" or not train or fwt_noise is None:
        return [None] * n_blocks
    if len(fwt_noise) != n_blocks:
        raise ValueError(f"fwt_noise holds {len(fwt_noise)} blocks' draws, the backbone has {n_blocks} blocks")
    return list(fwt_noise)


def apply_backbone(params, stats, x: torch.Tensor, *, cfg: ResNetCfg, train: bool,
                   update_stats: bool = False, momentum: float = 0.1,
                   sample_mask: Optional[torch.Tensor] = None, bn_groups: int = 1, fwt_noise=None,
                   start_stage: int = 0, bn_group=None):
    """``x [N, C, H, W]`` -> ``(features, new_stats)``: ``[N, feat_dim]``
    with ``cfg.flatten``, else the last stage's map.

    ``train=True``: batch statistics (with ``sample_mask`` folded in) and,
    with ``update_stats``, running-stat updates; ``train=False``: running
    statistics.  ``bn_groups > 1``: ``x`` stacks that many groups (the
    eval's episode lanes) and every BN takes statistics per group.
    ``fwt_noise`` (an FWT backbone in training only): one dict of draws
    per block (:func:`draw_fwt_noise`; None for a block runs it without
    noise).  ``start_stage > 0`` skips the stem and the
    stages before it: ``x`` is then that stage's input map.  ``bn_group``
    (a process group, ``train=True``): every BN takes its batch statistics
    over the rows of every rank of the group (the data-parallel baseline
    step)."""
    cd = _cd(cfg)
    ctx = BNCtx(train, train and update_stats, momentum, sample_mask, bn_groups, bn_group)
    noise = _noise_of(cfg, train, fwt_noise)
    new_stats = {"stages": [list(s) for s in stats["stages"]]}
    if cfg.stem:
        new_stats["stem_bn"] = stats["stem_bn"]
        if start_stage == 0:
            x, new_stats["stem_bn"] = _stem(params, stats, x, ctx, cd)
    bi = 0
    for i, n in enumerate(cfg.stage_sizes):
        for j in range(n):
            if i >= start_stage:
                x, new_stats["stages"][i][j] = _apply_block(params["stages"][i][j], stats["stages"][i][j], x,
                                                            _half_res(i, j), ctx, cd, noise=noise[bi])
            bi += 1
    if cfg.flatten:
        x = global_avg_pool(x)
    return x, new_stats


def apply_trunk(params, stats, x: torch.Tensor, *, cfg: ResNetCfg, train: bool,
                sample_mask: Optional[torch.Tensor] = None, bn_groups: int = 1) -> torch.Tensor:
    """Stem + every residual block except the final one -> feature map.
    The frozen half of the adaptation split: its output is computed once
    per support bank instead of once per inner minibatch.  ``bn_groups >
    1``: ``x`` stacks that many groups (replica groups, episode lanes), each
    with its own BN statistics (JAX ``apply_trunk``'s ``bn_groups``);
    ``sample_mask`` (``[N / bn_groups]``) weighs each group's rows alike
    (the faithful eval's lanes on one inner schedule).  No FWT noise: the
    eval passes none."""
    cd = _cd(cfg)
    ctx = BNCtx(train, False, 0.1, sample_mask, bn_groups)
    if cfg.stem:
        x, _ = _stem(params, stats, x, ctx, cd)
    last = len(cfg.stage_sizes) - 1
    for i, n in enumerate(cfg.stage_sizes):
        for j in range(n):
            if i == last and j == n - 1:
                continue
            x, _ = _apply_block(params["stages"][i][j], stats["stages"][i][j], x, _half_res(i, j), ctx, cd)
    return x


def apply_final_block(block_params, block_stats, fmap: torch.Tensor, *, cfg: ResNetCfg, train: bool,
                      sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The adapted half: final residual block (+ global pool).
    ``apply_final_block(last, apply_trunk(trunk, x)) == apply_backbone(x)``
    under batch-stats BN."""
    ctx = BNCtx(train, False, 0.1, sample_mask)
    out, _ = _apply_block(block_params, block_stats, fmap, _final_half_res(cfg), ctx, _cd(cfg))
    return global_avg_pool(out) if cfg.flatten else out


def apply_final_block_lanes(block_params, block_stats, fmap: torch.Tensor, *, cfg: ResNetCfg, train: bool,
                            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`apply_final_block` for ``L`` episode lanes in one call: every
    leaf of ``block_params`` carries a leading ``[L]``, ``fmap [L, B, C, H,
    W]`` -> ``[L, B, feat]`` (``flatten``).  The lanes are stacked on the
    channel axis, ``[B, L*C, H, W]``, so each conv is one grouped conv and
    each BN one call whose ``L*C`` channels are the lanes' own (batch
    statistics per lane, ``sample_mask [B]`` shared); ``block_stats`` (the
    running statistics of ``train=False``) are shared by the lanes.  Every
    block kind of the zoo (the bottleneck's per-channel bias too)."""
    lanes, b = fmap.shape[:2]
    x = fmap.transpose(0, 1).reshape((b, -1) + tuple(fmap.shape[3:]))
    p = pytree.tree_map(lambda t: t.reshape((-1,) + tuple(t.shape[2:])), block_params)  # [L, O, ...] -> [L*O, ...]
    s = pytree.tree_map(lambda t: t.repeat(lanes), block_stats)
    ctx = BNCtx(train, False, 0.1, sample_mask)
    out, _ = _apply_block(p, s, x, _final_half_res(cfg), ctx, _cd(cfg), conv_groups=lanes)
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
