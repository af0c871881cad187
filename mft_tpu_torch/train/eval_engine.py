"""Per-episode transfer fine-tuning — the cross-domain eval (port of
``mft_tpu/train/eval_engine.py``).

For each episode: clean center views; the support bank (the clean support
three times, then ``gen_examples`` augmented replicas); the final residual
block (plus a throwaway linear head for the linear member) is fine-tuned
with batch-5 torch-Adam steps on that bank (``_adapt_block``); the adapted
backbone embeds the clean episode with batch-stats BN; the GNN head, the
ProtoNet prototypes, DampNet's recovered-feature GNN or the linear head
score the queries; ``--method all`` sums the linear and GNN members'
softmaxes (reference finetune.py:648-650).

Two BN modes (``TransferCfg.bn_mode``):

* ``'episode'`` (default, fast): the frozen trunk embeds the bank once
  (``_bank_fmap``) and each inner step runs the final block alone on its
  rows of that feature bank;
* ``'minibatch'`` (faithful): the bank stays images
  (``ops/augment.make_eval_replicas``) and each inner step runs the whole
  backbone on its minibatch, so every BN layer of the trunk takes that
  minibatch's statistics, as the reference's ``pretrained_model(x)`` in
  train mode does (finetune.py:286).  The gradient still reaches only the
  final block (and head).

Reference quirks kept (load-bearing for accuracy parity): the GNN member's
inner loss is CE on the raw 512-d features used as logits; the support bank
holds the clean support three times; the linear member trains on the clean
support alone for ``linear_epochs`` (finetune.py:139-140).

Episode lanes (``--eval_batch``): the members take ``E`` episodes at once,
``episodes [E, n_way, s+q, 3, S, S]`` with one ``torch.Generator`` per lane.
In both BN modes each phase is one device batch for all lanes: the trunk
passes stack the lanes with per-lane (and per-replica-group) BN statistics
(``bn_groups``; in the minibatch mode every inner step's trunk pass takes
the step's mask in each lane), the inner loop carries lane-stacked
parameters and Adam state and sums the lanes' losses (``inner_fit`` with
``[L, T, B]`` schedules; the fused scan takes the lanes in one call), the
final block is a grouped conv (``apply_final_block_lanes``), and the heads
score every lane in one pass (the GNN: one edge-kernel call per
``Wcompute`` for all lanes' graphs; DampNet's recovery network once for all
lanes, and its probe one lane-stacked loop).  Each lane draws its augment
parameters, classifier init and permutations from its own generator in the
one-lane order, so a lane's answer does not depend on ``E`` or its slot.
The one-episode members (``gnn_member_scores`` ...) are the lane members on
a batch of one.

Each phase of a member runs inside a span (``utils/metrics.span``: a
``torch.profiler.record_function`` range, also kept with its host times in
the lane batch's record) named in :data:`PHASES` (``<phase>:<member>``), so
a profile of one episode splits its host and device time by phase
(chip_smoke.py reads them), and without a profiler the eval's batch records
hold each phase's host time; each span is a few cheap host calls, eight or
nine a lane batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mft_tpu_torch.core.episode import EpisodeSpec, query_labels, support_labels
from mft_tpu_torch.kernels import fused_inner_scan as fis
from mft_tpu_torch.methods.baseline import ce_loss, classifier_logits, init_classifier
from mft_tpu_torch.methods.dampnet import dampnet_scores, recovered_projection
from mft_tpu_torch.methods.gnnnet import GnnNetCfg, gnn_scores
from mft_tpu_torch.methods.protonet import proto_scores
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.ops.augment import augment_lanes, center_batch, make_eval_replicas, pipeline_dtype, to_float
from mft_tpu_torch.train import optimizers as opt
from mft_tpu_torch.train.inner_loop import (InnerLoopCfg, inner_fit, inner_fit_epochwise, inner_fit_pair,
                                            lane_schedule, stack_schedules)
from mft_tpu_torch.utils.metrics import span


#: profiler range names of one member's phases, in run order
PHASES = ("bank_fmap", "adapt", "embed", "score")


class TransferCfg(NamedTuple):
    """Eval-time fine-tune hyperparameters (reference defaults cited)."""

    fine_tune_epochs: int = 5  # GNN member epochs (--fine_tune_epoch)
    linear_epochs: int = 20  # linear member epochs (finetune.py:139)
    batch_size: int = 5  # finetune.py:79,214
    inner_lr: float = 0.01  # finetune.py:109,124,240,255
    head_wd: float = 0.001  # classifier Adam weight decay (finetune.py:109,240)
    #: Adam moment storage in the inner loops: 'bfloat16' (moments stored
    #: bf16, per-step math f32) or 'float32' (strict torch-Adam state)
    opt_state_dtype: str = "bfloat16"
    #: dtype the adapted block (and head) is carried in across inner steps
    inner_param_dtype: str = "float32"
    #: the GNN member's inner loop: 'eager' (one autodiff step per minibatch,
    #: train/inner_loop.py) or 'fused' (the whole scan in hand-written CUDA
    #: kernels, kernels/fused_inner_scan.py; needs bf16 Adam moments and the
    #: episode BN mode's feature bank).  The linear member trains a head too
    #: and always runs eager.
    inner_scan: str = "eager"
    #: 'episode' (frozen-trunk feature bank, fast) | 'minibatch' (the whole
    #: backbone on every inner minibatch, faithful)
    bn_mode: str = "episode"
    #: --freeze_backbone: nothing of the backbone trains and it runs with its
    #: running BN statistics (finetune.py:123-135,263-266); the GNN and
    #: ProtoNet members then adapt nothing, the linear member trains its head
    freeze_backbone: bool = False
    #: 'step' gathers each minibatch's bank rows per step; 'epoch' permutes
    #: the feature bank once per epoch and slices contiguous minibatches
    #: (inner_fit_epochwise: the same rows, the same numbers; episode BN
    #: mode and the eager loops only)
    inner_gather: str = "step"
    #: 'flat' ravels the adapted block (and head) into one contiguous buffer
    #: per optimizer group and lane, so Adam is one elementwise pass instead of
    #: one per leaf; elementwise the same numbers as 'tree' (the JAX package
    #: measured it slower on its TPU and keeps it as a knob; eager loops only)
    inner_carry: str = "tree"
    #: 'seq' runs the --method all members' inner loops back to back; 'lane'
    #: steps them together (inner_fit_pair: the linear member's 100 steps
    #: ride the GNN member's first 100 of 500, one autodiff pass each), the
    #: same numbers.  It falls back to 'seq' where the JAX package's does
    #: (the minibatch BN mode, --freeze_backbone, inner_gather='epoch',
    #: inner_carry='flat') and under inner_scan='fused', whose kernels
    #: train no head
    ensemble_fuse: str = "seq"
    #: replica groups per trunk pass in the support bank's fan-out (1 = one
    #: pass per group); >1 stacks groups into one pass with per-group BN
    #: statistics, the same numbers.  Rounded down to a divisor of
    #: gen_examples + 1 with at most 512 images of a lane in a pass, and
    #: only for groups of at most 128 images (larger ones are sub-chunked)
    fanout_group_pass: int = 1


def bank_labels(spec: EpisodeSpec, replicas: int, device="cpu") -> torch.Tensor:
    """Labels of the stacked support bank: ``[replicas * n_way * n_support]``."""
    return support_labels(spec, device).repeat(replicas)


def _bank_images(replicas: torch.Tensor) -> torch.Tensor:
    """``[..., R, n_way, n_support, 3, S, S]`` -> ``[..., R * n_way * n_support,
    3, S, S]`` (a leading lane axis stays)."""
    return replicas.reshape(tuple(replicas.shape[:-6]) + (-1,) + tuple(replicas.shape[-3:]))


def _lane(tree, i: int):
    """Lane ``i`` of a lane-stacked tree."""
    return pytree.tree_map(lambda t: t[i], tree)


def _stack1(tree):
    """A one-lane tree from an unstacked one."""
    return pytree.tree_map(lambda t: t[None], tree)


def _expand(tree, lanes: int):
    """``lanes`` copies of a tree, stacked on a new leading axis."""
    return pytree.tree_map(lambda t: t[None].expand((lanes,) + tuple(t.shape)).contiguous(), tree)


@torch.no_grad()
def _bank_fmap(trunk_p, trunk_s, support_base: torch.Tensor, gens, *, bcfg: bb.ResNetCfg, aug_cfg,
               gen_examples: int, bn_train: bool = True, clean_only: bool = False, group_pass: int = 1) -> torch.Tensor:
    """Frozen-trunk feature maps of the support banks of ``E`` lanes,
    ``[E, span, C, h, w]``.

    ``support_base [E, n_way, n_support, 3, H0, W0]`` (uint8), ``gens``
    one generator per lane (a raw support ``[n_way, n_support, 3, H0, W0]``
    and one generator give that lane's ``[span, C, h, w]``).  Each pass
    augments a replica group (a whole support set) of every lane and pushes
    them through the trunk together, each lane's group (sub-chunked at <= 128
    images) with its own batch statistics, so only the feature bank stays
    resident.  Order: clean x3, then the ``gen_examples`` augmented groups
    (finetune.py:93,225-233); ``clean_only`` returns the one clean group (the
    linear member).  ``group_pass`` > 1 stacks that many replica groups in a
    pass, with per-group statistics (JAX ``_bank_fmap``'s ``group_pass``)."""
    dt = pipeline_dtype(bcfg.compute_dtype)
    support = to_float(support_base, dt)
    lanes, n = support.shape[0], support.shape[1] * support.shape[2]
    chunk = next(c for c in range(min(n, 128), 0, -1) if n % c == 0)

    def trunk_of(imgs):  # [E, g, n_way, n_support, 3, S, S] -> [E, g, n, C, h, w]
        g = imgs.shape[1]
        flat = imgs.reshape((lanes * g * n,) + tuple(imgs.shape[-3:]))
        out = bb.apply_trunk(trunk_p, trunk_s, flat, cfg=bcfg, train=bn_train,
                             bn_groups=lanes * g * (n // chunk) if bn_train else 1)
        return out.reshape((lanes, g, n) + tuple(out.shape[1:]))

    def view(k):  # replica group k of every lane: 0 the clean view, then the augmented ones
        if k == 0:
            return center_batch(support, aug_cfg.image_size, dtype=dt)
        return augment_lanes(gens, support, aug_cfg, dtype=dt)

    if clean_only:
        return trunk_of(view(0)[:, None])[:, 0]
    n_groups, gpp = gen_examples + 1, 1
    if gen_examples and bn_train and n <= 128:  # JAX eval_engine.py:186-190
        gpp = next((d for d in range(min(group_pass, n_groups), 1, -1) if n_groups % d == 0 and d * n <= 512), 1)
    groups = []  # [E, n, C, h, w] each
    for lo in range(0, n_groups, gpp):
        imgs = view(lo)[:, None] if gpp == 1 else torch.stack([view(k) for k in range(lo, lo + gpp)], dim=1)
        out = trunk_of(imgs)
        groups += [out[:, j] for j in range(gpp)]
    groups = groups[:1] * 2 + groups  # clean x3, then the augmented ones
    return torch.stack([torch.cat([g[i] for g in groups]) for i in range(lanes)])  # keeps the trunk's memory format


def _member_bank(backbone_params, backbone_stats, supports, gens, *, bcfg, tcfg: TransferCfg, aug_cfg,
                 gen_examples: int, clean_only: bool = False):
    """One member's bank ``(fmap_bank, bank_x, n_replicas)`` for
    :func:`_adapt_block`.  Raw supports ``[E, n_way, n_support, 3, H0, W0]``
    (episode mode) become the frozen trunk's feature banks ``[E, span, C, h,
    w]``; the lanes' replica banks ``[E, R, n_way, n_support, 3, S, S]``
    (minibatch mode) stay images ``[E, rows, 3, S, S]``, whole: ``clean_only``
    does not cut them, the linear member's ``perm_span`` keeps its steps on
    replica 0, the clean group (eval_engine.py:417-432 of the JAX package)."""
    if supports.dim() == 7:
        return None, _bank_images(supports), supports.shape[1]
    trunk_p, _ = bb.adapt_split(backbone_params)
    trunk_s, _ = bb.adapt_split(backbone_stats)
    fmap = _bank_fmap(trunk_p, trunk_s, supports, gens, bcfg=bcfg, aug_cfg=aug_cfg, gen_examples=gen_examples,
                      bn_train=not tcfg.freeze_backbone, clean_only=clean_only, group_pass=tcfg.fanout_group_pass)
    return fmap, None, (1 if clean_only else gen_examples + 3)


def _prepare_adapt(params, stats, bank_y, *, bcfg: bb.ResNetCfg, tcfg: TransferCfg, epochs: int,
                   head: Optional[dict], perm_span: Optional[int] = None, fmap_bank: Optional[torch.Tensor] = None,
                   bank_x: Optional[torch.Tensor] = None, gather: str = "step"):
    """One member's inner-loop task ``(p0, loss_fn, tx, icfg, finish)`` with
    ``finish(adapted) -> (block, head)``: the adapted tree is the final
    block (GNN member) or ``{"adapt": block, "head": head}`` (linear member).
    Exactly one bank is given, lane-stacked; the block (and ``head``) carry a
    leading ``[E]`` and ``loss_fn(p, idx [E, B], w [B]) -> [E]`` gathers each
    lane's rows and runs the lanes' final blocks in one grouped pass:

    * ``fmap_bank [E, span, C, h, w]``, the lanes' trunk feature banks; with
      ``gather='epoch'`` the loss is ``loss_fn(p, {"x": rows [E, B, ...],
      "y": labels [E, B]}, w)``
      (:func:`~mft_tpu_torch.train.inner_loop.inner_fit_epochwise`);
    * ``bank_x [E, rows, 3, S, S]``, the lanes' image banks (minibatch BN
      mode): each step runs the trunk on the lanes' ``E * B`` images in one
      pass, each lane's BN statistics its own and masked by the step's
      weights, then the lanes' final blocks, so every BN layer of the
      backbone sees the minibatch; the trunk is a constant (run without a
      graph), so only the block and the head get gradients.

    ``--freeze_backbone`` runs the block with its running statistics and
    trains only the head (the block's optimizer is SGD at rate 0, JAX
    ``_prepare_adapt``)."""
    if (fmap_bank is None) == (bank_x is None):
        raise ValueError("give exactly one of fmap_bank (episode BN mode) and bank_x (minibatch BN mode)")
    trunk_p, block_p = bb.adapt_split(params)
    trunk_s, block_s = bb.adapt_split(stats)
    bn_train = not tcfg.freeze_backbone
    bank = fmap_bank if fmap_bank is not None else bank_x
    span = perm_span if perm_span is not None else bank.shape[1]
    icfg = InnerLoopCfg(epochs=epochs, batch_size=tcfg.batch_size, bank_size=span)
    if tcfg.inner_param_dtype != "float32":
        pd = getattr(torch, tcfg.inner_param_dtype)
        cast = lambda t: {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.to(pd)
        block_p = cast(block_p)
        head = cast(head) if head is not None else None

    n_lanes = bank.shape[0]
    block_p = _expand(block_p, n_lanes)
    lanes = torch.arange(n_lanes, device=bank.device)[:, None]

    def rows_loss(block, h, rows, y, w):
        feats = bb.apply_final_block_lanes(block, block_s, rows, cfg=bcfg, train=bn_train, sample_mask=w)
        return ce_loss(feats if h is None else classifier_logits(h, feats), y, w)

    if bank_x is not None:
        def member_loss(block, h, idx, w):  # the lanes' [E, B] images through the trunk in one pass
            x = bank_x[lanes, idx]
            with torch.no_grad():
                fmap = bb.apply_trunk(trunk_p, trunk_s, x.reshape((-1,) + tuple(x.shape[2:])), cfg=bcfg,
                                      train=bn_train, sample_mask=w, bn_groups=n_lanes if bn_train else 1)
            return rows_loss(block, h, fmap.reshape(tuple(x.shape[:2]) + tuple(fmap.shape[1:])), bank_y[idx], w)
    elif gather == "epoch":
        member_loss = lambda block, h, chunk, w: rows_loss(block, h, chunk["x"], chunk["y"], w)
    else:
        member_loss = lambda block, h, idx, w: rows_loss(block, h, fmap_bank[lanes, idx], bank_y[idx], w)

    adam = opt.torch_adam if tcfg.opt_state_dtype == "float32" else opt.torch_adam_lowmem
    if head is None:
        # GNN member: CE on the raw features as logits (finetune.py:286-291)
        return (block_p, lambda p, idx, w: member_loss(p, None, idx, w), adam(tcfg.inner_lr), icfg,
                lambda a: (a, None))
    # linear member: block + head train (finetune.py:123-124,144-164), the head alone when frozen
    block_tx = opt.torch_sgd(0.0) if tcfg.freeze_backbone else adam(tcfg.inner_lr)
    tx = opt.grouped({"adapt": block_tx, "head": adam(tcfg.inner_lr, tcfg.head_wd)}, {"adapt": "adapt", "head": "head"})
    return ({"adapt": block_p, "head": head}, lambda p, idx, w: member_loss(p["adapt"], p["head"], idx, w), tx, icfg,
            lambda a: (a["adapt"], a["head"]))


def _ravel(tree, lanes: int):
    """A lane-stacked tree as one ``[L, n]`` buffer, and its inverse (views)."""
    leaves, spec = pytree.tree_flatten(tree)
    shapes = [tuple(t.shape[1:]) for t in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([t.reshape(lanes, -1) for t in leaves], dim=1)
    return flat, lambda f: pytree.tree_unflatten(
        [c.reshape((lanes,) + s) for c, s in zip(torch.split(f, sizes, dim=1), shapes)], spec)


def _fit_flat(loss_fn, p0, tx, gens, icfg, schedule, device, lanes: int):
    """``inner_carry='flat'``: the loop on one contiguous buffer per
    optimizer group and lane (``{"adapt", "head"}`` keep their groups)."""
    if set(p0) == {"adapt", "head"}:
        raveled = {k: _ravel(v, lanes) for k, v in p0.items()}
        unravel = lambda pf: {k: raveled[k][1](pf[k]) for k in pf}
        flat0 = {k: raveled[k][0] for k in raveled}
    else:
        flat0, unravel = _ravel(p0, lanes)
    out = inner_fit(lambda pf, idx, w: loss_fn(unravel(pf), idx, w), flat0, tx, gens, icfg, schedule=schedule,
                    device=device)
    return unravel(out)


def _adapt_block_fused(block_p, bank_y, fmap_bank, gens, *, bcfg, tcfg, icfg: InnerLoopCfg, schedule=None):
    """The GNN member's inner loop through the fused scan, all lanes in one
    call (``fused_inner_scan_lanes``: ``L = E``, one schedule per lane;
    ``bank_y`` and the weights are shared, as all lanes share one
    ``EpisodeSpec``): the same schedule draws as ``inner_fit`` (so both
    choices see the same minibatches), and the adapted lane-stacked block
    back in the port's layout and the carry dtype."""
    if tcfg.opt_state_dtype != "bfloat16":
        raise ValueError("inner_scan='fused' stores its Adam moments in bfloat16; "
                         f"opt_state_dtype={tcfg.opt_state_dtype!r} needs inner_scan='eager'")
    # ResNet10_FW's noise strengths ride along unchanged: without noise they
    # take no gradient, so torch-Adam (zero moments, no decay) leaves them be
    fwt = {k: v for k, v in block_p.items() if k.startswith("fwt_")}
    block_p = {k: v for k, v in block_p.items() if k not in fwt}
    half_res = bb._final_half_res(bcfg)
    if set(block_p) != {"conv1", "bn1", "conv2", "bn2", "conv_sc", "bn_sc"}:
        raise ValueError("inner_scan='fused' adapts a final SimpleBlock with a 1x1 shortcut conv (ResNet10, "
                         f"ResNet10_FW); this backbone's final block (the last of a stage of {bcfg.stage_sizes[-1]}) "
                         f"has the keys {sorted(block_p)}, an identity shortcut: use inner_scan='eager'")
    h, w_ = fmap_bank.shape[-2:]
    if h != w_ or h % (2 if half_res else 1):
        raise ValueError(f"inner_scan='fused' needs a square feature map that the stride divides, got {tuple(fmap_bank.shape)}")
    if icfg.epochs == 0:
        return {**block_p, **fwt}
    c_out, c_in = block_p["conv1"].shape[-4:-2]
    geom = fis.BlockGeom(h_in=h, c_in=c_in, c_out=c_out, stride=2 if half_res else 1, batch=icfg.batch_size)
    dev = fmap_bank.device
    idx, w = schedule if schedule is not None else lane_schedule(gens, icfg, dev)
    adapted = fis.fused_inner_scan_lanes(fis.block_to_flat(block_p), fis.bank_to_nhwc(fmap_bank), bank_y,
                                         idx.to(dev), w.to(dev), geom=geom, lr=tcfg.inner_lr)
    return {**fis.flat_to_block(adapted, geom), **fwt}


def _check_modes(tcfg: TransferCfg):
    choices = {"inner_scan": ("eager", "fused"), "bn_mode": ("episode", "minibatch"), "inner_gather": ("step", "epoch"),
               "inner_carry": ("tree", "flat"), "ensemble_fuse": ("seq", "lane")}
    for name, allowed in choices.items():
        if getattr(tcfg, name) not in allowed:
            raise ValueError(f"{name} must be {' or '.join(map(repr, allowed))}, not {getattr(tcfg, name)!r}")
    if tcfg.fanout_group_pass < 1:
        raise ValueError(f"fanout_group_pass must be at least 1, not {tcfg.fanout_group_pass}")
    if tcfg.inner_scan == "fused" and tcfg.bn_mode == "minibatch":
        raise ValueError("inner_scan='fused' scans the final block over the episode BN mode's frozen-trunk feature "
                         "bank; bn_mode='minibatch' runs the whole backbone every step and needs inner_scan='eager'")


def _adapt_block(params, stats, bank_y, gens, *, bcfg, tcfg, epochs, head=None, perm_span=None, fmap_bank=None,
                 bank_x=None, schedule=None):
    """Fine-tune the final block (and the optional head) of every lane on
    its bank (see :func:`_prepare_adapt`: ``fmap_bank`` or ``bank_x``, both
    lane-stacked).  ``perm_span``: the permutations cover only the first
    rows (the linear member's clean-support-only quirk).  ``head``,
    ``schedule``: lane-stacked.  Returns the lane-stacked ``(block, head)``.
    ``tcfg.inner_scan == 'fused'`` sends the head-less (GNN) member through
    the fused scan; with a head the loop stays eager, per ``inner_gather``
    (the episode BN mode's feature bank only, as in JAX) and
    ``inner_carry``."""
    _check_modes(tcfg)
    if tcfg.inner_scan == "fused" and bank_x is not None:
        raise ValueError("inner_scan='fused' needs a feature bank (bn_mode='episode')")
    bank = fmap_bank if fmap_bank is not None else bank_x
    lanes, dev = bank.shape[0], bank.device
    fused = tcfg.inner_scan == "fused" and head is None
    epochwise = tcfg.inner_gather == "epoch" and not fused and fmap_bank is not None
    p0, loss_fn, tx, icfg, finish = _prepare_adapt(params, stats, bank_y, head=head, fmap_bank=fmap_bank,
                                                   bank_x=bank_x, gather="epoch" if epochwise else "step",
                                                   bcfg=bcfg, tcfg=tcfg, epochs=epochs, perm_span=perm_span)
    if fused:
        with torch.no_grad():
            return finish(_adapt_block_fused(p0, bank_y, fmap_bank, gens, bcfg=bcfg, tcfg=tcfg, icfg=icfg,
                                             schedule=schedule))
    if epochwise:
        perms = None
        if schedule is not None:  # the explicit schedule's permutations, its pad positions cut
            perms = schedule[0].reshape(lanes, icfg.epochs, icfg.padded)[:, :, : icfg.bank_size]
        banks = {"x": fmap_bank[:, : icfg.bank_size], "y": bank_y[: icfg.bank_size].expand(lanes, -1)}
        return finish(inner_fit_epochwise(loss_fn, p0, tx, gens, icfg, banks, perms=perms))
    if tcfg.inner_carry == "flat":
        return finish(_fit_flat(loss_fn, p0, tx, gens, icfg, schedule, dev, lanes))
    return finish(inner_fit(loss_fn, p0, tx, gens, icfg, schedule=schedule, device=dev))


@torch.no_grad()
def _embed_episodes(params, stats, episodes: torch.Tensor, *, bcfg, spec: EpisodeSpec, block=None,
                    train: bool = True) -> torch.Tensor:
    """Clean-episode features ``[E, n_way, s+q, feat]`` of ``E`` lanes, with
    batch-stats BN over each lane's images (finetune.py:306), or the running
    statistics when ``train`` is False (``--freeze_backbone``).  ``block``:
    the lanes' adapted final blocks (lane-stacked) in place of the
    backbone's own."""
    lanes = episodes.shape[0]
    flat = episodes.reshape((lanes * spec.total,) + tuple(episodes.shape[3:]))
    groups = lanes if train else 1
    if block is None:
        feats, _ = bb.apply_backbone(params, stats, flat, cfg=bcfg, train=train, bn_groups=groups)
    else:
        trunk_p, _ = bb.adapt_split(params)
        trunk_s, block_s = bb.adapt_split(stats)
        fmap = bb.apply_trunk(trunk_p, trunk_s, flat, cfg=bcfg, train=train, bn_groups=groups)
        feats = bb.apply_final_block_lanes(block, block_s, fmap.reshape((lanes, spec.total) + tuple(fmap.shape[1:])),
                                           cfg=bcfg, train=train)
    return feats.reshape(lanes, spec.n_way, spec.n_per_class, -1)


def _finetune_features(backbone_params, backbone_stats, episodes, supports, gens, *, bcfg, spec: EpisodeSpec,
                       tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None,
                       member: str = "gnn") -> torch.Tensor:
    """The head-agnostic core of the reference's ``finetune()``
    (finetune.py:182-306), shared by the GNN, ProtoNet and DampNet members,
    for ``E`` lanes: the support banks, ``fine_tune_epochs`` of batch-5 Adam
    on each lane's final block (features-as-logits inner loss), then each
    clean episode embedded by its adapted backbone with batch-stats BN.
    Returns ``[E, n_way, s+q, feat]``.  ``supports``: the raw supports
    (episode mode) or the lanes' replica banks (minibatch mode);
    ``member`` names the profiler ranges."""
    with span(f"bank_fmap:{member}"):
        fmap, bank_x, n_rep = _member_bank(backbone_params, backbone_stats, supports, gens, bcfg=bcfg, tcfg=tcfg,
                                           aug_cfg=aug_cfg, gen_examples=gen_examples)
    bank_y = bank_labels(spec, n_rep, supports.device)
    with span(f"adapt:{member}"):
        block, _ = _adapt_block(backbone_params, backbone_stats, bank_y, gens, bcfg=bcfg, tcfg=tcfg,
                                epochs=tcfg.fine_tune_epochs, fmap_bank=fmap, bank_x=bank_x, schedule=inner_schedule)
    with span(f"embed:{member}"):
        return _embed_episodes(backbone_params, backbone_stats, episodes, bcfg=bcfg, spec=spec, block=block)


def _frozen_features(backbone_params, backbone_stats, episodes, *, bcfg, spec, member: str, train: bool):
    with span(f"embed:{member}"):
        return _embed_episodes(backbone_params, backbone_stats, episodes, bcfg=bcfg, spec=spec, train=train)


def gnn_member_lanes(backbone_params, backbone_stats, head, episodes, supports, gens, *, bcfg, gcfg: GnnNetCfg,
                     spec: EpisodeSpec, tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None):
    """finetune() with the GNN head (finetune.py:182-328) for ``E`` lanes ->
    softmax scores ``[E, n_way * n_query, n_way]``.  ``--freeze_backbone``
    adapts nothing (the inner loss trains nothing the scores read) and
    embeds with running statistics (JAX ``gnn_member_scores``)."""
    if tcfg.freeze_backbone:
        feats = _frozen_features(backbone_params, backbone_stats, episodes, bcfg=bcfg, spec=spec, member="gnn",
                                 train=False)
    else:
        feats = _finetune_features(backbone_params, backbone_stats, episodes, supports, gens, bcfg=bcfg, spec=spec,
                                   tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples,
                                   inner_schedule=inner_schedule)
    with torch.no_grad(), span("score:gnn"):
        return torch.softmax(gnn_scores(head, feats, gcfg, spec.n_query), dim=-1)


def proto_member_lanes(backbone_params, backbone_stats, episodes, supports, gens, *, bcfg, spec: EpisodeSpec,
                       tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None):
    """finetune() with the ProtoNet head (``--method protonet``,
    finetune.py:441-442,619; protonet.py:30-39) for ``E`` lanes: the GNN
    member's block adaptation (finetune() is head-agnostic), scored by
    negative squared distances to the adapted support prototypes."""
    if tcfg.freeze_backbone:
        feats = _frozen_features(backbone_params, backbone_stats, episodes, bcfg=bcfg, spec=spec, member="protonet",
                                 train=False)
    else:
        feats = _finetune_features(backbone_params, backbone_stats, episodes, supports, gens, bcfg=bcfg, spec=spec,
                                   tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples,
                                   inner_schedule=inner_schedule, member="protonet")
    with torch.no_grad(), span("score:protonet"):
        ns = spec.n_support
        return torch.softmax(proto_scores(feats[:, :, :ns], feats[:, :, ns:], spec), dim=-1)


def _draw_heads(gens, feat_dim: int, n_way: int, device, dtype=torch.float32):
    """Each lane's classifier init, drawn from its generator."""
    heads = [init_classifier(g, feat_dim, n_way, zero_bias=False, dtype=dtype, device=device) for g in gens]
    return {k: torch.stack([h[k] for h in heads]) for k in heads[0]}


def _linear_scores(head, feats, spec: EpisodeSpec):
    with torch.no_grad(), span("score:linear"):
        q_feats = feats[:, :, spec.n_support :].reshape(feats.shape[0], spec.query_size, -1)
        return torch.softmax(classifier_logits(head, q_feats), dim=-1)


def linear_member_lanes(backbone_params, backbone_stats, episodes, supports, gens, *, bcfg, spec: EpisodeSpec,
                        tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None, head0=None):
    """finetune_linear (finetune.py:45-174) for ``E`` lanes -> softmax
    scores ``[E, q, n_way]``.  Trains on the clean support only: in the
    episode mode no augmented group is built; in the minibatch mode the
    steps stay on replica 0.  ``head0``: explicit lane-stacked classifier
    init instead of the draws from ``gens``."""
    dev = supports.device
    if head0 is None:
        head0 = _draw_heads(gens, bcfg.feat_dim, spec.n_way, dev)
    with span("bank_fmap:linear"):
        fmap, bank_x, n_rep = _member_bank(backbone_params, backbone_stats, supports, gens, bcfg=bcfg, tcfg=tcfg,
                                           aug_cfg=aug_cfg, gen_examples=gen_examples, clean_only=True)
    bank_y = bank_labels(spec, n_rep, dev)
    with span("adapt:linear"):
        block, head = _adapt_block(backbone_params, backbone_stats, bank_y, gens, bcfg=bcfg, tcfg=tcfg,
                                   epochs=tcfg.linear_epochs, head=head0, perm_span=spec.support_size,
                                   fmap_bank=fmap, bank_x=bank_x, schedule=inner_schedule)
    with span("embed:linear"):
        feats = _embed_episodes(backbone_params, backbone_stats, episodes, bcfg=bcfg, spec=spec, block=block,
                                train=not tcfg.freeze_backbone)
    return _linear_scores(head, feats, spec)


def dampnet_probe_lanes(damp_params, damp_state, feats, gens, *, dcfg, spec: EpisodeSpec, schedule=None, head0=None):
    """The linear probe of ``set_forward_adaptation_full``
    (dampnet_full_class.py:471-548) for ``E`` lanes ``feats [E, n_way, s+q,
    f]``: recover each episode's features from its class statistics,
    project them to ``gnn_dim``, train a linear head on the support's
    projections (100 epochs of batch 4, the reference's SGD), all lanes in
    one lane-stacked loop of 700 steps.  Each lane draws its head init, then
    its schedule, from its own generator, as one lane alone does.  Returns
    ``(heads, query projections [E, q, gnn_dim])``, lane-stacked.
    ``schedule`` (``[E, T, B]`` indices) / ``head0``: explicit lane-stacked
    minibatch order and head init instead of draws from ``gens``."""
    dev, n_lanes = feats.device, feats.shape[0]
    with torch.no_grad():
        proj = recovered_projection(damp_params, damp_state, feats, dcfg)
    z_support = proj[:, :, : spec.n_support].reshape(n_lanes, spec.support_size, -1)
    y_support = support_labels(spec, dev)
    if head0 is None:
        head0 = _draw_heads(gens, dcfg.gnn_dim, spec.n_way, dev, dtype=proj.dtype)
    lanes = torch.arange(n_lanes, device=dev)[:, None]

    def loss_fn(p, idx, w):
        return ce_loss(classifier_logits(p, z_support[lanes, idx]), y_support[idx], w)

    icfg = InnerLoopCfg(epochs=100, batch_size=4, bank_size=spec.support_size)
    head = inner_fit(loss_fn, head0, opt.reference_probe_sgd(0.01), gens, icfg, schedule=schedule, device=dev)
    return head, proj[:, :, spec.n_support :].reshape(n_lanes, spec.query_size, -1)


def dampnet_probe(damp_params, damp_state, feats, gen, *, dcfg, spec: EpisodeSpec, schedule=None, head0=None):
    """:func:`dampnet_probe_lanes` of one episode ``feats [n_way, s+q, f]``
    -> ``(head, query projections [q, gnn_dim])``; ``schedule`` ``(idx [T,
    B], w)`` / ``head0``: explicit instead of draws from ``gen``."""
    head, z_query = dampnet_probe_lanes(damp_params, damp_state, feats[None], [gen], dcfg=dcfg, spec=spec,
                                        schedule=None if schedule is None else stack_schedules([schedule]),
                                        head0=None if head0 is None else _stack1(head0))
    return _lane(head, 0), z_query[0]


def dampnet_member_lanes(backbone_params, backbone_stats, damp_params, damp_state, episodes, supports, gens, *,
                         bcfg, dcfg, spec: EpisodeSpec, tcfg: TransferCfg, aug_cfg, gen_examples: int = 0,
                         eval_mode: str = "finetune", with_linear_fusion: bool = True, unsup_stats=None,
                         inner_schedule=None) -> torch.Tensor:
    """DampNet's eval for ``E`` lanes -> softmax scores ``[E, n_way *
    n_query, n_way]``, in one of four compositions (JAX eval_engine.py:711-813):

    * ``eval_mode='finetune'`` (the live one, the 50-shot driver's
      ``finetune(..., ds=True)``, finetune_50.py:589-687): the final block
      adapted on the support bank exactly as for the GNN member
      (``_finetune_features``, so ``--inner_scan fused`` and ``--bn_mode
      minibatch`` apply), then the adapted features scored in the
      'domain_shift' mode; with ``--freeze_backbone`` nothing adapts and the
      frozen backbone embeds with its running statistics (finetune.py:265-266);
    * ``eval_mode='nofinetune'`` (finetune.py:331-417): the frozen backbone's
      features scored in the 'domain_shift' mode, plus half the softmax of
      the probe of :func:`dampnet_probe` when ``with_linear_fusion``;
    * ``unsup_stats=(mean, std)`` (``--unsupervised``, set_forward_unsup,
      dampnet_full.py:298-348): the frozen backbone's features recovered
      from an unlabeled dataset's statistics, no probe.

    Every phase runs all lanes at once: one :func:`dampnet_scores` call
    (the recovery network and the GNN) and one probe loop
    (:func:`dampnet_probe_lanes`) a batch.  The reference's 5-shot driver
    reaches ``set_forward`` without ``domain_shift`` and fails there (README
    "Faithfully reproduced quirks"); the 50-shot composition serves every
    shot count, as in JAX."""
    if eval_mode not in ("finetune", "nofinetune"):
        raise ValueError(f"eval_mode must be 'finetune' or 'nofinetune', not {eval_mode!r}")
    live = unsup_stats is None and eval_mode == "finetune" and not tcfg.freeze_backbone
    if live:
        feats = _finetune_features(backbone_params, backbone_stats, episodes, supports, gens, bcfg=bcfg, spec=spec,
                                   tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples,
                                   inner_schedule=inner_schedule, member="dampnet")
    else:  # nofinetune never leaves train mode; the frozen finetune composition runs in eval()
        frozen = unsup_stats is None and eval_mode == "finetune"
        feats = _frozen_features(backbone_params, backbone_stats, episodes, bcfg=bcfg, spec=spec, member="dampnet",
                                 train=not frozen)
    mode, kw = ("unsup", {"unsup_stats": unsup_stats}) if unsup_stats is not None else ("domain_shift", {})
    with torch.no_grad(), span("score:dampnet"):
        out = torch.softmax(dampnet_scores(damp_params, damp_state, feats, dcfg, spec.n_query, mode=mode, **kw), dim=-1)
    if unsup_stats is not None or eval_mode == "finetune" or not with_linear_fusion:
        return out
    with span("score:dampnet"):
        head, z_query = dampnet_probe_lanes(damp_params, damp_state, feats, gens, dcfg=dcfg, spec=spec)
        with torch.no_grad():  # the probe's softmax, halved (finetune.py:411)
            return out + torch.softmax(classifier_logits(head, z_query), dim=-1) / 2.0


def ensemble_lanes(baseline_params, baseline_stats, gnn_params, gnn_stats, gnn_head, episodes, supports, gens, *,
                   bcfg, gcfg, spec, tcfg, aug_cfg, gen_examples: int = 0, inner_schedule=None, head0=None):
    """--method all for ``E`` lanes: softmax(linear member) + softmax(GNN
    member), on the same support banks (finetune.py:648-650); the members
    run back to back, or with ``ensemble_fuse='lane'`` their inner loops
    step together (:func:`_fused_ensemble_lanes`).  ``inner_schedule``:
    explicit lane-stacked ``(linear, gnn)`` schedules, and ``head0`` the
    linear member's classifier init, instead of the draws from ``gens``."""
    kw = dict(bcfg=bcfg, spec=spec, tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples)
    sched_lin, sched_gnn = (None, None) if inner_schedule is None else inner_schedule
    if (tcfg.ensemble_fuse == "lane" and supports.dim() == 6 and not tcfg.freeze_backbone
            and tcfg.inner_gather == "step" and tcfg.inner_carry == "tree" and tcfg.inner_scan == "eager"):
        return _fused_ensemble_lanes(baseline_params, baseline_stats, gnn_params, gnn_stats, gnn_head, episodes,
                                     supports, gens, gcfg=gcfg, sched_lin=sched_lin, sched_gnn=sched_gnn, head0=head0,
                                     **kw)
    s_lin = linear_member_lanes(baseline_params, baseline_stats, episodes, supports, gens, inner_schedule=sched_lin,
                                head0=head0, **kw)
    s_gnn = gnn_member_lanes(gnn_params, gnn_stats, gnn_head, episodes, supports, gens, gcfg=gcfg,
                             inner_schedule=sched_gnn, **kw)
    return s_lin + s_gnn


def _fused_ensemble_lanes(baseline_params, baseline_stats, gnn_params, gnn_stats, gnn_head, episodes, supports, gens,
                          *, bcfg, gcfg, spec, tcfg, aug_cfg, gen_examples: int = 0, sched_lin=None, sched_gnn=None,
                          head0=None):
    """``ensemble_fuse='lane'`` (JAX ``_fused_ensemble_scores``,
    eval_engine.py:638-708): both members' inner loops in one
    ``inner_fit_pair``.  Banks, draws (each lane: the classifier init, the
    linear schedule, the augment parameters, the GNN schedule, in the
    sequential order; each given explicitly is not drawn), update math and
    scoring mirror the sequential members, so the scores are the same
    numbers."""
    dev = supports.device
    if head0 is None:
        head0 = _draw_heads(gens, bcfg.feat_dim, spec.n_way, dev)
    with span("bank_fmap:linear"):
        fmap_lin, _, n_lin = _member_bank(baseline_params, baseline_stats, supports, gens, bcfg=bcfg, tcfg=tcfg,
                                          aug_cfg=aug_cfg, gen_examples=gen_examples, clean_only=True)
    p_lin, loss_lin, tx_lin, icfg_lin, fin_lin = _prepare_adapt(
        baseline_params, baseline_stats, bank_labels(spec, n_lin, dev), bcfg=bcfg, tcfg=tcfg,
        epochs=tcfg.linear_epochs, head=head0, perm_span=spec.support_size, fmap_bank=fmap_lin)
    if sched_lin is None and icfg_lin.epochs:
        sched_lin = lane_schedule(gens, icfg_lin, dev)
    with span("bank_fmap:gnn"):
        fmap_gnn, _, n_gnn = _member_bank(gnn_params, gnn_stats, supports, gens, bcfg=bcfg, tcfg=tcfg,
                                          aug_cfg=aug_cfg, gen_examples=gen_examples)
    p_gnn, loss_gnn, tx_gnn, icfg_gnn, fin_gnn = _prepare_adapt(
        gnn_params, gnn_stats, bank_labels(spec, n_gnn, dev), bcfg=bcfg, tcfg=tcfg, epochs=tcfg.fine_tune_epochs,
        head=None, fmap_bank=fmap_gnn)
    if sched_gnn is None and icfg_gnn.epochs:
        sched_gnn = lane_schedule(gens, icfg_gnn, dev)
    with span("adapt:pair"):
        a_lin, a_gnn = inner_fit_pair(loss_lin, p_lin, tx_lin, gens, icfg_lin, loss_gnn, p_gnn, tx_gnn, gens, icfg_gnn,
                                      schedule_a=sched_lin, schedule_b=sched_gnn, device=dev)
    lin_block, lin_head = fin_lin(a_lin)
    gnn_block, _ = fin_gnn(a_gnn)
    with span("embed:linear"):
        feats_b = _embed_episodes(baseline_params, baseline_stats, episodes, bcfg=bcfg, spec=spec, block=lin_block)
    s_lin = _linear_scores(lin_head, feats_b, spec)
    with span("embed:gnn"):
        feats_g = _embed_episodes(gnn_params, gnn_stats, episodes, bcfg=bcfg, spec=spec, block=gnn_block)
    with torch.no_grad(), span("score:gnn"):
        return s_lin + torch.softmax(gnn_scores(gnn_head, feats_g, gcfg, spec.n_query), dim=-1)


# --------------------------------------------------------------------------
# one episode: the lane members on a batch of one
# --------------------------------------------------------------------------


def _one(lanes_fn, *models, episode, support_bank, gen, inner_schedule=None, head0=None, **kw):
    if inner_schedule is not None:
        kw["inner_schedule"] = stack_schedules([inner_schedule])
    if head0 is not None:
        kw["head0"] = _stack1(head0)
    supports = None if support_bank is None else support_bank[None]  # the frozen compositions read none
    return lanes_fn(*models, episode[None], supports, [gen], **kw)[0]


def gnn_member_scores(backbone_params, backbone_stats, head, episode, support_bank, gen, **kw):
    """:func:`gnn_member_lanes` of one episode -> ``[n_way * n_query, n_way]``.
    ``support_bank``: raw support ``[n_way, n_support, 3, H0, W0]`` (episode
    mode) or the replica bank ``[R, n_way, n_support, 3, S, S]`` (minibatch
    mode); ``inner_schedule``: explicit ``(idx, w)`` instead of the draw
    from ``gen``."""
    return _one(gnn_member_lanes, backbone_params, backbone_stats, head, episode=episode,
                support_bank=support_bank, gen=gen, **kw)


def proto_member_scores(backbone_params, backbone_stats, episode, support_bank, gen, **kw):
    """:func:`proto_member_lanes` of one episode."""
    return _one(proto_member_lanes, backbone_params, backbone_stats, episode=episode, support_bank=support_bank,
                gen=gen, **kw)


def linear_member_scores(backbone_params, backbone_stats, episode, support_bank, gen, **kw):
    """:func:`linear_member_lanes` of one episode; ``head0``: explicit
    classifier init instead of the draw from ``gen``."""
    return _one(linear_member_lanes, backbone_params, backbone_stats, episode=episode, support_bank=support_bank,
                gen=gen, **kw)


def dampnet_member_scores(backbone_params, backbone_stats, damp_params, damp_state, episode, support_bank, gen, **kw):
    """:func:`dampnet_member_lanes` of one episode."""
    return _one(dampnet_member_lanes, backbone_params, backbone_stats, damp_params, damp_state, episode=episode,
                support_bank=support_bank, gen=gen, **kw)


def ensemble_episode_scores(baseline_params, baseline_stats, gnn_params, gnn_stats, gnn_head, episode, support_bank,
                            gen, **kw):
    """:func:`ensemble_lanes` of one episode."""
    return _one(ensemble_lanes, baseline_params, baseline_stats, gnn_params, gnn_stats, gnn_head, episode=episode,
                support_bank=support_bank, gen=gen, **kw)


def episode_accuracy(scores: torch.Tensor, spec: EpisodeSpec) -> float:
    """Top-1 accuracy (%) against y_query (finetune.py:625-631)."""
    y = query_labels(spec, scores.device)
    return float((scores.argmax(dim=1) == y).float().mean()) * 100.0


def lane_accuracies(scores: torch.Tensor, spec: EpisodeSpec) -> list:
    """:func:`episode_accuracy` of each lane of ``scores [E, q, n_way]``,
    with one transfer to the host."""
    y = query_labels(spec, scores.device)
    return [v * 100.0 for v in (scores.argmax(dim=-1) == y).float().mean(dim=-1).tolist()]


def mean_ci95(acc_all) -> tuple:
    """Mean and 1.96*std/sqrt(n) (finetune.py:678-682)."""
    acc_all = np.asarray(acc_all)
    return float(acc_all.mean()), float(1.96 * acc_all.std() / np.sqrt(len(acc_all)))


#: the eval methods of the port
METHODS = ("all", "gnnnet", "gnnnet_maml", "baseline", "protonet", "dampnet", "dampnet_full", "dampnet_full_class")


def make_eval_program(*, method: str, bcfg, gcfg: Optional[GnnNetCfg], spec: EpisodeSpec, tcfg: TransferCfg,
                      aug_cfg, gen_examples: int, dcfg=None, dampnet_eval: str = "finetune"):
    """The episode-batched eval: ``fn(models, base_episodes, gens) ->
    (scores [E, q, n_way], accs [E])`` with ``base_episodes`` uint8 ``[E,
    n_way, s+q, 3, H0, W0]`` on the device, ``gens`` one generator per
    episode, and ``models`` holding what ``method`` reads:
    ``baseline=(params, stats)`` (``all``, ``baseline``), ``gnn=(params,
    stats, head)`` (``all``, ``gnnnet``, ``gnnnet_maml``),
    ``protonet=(params, stats)`` or ``dampnet=(params, stats, damp_params,
    damp_state)`` (with ``dcfg`` and ``dampnet_eval``; ``unsup_stats=(mean,
    std)`` selects the unsupervised composition).  The ``E`` episodes run
    as lanes of one batch in both BN modes; the minibatch mode builds each
    lane's replica bank once for both members of ``--method all``.  ``fn(...,
    inner_schedule=, head0=)`` take the member's lane-stacked ``(idx, w)``
    schedule (for ``all`` the pair ``(linear, gnn)``) and the linear
    member's classifier init in place of their draws from ``gens``."""
    if method not in METHODS:
        raise ValueError(f"the port evaluates --method {'|'.join(METHODS)}, not {method!r}")
    _check_modes(tcfg)

    def run(models, base: torch.Tensor, gens, draws):
        dt = pipeline_dtype(bcfg.compute_dtype)
        with torch.no_grad():
            episodes = center_batch(base, aug_cfg.image_size, dtype=dt)
            supports = base[:, :, : spec.n_support]
            if tcfg.bn_mode == "minibatch":
                with span("bank_fmap:replicas"):
                    supports = torch.stack([make_eval_replicas(g, s, aug_cfg, gen_examples)
                                            for g, s in zip(gens, supports)])
        kw = dict(bcfg=bcfg, spec=spec, tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples, **draws)
        if method == "all":
            return ensemble_lanes(*models["baseline"], *models["gnn"], episodes, supports, gens, gcfg=gcfg, **kw)
        if method in ("gnnnet", "gnnnet_maml"):
            return gnn_member_lanes(*models["gnn"], episodes, supports, gens, gcfg=gcfg, **kw)
        if method == "protonet":
            return proto_member_lanes(*models["protonet"], episodes, supports, gens, **kw)
        if method.startswith("dampnet"):
            return dampnet_member_lanes(*models["dampnet"], episodes, supports, gens, dcfg=dcfg,
                                        eval_mode=dampnet_eval, unsup_stats=models.get("unsup_stats"), **kw)
        return linear_member_lanes(*models["baseline"], episodes, supports, gens, **kw)

    def program(models, base_episodes: torch.Tensor, gens, inner_schedule=None, head0=None):
        if len(gens) != base_episodes.shape[0]:
            raise ValueError(f"{base_episodes.shape[0]} episodes need as many generators, got {len(gens)}")
        draws = {k: v for k, v in (("inner_schedule", inner_schedule), ("head0", head0)) if v is not None}
        scores = run(models, base_episodes, gens, draws)
        return scores, lane_accuracies(scores, spec)

    return program
