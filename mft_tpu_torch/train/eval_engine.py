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

The episodes run one at a time; every draw (augment parameters, classifier
init, minibatch order) comes from the ``torch.Generator`` passed in.

Each phase of a member runs inside a ``torch.profiler.record_function``
range named in :data:`PHASES` (``<phase>:<member>``), so a profile of one
episode splits its host and device time by phase (chip_smoke.py reads
them); without a profiler each range is one cheap host call, eight or nine
per episode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from mft_tpu_torch.core.episode import EpisodeSpec, flatten_episode, query_labels, support_labels
from mft_tpu_torch.kernels import fused_inner_scan as fis
from mft_tpu_torch.methods.baseline import ce_loss, classifier_logits, init_classifier
from mft_tpu_torch.methods.dampnet import dampnet_scores, recovered_projection
from mft_tpu_torch.methods.gnnnet import GnnNetCfg, gnn_scores
from mft_tpu_torch.methods.protonet import proto_scores
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.ops.augment import augment_batch, center_batch, make_eval_replicas, pipeline_dtype, to_float
from mft_tpu_torch.train import optimizers as opt
from mft_tpu_torch.train.inner_loop import InnerLoopCfg, inner_fit, minibatch_schedule


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


def bank_labels(spec: EpisodeSpec, replicas: int, device="cpu") -> torch.Tensor:
    """Labels of the stacked support bank: ``[replicas * n_way * n_support]``."""
    return support_labels(spec, device).repeat(replicas)


def _bank_images(replicas: torch.Tensor) -> torch.Tensor:
    """``[R, n_way, n_support, 3, S, S]`` -> ``[R * n_way * n_support, 3, S, S]``."""
    return replicas.reshape((-1,) + tuple(replicas.shape[3:]))


@torch.no_grad()
def _bank_fmap(trunk_p, trunk_s, support_base: torch.Tensor, gen: Optional[torch.Generator], *,
               bcfg: bb.ResNetCfg, aug_cfg, gen_examples: int, clean_only: bool = False) -> torch.Tensor:
    """Frozen-trunk feature maps of the support bank ``[span, C, h, w]``.

    ``support_base [n_way, n_support, 3, H0, W0]`` (uint8).  One replica
    group (a whole support set) at a time is augmented, pushed through the
    trunk with its own batch statistics (sub-chunked at <= 128 images) and
    dropped, so only the feature bank stays resident.  Order: clean x3,
    then the ``gen_examples`` augmented groups (finetune.py:93,225-233);
    ``clean_only`` returns the one clean group (the linear member)."""
    dt = pipeline_dtype(bcfg.compute_dtype)
    support = to_float(support_base, dt)
    n = support.shape[0] * support.shape[1]
    chunk = next(c for c in range(min(n, 128), 0, -1) if n % c == 0)

    def trunk_of(imgs):
        flat = imgs.reshape((n,) + tuple(imgs.shape[2:]))
        parts = [bb.apply_trunk(trunk_p, trunk_s, flat[i : i + chunk], cfg=bcfg, train=True) for i in range(0, n, chunk)]
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    clean = trunk_of(center_batch(support, aug_cfg.image_size, dtype=dt))
    if clean_only:
        return clean
    groups = [clean, clean, clean]
    groups += [trunk_of(augment_batch(gen, support, aug_cfg, dtype=dt)) for _ in range(gen_examples)]
    return torch.cat(groups)


def _member_bank(backbone_params, backbone_stats, support_bank, gen, *, bcfg, aug_cfg, gen_examples: int,
                 clean_only: bool = False):
    """One member's bank ``(fmap_bank, bank_x, n_replicas)`` for
    :func:`_adapt_block`.  A raw support ``[n_way, n_support, 3, H0, W0]``
    (episode mode) becomes the frozen trunk's feature bank; a replica bank
    ``[R, n_way, n_support, 3, S, S]`` (minibatch mode) stays images, whole:
    ``clean_only`` does not cut it, the linear member's ``perm_span`` keeps
    its steps on replica 0, the clean group (eval_engine.py:417-432 of the
    JAX package)."""
    if support_bank.dim() == 6:
        return None, _bank_images(support_bank), support_bank.shape[0]
    trunk_p, _ = bb.adapt_split(backbone_params)
    trunk_s, _ = bb.adapt_split(backbone_stats)
    fmap = _bank_fmap(trunk_p, trunk_s, support_bank, gen, bcfg=bcfg, aug_cfg=aug_cfg, gen_examples=gen_examples,
                      clean_only=clean_only)
    return fmap, None, (1 if clean_only else gen_examples + 3)


def _prepare_adapt(params, stats, bank_y, *, bcfg: bb.ResNetCfg, tcfg: TransferCfg, epochs: int,
                   head: Optional[dict], perm_span: Optional[int] = None, fmap_bank: Optional[torch.Tensor] = None,
                   bank_x: Optional[torch.Tensor] = None):
    """One member's inner-loop task ``(p0, loss_fn, tx, icfg, finish)`` with
    ``finish(adapted) -> (block, head)``: the adapted tree is the final
    block (GNN member) or ``{"adapt": block, "head": head}`` (linear member).
    Exactly one bank is given: ``fmap_bank`` (each step gathers its rows of
    the trunk's feature bank and runs the final block) or ``bank_x`` (each
    step gathers its images and runs the whole backbone, batch statistics
    masked by the step's weights in every BN layer; the trunk is a constant,
    so only the block and the head get gradients)."""
    if (fmap_bank is None) == (bank_x is None):
        raise ValueError("give exactly one of fmap_bank (episode BN mode) and bank_x (minibatch BN mode)")
    trunk_p, block_p = bb.adapt_split(params)
    _, block_s = bb.adapt_split(stats)
    bank = fmap_bank if fmap_bank is not None else bank_x
    span = perm_span if perm_span is not None else bank.shape[0]
    icfg = InnerLoopCfg(epochs=epochs, batch_size=tcfg.batch_size, bank_size=span)
    if tcfg.inner_param_dtype != "float32":
        pd = getattr(torch, tcfg.inner_param_dtype)
        cast = lambda t: {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.to(pd)
        block_p = cast(block_p)
        head = cast(head) if head is not None else None

    def features_of(block, idx, w):
        if fmap_bank is not None:
            return bb.apply_final_block(block, block_s, fmap_bank[idx], cfg=bcfg, train=True, sample_mask=w)
        feats, _ = bb.apply_backbone(bb.adapt_merge(trunk_p, block), stats, bank_x[idx], cfg=bcfg, train=True,
                                     sample_mask=w)
        return feats

    adam = opt.torch_adam if tcfg.opt_state_dtype == "float32" else opt.torch_adam_lowmem
    if head is None:
        # GNN member: CE on the raw features as logits (finetune.py:286-291)
        def loss_fn(p, idx, w):
            return ce_loss(features_of(p, idx, w), bank_y[idx], w)

        return block_p, loss_fn, adam(tcfg.inner_lr), icfg, lambda a: (a, None)

    # linear member: block + head train (finetune.py:123-124,144-164)
    tx = opt.grouped({"adapt": adam(tcfg.inner_lr), "head": adam(tcfg.inner_lr, tcfg.head_wd)},
                     {"adapt": "adapt", "head": "head"})

    def loss_fn(p, idx, w):
        return ce_loss(classifier_logits(p["head"], features_of(p["adapt"], idx, w)), bank_y[idx], w)

    return {"adapt": block_p, "head": head}, loss_fn, tx, icfg, lambda a: (a["adapt"], a["head"])


def _adapt_block_fused(block_p, bank_y, fmap_bank, gen, *, bcfg, tcfg, icfg: InnerLoopCfg, schedule=None):
    """The GNN member's inner loop through the fused scan: the same
    schedule draw as ``inner_fit`` (so both choices see the same
    minibatches), one kernel call for all steps, and the adapted block back
    in the port's layout and the carry dtype."""
    if tcfg.opt_state_dtype != "bfloat16":
        raise ValueError("inner_scan='fused' stores its Adam moments in bfloat16; "
                         f"opt_state_dtype={tcfg.opt_state_dtype!r} needs inner_scan='eager'")
    half_res = len(bcfg.stage_sizes) > 1 and bcfg.stage_sizes[-1] == 1
    if set(block_p) != {"conv1", "bn1", "conv2", "bn2", "conv_sc", "bn_sc"} or bcfg.stage_sizes[-1] != 1:
        raise ValueError("inner_scan='fused' adapts a single final SimpleBlock with a 1x1 shortcut conv; "
                         f"this backbone's final stage has {bcfg.stage_sizes[-1]} block(s) with keys {sorted(block_p)}")
    if fmap_bank.shape[2] != fmap_bank.shape[3] or fmap_bank.shape[2] % (2 if half_res else 1):
        raise ValueError(f"inner_scan='fused' needs a square feature map that the stride divides, got {tuple(fmap_bank.shape)}")
    if icfg.epochs == 0:
        return block_p
    c_out, c_in = block_p["conv1"].shape[:2]
    geom = fis.BlockGeom(h_in=fmap_bank.shape[2], c_in=c_in, c_out=c_out, stride=2 if half_res else 1,
                         batch=icfg.batch_size)
    dev = fmap_bank.device
    idx, w = schedule if schedule is not None else minibatch_schedule(gen, icfg, dev)
    adapted = fis.fused_inner_scan(fis.block_to_flat(block_p), fis.bank_to_nhwc(fmap_bank), bank_y, idx.to(dev), w.to(dev),
                                   geom=geom, lr=tcfg.inner_lr)
    return fis.flat_to_block(adapted, geom)


def _check_modes(tcfg: TransferCfg):
    if tcfg.inner_scan not in ("eager", "fused"):
        raise ValueError(f"inner_scan must be 'eager' or 'fused', not {tcfg.inner_scan!r}")
    if tcfg.bn_mode not in ("episode", "minibatch"):
        raise ValueError(f"bn_mode must be 'episode' or 'minibatch', not {tcfg.bn_mode!r}")
    if tcfg.inner_scan == "fused" and tcfg.bn_mode == "minibatch":
        raise ValueError("inner_scan='fused' scans the final block over the episode BN mode's frozen-trunk feature "
                         "bank; bn_mode='minibatch' runs the whole backbone every step and needs inner_scan='eager'")


def _adapt_block(params, stats, bank_y, gen, *, bcfg, tcfg, epochs, head=None, perm_span=None, fmap_bank=None,
                 bank_x=None, schedule=None):
    """Fine-tune the final block (and the optional head) on one bank (see
    :func:`_prepare_adapt`).  ``perm_span``: the permutations cover only
    the first rows (the linear member's clean-support-only quirk).  Returns
    ``(block, head)``.  ``tcfg.inner_scan == 'fused'`` sends the head-less
    (GNN) member through the fused scan; with a head the loop stays eager."""
    _check_modes(tcfg)
    if tcfg.inner_scan == "fused" and bank_x is not None:
        raise ValueError("inner_scan='fused' needs a feature bank (bn_mode='episode')")
    p0, loss_fn, tx, icfg, finish = _prepare_adapt(
        params, stats, bank_y, bcfg=bcfg, tcfg=tcfg, epochs=epochs, head=head, perm_span=perm_span,
        fmap_bank=fmap_bank, bank_x=bank_x,
    )
    bank = fmap_bank if fmap_bank is not None else bank_x
    if tcfg.inner_scan == "fused" and head is None:
        with torch.no_grad():
            return finish(_adapt_block_fused(p0, bank_y, fmap_bank, gen, bcfg=bcfg, tcfg=tcfg, icfg=icfg,
                                             schedule=schedule))
    return finish(inner_fit(loss_fn, p0, tx, gen, icfg, schedule=schedule, device=bank.device))


@torch.no_grad()
def _embed_episode(params, stats, episode: torch.Tensor, *, bcfg, spec: EpisodeSpec) -> torch.Tensor:
    """Clean-episode features ``[n_way, s+q, feat]`` with batch-stats BN over
    every image (finetune.py:306)."""
    feats, _ = bb.apply_backbone(params, stats, flatten_episode(episode), cfg=bcfg, train=True)
    return feats.reshape(spec.n_way, spec.n_per_class, -1)


def _finetune_features(backbone_params, backbone_stats, episode, support_bank, gen, *, bcfg, spec: EpisodeSpec,
                       tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None,
                       member: str = "gnn") -> torch.Tensor:
    """The head-agnostic core of the reference's ``finetune()``
    (finetune.py:182-306), shared by the GNN, ProtoNet and DampNet members: the
    support bank, ``fine_tune_epochs`` of batch-5 Adam on the final block
    (features-as-logits inner loss), then the clean episode embedded by the
    adapted backbone with batch-stats BN.  Returns ``[n_way, s+q, feat]``.
    ``support_bank``: the raw support (episode mode) or the replica bank
    (minibatch mode); ``member`` names the profiler ranges."""
    with record_function(f"bank_fmap:{member}"):
        fmap, bank_x, n_rep = _member_bank(backbone_params, backbone_stats, support_bank, gen, bcfg=bcfg,
                                           aug_cfg=aug_cfg, gen_examples=gen_examples)
    bank_y = bank_labels(spec, n_rep, support_bank.device)
    with record_function(f"adapt:{member}"):
        block, _ = _adapt_block(backbone_params, backbone_stats, bank_y, gen, bcfg=bcfg, tcfg=tcfg,
                                epochs=tcfg.fine_tune_epochs, fmap_bank=fmap, bank_x=bank_x, schedule=inner_schedule)
    trunk_p, _ = bb.adapt_split(backbone_params)
    with record_function(f"embed:{member}"):
        return _embed_episode(bb.adapt_merge(trunk_p, block), backbone_stats, episode, bcfg=bcfg, spec=spec)


def gnn_member_scores(backbone_params, backbone_stats, head, episode, support_bank, gen, *, bcfg, gcfg: GnnNetCfg,
                      spec: EpisodeSpec, tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None):
    """finetune() with the GNN head (finetune.py:182-328) -> softmax scores
    ``[n_way * n_query, n_way]``.  ``support_bank``: raw support
    ``[n_way, n_support, 3, H0, W0]`` (episode mode) or the replica bank
    ``[R, n_way, n_support, 3, S, S]`` (minibatch mode); ``inner_schedule``:
    explicit ``(idx, w)`` instead of the draw from ``gen``."""
    feats = _finetune_features(backbone_params, backbone_stats, episode, support_bank, gen, bcfg=bcfg, spec=spec,
                               tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples, inner_schedule=inner_schedule)
    with torch.no_grad(), record_function("score:gnn"):
        return torch.softmax(gnn_scores(head, feats, gcfg, spec.n_query), dim=1)


def proto_member_scores(backbone_params, backbone_stats, episode, support_bank, gen, *, bcfg, spec: EpisodeSpec,
                        tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None):
    """finetune() with the ProtoNet head (``--method protonet``,
    finetune.py:441-442,619; protonet.py:30-39): the GNN member's block
    adaptation (finetune() is head-agnostic), scored by negative squared
    distances to the adapted support prototypes."""
    feats = _finetune_features(backbone_params, backbone_stats, episode, support_bank, gen, bcfg=bcfg, spec=spec,
                               tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples, inner_schedule=inner_schedule,
                               member="protonet")
    with torch.no_grad(), record_function("score:protonet"):
        return torch.softmax(proto_scores(feats[:, : spec.n_support], feats[:, spec.n_support :], spec), dim=1)


def linear_member_scores(backbone_params, backbone_stats, episode, support_bank, gen, *, bcfg, spec: EpisodeSpec,
                         tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None, head0=None):
    """finetune_linear (finetune.py:45-174) -> softmax scores.  Trains on
    the clean support only: in the episode mode no augmented group is
    built; in the minibatch mode the steps stay on replica 0.
    ``head0``: explicit classifier init instead of the draw from ``gen``."""
    trunk_p, _ = bb.adapt_split(backbone_params)
    dev = support_bank.device
    if head0 is None:
        head0 = init_classifier(gen, bcfg.feat_dim, spec.n_way, zero_bias=False, device=dev)
    with record_function("bank_fmap:linear"):
        fmap, bank_x, n_rep = _member_bank(backbone_params, backbone_stats, support_bank, gen, bcfg=bcfg,
                                           aug_cfg=aug_cfg, gen_examples=gen_examples, clean_only=True)
    bank_y = bank_labels(spec, n_rep, dev)
    with record_function("adapt:linear"):
        block, head = _adapt_block(backbone_params, backbone_stats, bank_y, gen, bcfg=bcfg, tcfg=tcfg,
                                   epochs=tcfg.linear_epochs, head=head0, perm_span=spec.support_size,
                                   fmap_bank=fmap, bank_x=bank_x, schedule=inner_schedule)
    with record_function("embed:linear"):
        feats = _embed_episode(bb.adapt_merge(trunk_p, block), backbone_stats, episode, bcfg=bcfg, spec=spec)
    with torch.no_grad(), record_function("score:linear"):
        q_feats = feats[:, spec.n_support :].reshape(spec.query_size, -1)
        return torch.softmax(classifier_logits(head, q_feats), dim=1)


def dampnet_probe(damp_params, damp_state, feats, gen, *, dcfg, spec: EpisodeSpec, schedule=None, head0=None):
    """The linear probe of ``set_forward_adaptation_full``
    (dampnet_full_class.py:471-548): recover the episode's features from its
    class statistics, project them to ``gnn_dim``, train a linear head on
    the support's projections (100 epochs of batch 4, the reference's SGD).
    Returns ``(head, query projections)``.  ``schedule`` / ``head0``:
    explicit minibatch order and head init instead of draws from ``gen``."""
    dev = feats.device
    with torch.no_grad():
        proj = recovered_projection(damp_params, damp_state, feats, dcfg)
    z_support = proj[:, : spec.n_support].reshape(spec.support_size, -1)
    y_support = support_labels(spec, dev)
    if head0 is None:
        head0 = init_classifier(gen, dcfg.gnn_dim, spec.n_way, zero_bias=False, dtype=proj.dtype, device=dev)

    def loss_fn(p, idx, w):
        return ce_loss(classifier_logits(p, z_support[idx]), y_support[idx], w)

    icfg = InnerLoopCfg(epochs=100, batch_size=4, bank_size=spec.support_size)
    head = inner_fit(loss_fn, head0, opt.reference_probe_sgd(0.01), gen, icfg, schedule=schedule, device=dev)
    return head, proj[:, spec.n_support :].reshape(spec.query_size, -1)


def dampnet_member_scores(backbone_params, backbone_stats, damp_params, damp_state, episode, support_bank, gen, *,
                          bcfg, dcfg, spec: EpisodeSpec, tcfg: TransferCfg, aug_cfg, gen_examples: int = 0,
                          eval_mode: str = "finetune", with_linear_fusion: bool = True, unsup_stats=None,
                          inner_schedule=None) -> torch.Tensor:
    """DampNet's eval -> softmax scores ``[n_way * n_query, n_way]``, in one
    of four compositions (JAX eval_engine.py:711-813):

    * ``eval_mode='finetune'`` (the live one, the 50-shot driver's
      ``finetune(..., ds=True)``, finetune_50.py:589-687): the final block
      adapted on the support bank exactly as for the GNN member
      (``_finetune_features``, so ``--inner_scan fused`` and ``--bn_mode
      minibatch`` apply), then the adapted features scored in the
      'domain_shift' mode;
    * ``eval_mode='nofinetune'`` (finetune.py:331-417): the frozen backbone's
      features scored in the 'domain_shift' mode, plus half the softmax of
      the probe of :func:`dampnet_probe` when ``with_linear_fusion``;
    * ``unsup_stats=(mean, std)`` (``--unsupervised``, set_forward_unsup,
      dampnet_full.py:298-348): the frozen backbone's features recovered
      from an unlabeled dataset's statistics, no probe.

    The reference's 5-shot driver reaches ``set_forward`` without
    ``domain_shift`` and fails there (README "Faithfully reproduced
    quirks"); the 50-shot composition serves every shot count, as in JAX."""
    if unsup_stats is not None or eval_mode == "nofinetune":
        with record_function("embed:dampnet"):
            feats = _embed_episode(backbone_params, backbone_stats, episode, bcfg=bcfg, spec=spec)
        with torch.no_grad(), record_function("score:dampnet"):
            if unsup_stats is not None:
                scores = dampnet_scores(damp_params, damp_state, feats, dcfg, spec.n_query, mode="unsup",
                                        unsup_stats=unsup_stats)
                return torch.softmax(scores, dim=1)
            out = torch.softmax(dampnet_scores(damp_params, damp_state, feats, dcfg, spec.n_query,
                                               mode="domain_shift"), dim=1)
        if not with_linear_fusion:
            return out
        with record_function("score:dampnet"):
            head, z_query = dampnet_probe(damp_params, damp_state, feats, gen, dcfg=dcfg, spec=spec)
            with torch.no_grad():  # the probe's softmax, halved (finetune.py:411)
                return out + torch.softmax(classifier_logits(head, z_query), dim=1) / 2.0
    if eval_mode != "finetune":
        raise ValueError(f"eval_mode must be 'finetune' or 'nofinetune', not {eval_mode!r}")
    feats = _finetune_features(backbone_params, backbone_stats, episode, support_bank, gen, bcfg=bcfg, spec=spec,
                               tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples, inner_schedule=inner_schedule,
                               member="dampnet")
    with torch.no_grad(), record_function("score:dampnet"):
        scores = dampnet_scores(damp_params, damp_state, feats, dcfg, spec.n_query, mode="domain_shift")
        return torch.softmax(scores, dim=1)


def ensemble_episode_scores(baseline_params, baseline_stats, gnn_params, gnn_stats, gnn_head, episode, support_bank,
                            gen, *, bcfg, gcfg, spec, tcfg, aug_cfg, gen_examples: int = 0):
    """--method all: softmax(linear member) + softmax(GNN member), the two
    members run back to back on the same support bank (finetune.py:648-650)."""
    kw = dict(bcfg=bcfg, spec=spec, tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples)
    s_lin = linear_member_scores(baseline_params, baseline_stats, episode, support_bank, gen, **kw)
    s_gnn = gnn_member_scores(gnn_params, gnn_stats, gnn_head, episode, support_bank, gen, gcfg=gcfg, **kw)
    return s_lin + s_gnn


def episode_accuracy(scores: torch.Tensor, spec: EpisodeSpec) -> float:
    """Top-1 accuracy (%) against y_query (finetune.py:625-631)."""
    y = query_labels(spec, scores.device)
    return float((scores.argmax(dim=1) == y).float().mean()) * 100.0


def mean_ci95(acc_all) -> tuple:
    """Mean and 1.96*std/sqrt(n) (finetune.py:678-682)."""
    acc_all = np.asarray(acc_all)
    return float(acc_all.mean()), float(1.96 * acc_all.std() / np.sqrt(len(acc_all)))


#: the eval methods of the port
METHODS = ("all", "gnnnet", "gnnnet_maml", "baseline", "protonet", "dampnet", "dampnet_full", "dampnet_full_class")


def make_eval_program(*, method: str, bcfg, gcfg: Optional[GnnNetCfg], spec: EpisodeSpec, tcfg: TransferCfg,
                      aug_cfg, gen_examples: int, dcfg=None, dampnet_eval: str = "finetune"):
    """The per-episode eval: ``fn(models, base_episode, gen) -> (scores, acc)``
    with ``base_episode`` uint8 ``[n_way, s+q, 3, H0, W0]`` on the device and
    ``models`` holding what ``method`` reads: ``baseline=(params, stats)``
    (``all``, ``baseline``), ``gnn=(params, stats, head)`` (``all``,
    ``gnnnet``, ``gnnnet_maml``), ``protonet=(params, stats)`` or
    ``dampnet=(params, stats, damp_params, damp_state)`` (with ``dcfg`` and
    ``dampnet_eval``; ``unsup_stats=(mean, std)`` selects the unsupervised
    composition).  In the minibatch BN mode the replica bank is built once
    per episode and both members of ``--method all`` train on it."""
    if method not in METHODS:
        raise ValueError(f"the port evaluates --method {'|'.join(METHODS)}, not {method!r}")
    _check_modes(tcfg)

    def one_episode(models, base_episode: torch.Tensor, gen: torch.Generator):
        dt = pipeline_dtype(bcfg.compute_dtype)
        with torch.no_grad():
            episode = center_batch(base_episode, aug_cfg.image_size, dtype=dt)
            support = base_episode[:, : spec.n_support]
            if tcfg.bn_mode == "minibatch":
                with record_function("bank_fmap:replicas"):
                    support = make_eval_replicas(gen, support, aug_cfg, gen_examples)
        kw = dict(bcfg=bcfg, spec=spec, tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples)
        if method == "all":
            scores = ensemble_episode_scores(*models["baseline"], *models["gnn"], episode, support, gen, gcfg=gcfg, **kw)
        elif method in ("gnnnet", "gnnnet_maml"):
            scores = gnn_member_scores(*models["gnn"], episode, support, gen, gcfg=gcfg, **kw)
        elif method == "protonet":
            scores = proto_member_scores(*models["protonet"], episode, support, gen, **kw)
        elif method.startswith("dampnet"):
            scores = dampnet_member_scores(*models["dampnet"], episode, support, gen, dcfg=dcfg,
                                           eval_mode=dampnet_eval, unsup_stats=models.get("unsup_stats"), **kw)
        else:
            scores = linear_member_scores(*models["baseline"], episode, support, gen, **kw)
        return scores, episode_accuracy(scores, spec)

    return one_episode
