"""Per-episode transfer fine-tuning — the ``--method all`` eval (port of
``mft_tpu/train/eval_engine.py``, episode BN mode).

For each episode: clean center views; the frozen trunk embeds the support
bank once (``_bank_fmap``: the clean support three times, then
``gen_examples`` augmented replicas); the final residual block (plus a
throwaway linear head for the linear member) is fine-tuned with batch-5
torch-Adam steps on that bank (``_adapt_block``); the adapted backbone
embeds the clean episode with batch-stats BN; the GNN head and the linear
head score the queries; ``--method all`` sums the two softmaxes
(reference finetune.py:648-650).

Reference quirks kept (load-bearing for accuracy parity): the GNN member's
inner loss is CE on the raw 512-d features used as logits; the support bank
holds the clean support three times; the linear member trains on the clean
support alone for ``linear_epochs`` (finetune.py:139-140).

The episodes run one at a time; every draw (augment parameters, classifier
init, minibatch order) comes from the ``torch.Generator`` passed in.

Each phase of a member runs inside a ``torch.profiler.record_function``
range named in :data:`PHASES` (``<phase>:<member>``), so a profile of one
episode splits its host and device time by phase (chip_smoke.py reads
them); without a profiler each range is one cheap host call, eight per
episode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from mft_tpu_torch.core.episode import EpisodeSpec, flatten_episode, query_labels, support_labels
from mft_tpu_torch.kernels import fused_inner_scan as fis
from mft_tpu_torch.methods.baseline import ce_loss, classifier_logits, init_classifier
from mft_tpu_torch.methods.gnnnet import GnnNetCfg, gnn_scores
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.ops.augment import augment_batch, center_batch, pipeline_dtype, to_float
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
    #: kernels, kernels/fused_inner_scan.py; needs bf16 Adam moments).  The
    #: linear member trains a head too and always runs eager.
    inner_scan: str = "eager"


def bank_labels(spec: EpisodeSpec, replicas: int, device="cpu") -> torch.Tensor:
    """Labels of the stacked support bank: ``[replicas * n_way * n_support]``."""
    return support_labels(spec, device).repeat(replicas)


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


def _prepare_adapt(params, stats, bank_y, fmap_bank, *, bcfg: bb.ResNetCfg, tcfg: TransferCfg, epochs: int,
                   head: Optional[dict], perm_span: Optional[int] = None):
    """One member's inner-loop task ``(p0, loss_fn, tx, icfg, finish)`` with
    ``finish(adapted) -> (block, head)``: the adapted tree is the final
    block (GNN member) or ``{"adapt": block, "head": head}`` (linear member),
    and each step gathers its minibatch rows of the feature bank."""
    _, block_p = bb.adapt_split(params)
    _, block_s = bb.adapt_split(stats)
    span = perm_span if perm_span is not None else fmap_bank.shape[0]
    icfg = InnerLoopCfg(epochs=epochs, batch_size=tcfg.batch_size, bank_size=span)
    if tcfg.inner_param_dtype != "float32":
        pd = getattr(torch, tcfg.inner_param_dtype)
        cast = lambda t: {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.to(pd)
        block_p = cast(block_p)
        head = cast(head) if head is not None else None

    def features_of(block, idx, w):
        return bb.apply_final_block(block, block_s, fmap_bank[idx], cfg=bcfg, train=True, sample_mask=w)

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


def _adapt_block(params, stats, bank_y, fmap_bank, gen, *, bcfg, tcfg, epochs, head=None, perm_span=None,
                 schedule=None):
    """Fine-tune the final block (and the optional head) on the feature
    bank.  ``perm_span``: the permutations cover only the first rows (the
    linear member's clean-support-only quirk).  Returns ``(block, head)``.
    ``tcfg.inner_scan == 'fused'`` sends the head-less (GNN) member through
    the fused scan; with a head the loop stays eager."""
    if tcfg.inner_scan not in ("eager", "fused"):
        raise ValueError(f"inner_scan must be 'eager' or 'fused', not {tcfg.inner_scan!r}")
    p0, loss_fn, tx, icfg, finish = _prepare_adapt(
        params, stats, bank_y, fmap_bank, bcfg=bcfg, tcfg=tcfg, epochs=epochs, head=head, perm_span=perm_span,
    )
    if tcfg.inner_scan == "fused" and head is None:
        with torch.no_grad():
            return finish(_adapt_block_fused(p0, bank_y, fmap_bank, gen, bcfg=bcfg, tcfg=tcfg, icfg=icfg,
                                             schedule=schedule))
    return finish(inner_fit(loss_fn, p0, tx, gen, icfg, schedule=schedule, device=fmap_bank.device))


@torch.no_grad()
def _embed_episode(params, stats, episode: torch.Tensor, *, bcfg, spec: EpisodeSpec) -> torch.Tensor:
    """Clean-episode features ``[n_way, s+q, feat]`` with batch-stats BN over
    every image (finetune.py:306)."""
    feats, _ = bb.apply_backbone(params, stats, flatten_episode(episode), cfg=bcfg, train=True)
    return feats.reshape(spec.n_way, spec.n_per_class, -1)


def gnn_member_scores(backbone_params, backbone_stats, head, episode, support_bank, gen, *, bcfg, gcfg: GnnNetCfg,
                      spec: EpisodeSpec, tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None):
    """finetune() with the GNN head (finetune.py:182-328) -> softmax scores
    ``[n_way * n_query, n_way]``.  ``support_bank``: raw support
    ``[n_way, n_support, 3, H0, W0]``; ``inner_schedule``: explicit
    ``(idx, w)`` instead of the draw from ``gen``."""
    trunk_p, _ = bb.adapt_split(backbone_params)
    trunk_s, _ = bb.adapt_split(backbone_stats)
    with record_function("bank_fmap:gnn"):
        fmap = _bank_fmap(trunk_p, trunk_s, support_bank, gen, bcfg=bcfg, aug_cfg=aug_cfg, gen_examples=gen_examples)
    bank_y = bank_labels(spec, gen_examples + 3, fmap.device)
    with record_function("adapt:gnn"):
        block, _ = _adapt_block(backbone_params, backbone_stats, bank_y, fmap, gen, bcfg=bcfg, tcfg=tcfg,
                                epochs=tcfg.fine_tune_epochs, schedule=inner_schedule)
    with record_function("embed:gnn"):
        feats = _embed_episode(bb.adapt_merge(trunk_p, block), backbone_stats, episode, bcfg=bcfg, spec=spec)
    with torch.no_grad(), record_function("score:gnn"):
        return torch.softmax(gnn_scores(head, feats, gcfg, spec.n_query), dim=1)


def linear_member_scores(backbone_params, backbone_stats, episode, support_bank, gen, *, bcfg, spec: EpisodeSpec,
                         tcfg: TransferCfg, aug_cfg, gen_examples: int = 0, inner_schedule=None, head0=None):
    """finetune_linear (finetune.py:45-174) -> softmax scores.  Trains on
    the clean support only, so no augmented group is built.
    ``head0``: explicit classifier init instead of the draw from ``gen``."""
    trunk_p, _ = bb.adapt_split(backbone_params)
    trunk_s, _ = bb.adapt_split(backbone_stats)
    dev = support_bank.device
    if head0 is None:
        head0 = init_classifier(gen, bcfg.feat_dim, spec.n_way, zero_bias=False, device=dev)
    with record_function("bank_fmap:linear"):
        fmap = _bank_fmap(trunk_p, trunk_s, support_bank, gen, bcfg=bcfg, aug_cfg=aug_cfg,
                          gen_examples=gen_examples, clean_only=True)
    bank_y = bank_labels(spec, 1, dev)
    with record_function("adapt:linear"):
        block, head = _adapt_block(backbone_params, backbone_stats, bank_y, fmap, gen, bcfg=bcfg, tcfg=tcfg,
                                   epochs=tcfg.linear_epochs, head=head0, perm_span=spec.support_size,
                                   schedule=inner_schedule)
    with record_function("embed:linear"):
        feats = _embed_episode(bb.adapt_merge(trunk_p, block), backbone_stats, episode, bcfg=bcfg, spec=spec)
    with torch.no_grad(), record_function("score:linear"):
        q_feats = feats[:, spec.n_support :].reshape(spec.query_size, -1)
        return torch.softmax(classifier_logits(head, q_feats), dim=1)


def ensemble_episode_scores(baseline_params, baseline_stats, gnn_params, gnn_stats, gnn_head, episode, support_bank,
                            gen, *, bcfg, gcfg, spec, tcfg, aug_cfg, gen_examples: int = 0):
    """--method all: softmax(linear member) + softmax(GNN member), the two
    members run back to back (finetune.py:648-650)."""
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


def make_eval_program(*, method: str, bcfg, gcfg: Optional[GnnNetCfg], spec: EpisodeSpec, tcfg: TransferCfg,
                      aug_cfg, gen_examples: int):
    """The per-episode eval: ``fn(models, base_episode, gen) -> (scores, acc)``
    with ``base_episode`` uint8 ``[n_way, s+q, 3, H0, W0]`` on the device and
    ``models`` holding ``baseline=(params, stats)`` and/or
    ``gnn=(params, stats, head)``."""
    if method not in ("all", "gnnnet", "baseline"):
        raise ValueError(f"the port evaluates --method all|gnnnet|baseline, not {method!r}")

    def one_episode(models, base_episode: torch.Tensor, gen: torch.Generator):
        dt = pipeline_dtype(bcfg.compute_dtype)
        with torch.no_grad():
            episode = center_batch(base_episode, aug_cfg.image_size, dtype=dt)
        support = base_episode[:, : spec.n_support]
        kw = dict(bcfg=bcfg, spec=spec, tcfg=tcfg, aug_cfg=aug_cfg, gen_examples=gen_examples)
        if method == "all":
            scores = ensemble_episode_scores(*models["baseline"], *models["gnn"], episode, support, gen, gcfg=gcfg, **kw)
        elif method == "gnnnet":
            scores = gnn_member_scores(*models["gnn"], episode, support, gen, gcfg=gcfg, **kw)
        else:
            scores = linear_member_scores(*models["baseline"], episode, support, gen, **kw)
        return scores, episode_accuracy(scores, spec)

    return one_episode
