"""Training step functions (port of ``mft_tpu/train/steps.py``).

* supervised baseline pretraining: backbone + linear CE over the base
  classes (reference train.py --method baseline, baselinetrain.py:26-56);
* episodic meta-training of ProtoNet / GnnNet: one Adam step per episode
  batch (train.py:27-42, meta_template.py:58-92);
* the meta fine-tuning stage (``--fine_tune``): FO-MAML, an inner Adam(0.01)
  on the last backbone block over the support set (15 epochs x batch 4,
  gnnnet.py:145-177), the outer CE on the query set at the adapted point
  with its gradient applied to the meta-initialization
  (gnnnet.py:90-103,183-187, train.py:49-58);
* DampNet's episodic step (train_loop_full, dampnet_full_class.py:425-469)
  in the mode its driver's schedule gives.

Each step takes an episode batch ``[E, n_way, s+q, 3, H, W]`` (E = 1 is the
reference's schedule), averages the losses and the running-stat updates over
E as the JAX step does (steps.py:112-116), loops over E rather than
vectorizing, and returns ``(params, stats, opt_state, metrics)``.  Trees are
functional: the step returns new ones and leaves its inputs as they were.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function
from torch.utils import _pytree as pytree

from mft_tpu_torch.core.episode import EpisodeSpec, flatten_episode, support_labels
from mft_tpu_torch.methods.baseline import ce_loss, classifier_logits, top1_accuracy
from mft_tpu_torch.methods.dampnet import dampnet_loss, dampnet_scores
from mft_tpu_torch.methods.gnnnet import gnn_scores, gnnnet_loss
from mft_tpu_torch.methods.protonet import proto_scores, protonet_loss
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.train import optimizers as opt
from mft_tpu_torch.train.inner_loop import InnerLoopCfg, fo_maml_reattach, inner_fit, inner_fit_carry


#: profiler range around each episode's inner loop in the meta fine-tune
#: (its trunk bank included), so a profile splits a step's time
INNER_RANGE = "fine_tune:inner"


class MetaFinetuneCfg(NamedTuple):
    """Inner-loop schedule of the meta fine-tuning stage (reference
    gnnnet.py:111,128,145: batch 4, Adam lr 0.01, 15 epochs; protonet.py:105
    uses 5 epochs)."""

    epochs: int = 15
    batch_size: int = 4
    lr: float = 0.01
    bn_mode: str = "episode"  # 'episode': stop-gradient trunk bank | 'minibatch': whole backbone per step


def inner_epochs(method: str, gcfg) -> int:
    """The reference's ``--fine_tune`` inner epochs: 15 for GnnNet
    (gnnnet.py:145), 5 for ProtoNet (protonet.py:105) and for the 50-shot
    compressed variant (gnnnet_copy.py:177)."""
    if method != "gnnnet":
        return 5
    if gcfg is not None and getattr(gcfg, "support_compress", 1) > 1:
        return 5
    return 15


def _tree_mean(trees):
    return pytree.tree_map(lambda *xs: torch.stack(xs).mean(dim=0), *trees)


def _value_and_grad(loss_fn, params):
    """``loss_fn(params) -> (loss, aux)`` -> ``(loss, aux, grads)``; a
    parameter the loss does not reach gets a zero gradient, as under
    ``jax.grad``."""
    leaves, spec = pytree.tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(pytree.tree_unflatten(live, spec))
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return loss.detach(), aux, pytree.tree_unflatten(grads, spec)


def _apply(tx, params, grads, opt_state):
    with torch.no_grad():
        params = pytree.tree_map(torch.Tensor.detach, params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return pytree.tree_map(lambda p, u: p + u.to(p.dtype), params, updates), opt_state


# --------------------------------------------------------------------------
# baseline supervised pretraining
# --------------------------------------------------------------------------


def baseline_loss_fn(params, stats, x, y, *, bcfg):
    """x ``[N, 3, H, W]``, y ``[N]`` -> ``(loss, (new_stats, top1))``."""
    feats, new_stats = bb.apply_backbone(params["feature"], stats, x, cfg=bcfg, train=True, update_stats=True)
    logits = classifier_logits(params["classifier"], feats)
    return ce_loss(logits, y), (new_stats, top1_accuracy(logits, y))


def baseline_train_step(params, stats, opt_state, x, y, *, bcfg, tx):
    loss, (new_stats, acc), grads = _value_and_grad(lambda p: baseline_loss_fn(p, stats, x, y, bcfg=bcfg), params)
    params, opt_state = _apply(tx, params, grads, opt_state)
    return params, new_stats, opt_state, {"loss": loss, "top1": acc.detach()}


# --------------------------------------------------------------------------
# episodic meta-training (ProtoNet / GnnNet)
# --------------------------------------------------------------------------


def _head_loss(params, z, *, method, gcfg, spec: EpisodeSpec):
    """Loss of one episode's features ``z [n_way, s+q, F]``."""
    if method == "protonet":
        return protonet_loss(proto_scores(z[:, : spec.n_support], z[:, spec.n_support :], spec), spec)
    scores = gnn_scores({"fc": params["fc"], "gnn": params["gnn"]}, z, gcfg, spec.n_query)
    return gnnnet_loss(scores, spec.n_way, spec.n_query)


def _episode_loss(params, stats, episode, *, method, bcfg, gcfg, spec: EpisodeSpec, fwt_noise=None):
    """One episode ``[n_way, s+q, 3, H, W]`` -> ``(loss, new_stats)``: one
    train-mode embedding pass over the whole episode (the reference trains
    with BN in batch-stats mode and its running stats update, train.py:167).
    ``fwt_noise``: this episode's FWT draws (``bb.draw_fwt_noise``)."""
    feats, new_stats = bb.apply_backbone(params["feature"], stats, flatten_episode(episode), cfg=bcfg, train=True,
                                         update_stats=True, fwt_noise=fwt_noise)
    z = feats.reshape(spec.n_way, spec.n_per_class, -1)
    return _head_loss(params, z, method=method, gcfg=gcfg, spec=spec), new_stats


def episodic_train_step(params, stats, opt_state, episodes, *, method, bcfg, gcfg, spec: EpisodeSpec, tx,
                        fwt_noise=None):
    """episodes ``[E, n_way, s+q, 3, H, W]``; loss and stat updates averaged over E.

    ``fwt_noise`` (ResNet10_FW): a ``torch.Generator`` that draws each
    episode's noise for every block (``bb.draw_fwt_noise``, episode by
    episode), or the ``E`` episodes' draws; the JAX step splits its key per
    episode and per block (steps.py:108, backbone.py:332).  This is the one
    step that draws FWT noise, as in JAX."""
    noise = [None] * len(episodes)
    if bcfg.block == "fwt" and fwt_noise is not None:
        if isinstance(fwt_noise, torch.Generator):
            noise = [bb.draw_fwt_noise(fwt_noise, bcfg, device=episodes.device) for _ in range(len(episodes))]
        elif len(fwt_noise) != len(episodes):
            raise ValueError(f"fwt_noise holds {len(fwt_noise)} episodes' draws for {len(episodes)} episodes")
        else:
            noise = list(fwt_noise)

    def batch_loss(p):
        losses, new_stats = zip(*(_episode_loss(p, stats, ep, method=method, bcfg=bcfg, gcfg=gcfg, spec=spec,
                                                fwt_noise=nz) for ep, nz in zip(episodes, noise)))
        return torch.stack(losses).mean(), _tree_mean(new_stats)

    loss, new_stats, grads = _value_and_grad(batch_loss, params)
    params, opt_state = _apply(tx, params, grads, opt_state)
    return params, new_stats, opt_state, {"loss": loss}


# --------------------------------------------------------------------------
# DampNet episodic training (train_loop_full)
# --------------------------------------------------------------------------


def dampnet_train_step(params, stats, opt_state, dstate, episodes, gen, *, mode, bcfg, dcfg, spec: EpisodeSpec, tx,
                       corrupt_x=None):
    """One DampNet step over an episode batch ``[E, n_way, s+q, 3, H, W]``:
    each episode embedded by the backbone in train mode (running stats
    updated, averaged over E), scored by ``dampnet_scores`` in ``mode``
    ('plain' / 'corrupt' / 'recover'), CE on the queries, Adam over every
    parameter.  ``gen`` draws each corrupt episode's corruption unless
    ``corrupt_x [E, n_way*(s+q), feat]`` gives it.  The metrics hold the
    episodes' clean support features ``support_bank [E, n_way*n_support,
    feat]`` (detached) for the driver's prototype refresh (:456-462)."""

    def one(p, i, ep):
        feats, new_stats = bb.apply_backbone(p["feature"], stats, flatten_episode(ep), cfg=bcfg, train=True,
                                             update_stats=True)
        z = feats.reshape(spec.n_way, spec.n_per_class, -1)
        head = {k: v for k, v in p.items() if k != "feature"}
        scores = dampnet_scores(head, dstate, z, dcfg, spec.n_query, mode=mode, gen=gen,
                                corrupt_x=None if corrupt_x is None else corrupt_x[i])
        bank = z[:, : spec.n_support].reshape(spec.support_size, -1).detach()
        return dampnet_loss(scores, spec.n_way, spec.n_query), new_stats, bank

    def batch_loss(p):
        losses, new_stats, banks = zip(*(one(p, i, ep) for i, ep in enumerate(episodes)))
        return torch.stack(losses).mean(), (_tree_mean(new_stats), torch.stack(banks))

    loss, (new_stats, banks), grads = _value_and_grad(batch_loss, params)
    params, opt_state = _apply(tx, params, grads, opt_state)
    return params, new_stats, opt_state, {"loss": loss, "support_bank": banks}


# --------------------------------------------------------------------------
# meta fine-tuning stage (FO-MAML)
# --------------------------------------------------------------------------


def _meta_finetune_episode_loss(params, stats, episode, gen, *, method, bcfg, gcfg, spec: EpisodeSpec,
                                mcfg: MetaFinetuneCfg, schedule=None):
    """One episode of the ``--fine_tune`` stage -> ``(loss, new_stats)``.
    ``gen`` draws the inner minibatch order unless ``schedule`` gives it."""
    dev = episode.device
    bank_x = episode[:, : spec.n_support].reshape((spec.support_size,) + tuple(episode.shape[2:]))
    bank_y = support_labels(spec, dev)
    trunk_p, block_p = bb.adapt_split(params["feature"])
    trunk_s, block_s = bb.adapt_split(stats)
    icfg = InnerLoopCfg(epochs=mcfg.epochs, batch_size=mcfg.batch_size, bank_size=spec.support_size)
    detach = lambda t: pytree.tree_map(torch.Tensor.detach, t)

    if mcfg.bn_mode == "episode":

        def inner_loss(block, idx, w):
            # CE on the raw backbone features used as logits (gnnnet.py:168-170)
            feats = bb.apply_final_block(block, block_s, fmap_bank[idx], cfg=bcfg, train=True, sample_mask=w)
            return ce_loss(feats, bank_y[idx], w)

        with record_function(INNER_RANGE):
            with torch.no_grad():  # the trunk bank is a constant of the inner loop
                fmap_bank = bb.apply_trunk(detach(trunk_p), trunk_s, bank_x, cfg=bcfg, train=True)
            adapted = inner_fit(inner_loss, detach(block_p), opt.torch_adam(mcfg.lr), gen, icfg, schedule=schedule,
                                device=dev)
        # the documented deviation of this mode: with the trunk bank
        # precomputed, the running stats do not ride the inner minibatches
        stats_inner = stats
    elif mcfg.bn_mode == "minibatch":
        frozen_trunk = detach(trunk_p)

        def inner_loss(block, s, idx, w):
            # every inner minibatch also updates the running stats, as the
            # reference's train-mode forwards whose stats load_state_dict
            # later persists (gnnnet.py:158-187)
            feats, new_s = bb.apply_backbone(bb.adapt_merge(frozen_trunk, block), s, bank_x[idx], cfg=bcfg,
                                             train=True, sample_mask=w, update_stats=True)
            return ce_loss(feats, bank_y[idx], w), new_s

        with record_function(INNER_RANGE):
            adapted, stats_inner = inner_fit_carry(inner_loss, detach(block_p), stats, opt.torch_adam(mcfg.lr), gen,
                                                   icfg, schedule=schedule, device=dev)
    else:
        raise ValueError(f"bn_mode must be 'episode' or 'minibatch', got {mcfg.bn_mode!r}")
    full = bb.adapt_merge(trunk_p, fo_maml_reattach(block_p, adapted))

    # support and query embedded in SEPARATE passes after adaptation
    # (gnnnet.py:193-197, protonet.py:154-156): each normalized by its own
    # batch statistics, the query pass starting from the support pass's stats
    flat_q = episode[:, spec.n_support :].reshape((spec.query_size,) + tuple(episode.shape[2:]))
    feats_s, stats_s = bb.apply_backbone(full, stats_inner, bank_x, cfg=bcfg, train=True, update_stats=True)
    feats_q, new_stats = bb.apply_backbone(full, stats_s, flat_q, cfg=bcfg, train=True, update_stats=True)
    z = torch.cat([feats_s.reshape(spec.n_way, spec.n_support, -1), feats_q.reshape(spec.n_way, spec.n_query, -1)],
                  dim=1)
    return _head_loss(params, z, method=method, gcfg=gcfg, spec=spec), new_stats


def meta_finetune_train_step(params, stats, opt_state, episodes, gen, *, method, bcfg, gcfg, spec: EpisodeSpec,
                             mcfg: MetaFinetuneCfg, tx, schedule=None):
    """The ``--fine_tune`` step over an episode batch ``[E, ...]``.
    ``schedule``: an explicit inner ``(idx, w)`` shared by every episode of
    the batch (the replay instrument of the trajectory goldens)."""

    def batch_loss(p):
        losses, new_stats = zip(*(
            _meta_finetune_episode_loss(p, stats, ep, gen, method=method, bcfg=bcfg, gcfg=gcfg, spec=spec, mcfg=mcfg,
                                        schedule=schedule)
            for ep in episodes))
        return torch.stack(losses).mean(), _tree_mean(new_stats)

    loss, new_stats, grads = _value_and_grad(batch_loss, params)
    params, opt_state = _apply(tx, params, grads, opt_state)
    return params, new_stats, opt_state, {"loss": loss}
