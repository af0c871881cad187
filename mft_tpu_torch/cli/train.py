"""Training driver of the port (counterpart of ``mft_tpu/cli/train.py``).

Stages (reference README commands):

* ``--method baseline``: supervised backbone pretraining on the base
  dataset (train.py:79-109, methods/baselinetrain.py);
* ``--method gnnnet|protonet [--train_aug]``: episodic meta-training,
  ``--episodes_per_epoch`` episodes an epoch, Adam over every parameter
  (train.py:112-144, 27-42);
* ``--fine_tune``: the meta fine-tuning stage, FO-MAML on the last backbone
  block per episode (train.py:49-58), resuming from the latest checkpoint
  with ``--start_epoch``;
* ``--method dampnet_full_class|dampnet_full|dampnet``: DampNet's episodic
  training (train_loop_full, dampnet_full_class.py:425-469; the prototype
  variant, methods/dampnet.py), its mode schedule, prototype refresh and
  rolling store, with ``damp_state`` in every checkpoint.

Episodes and batches are decoded once on the host; augmentation runs on the
device from a generator seeded by ``--seed``.  Checkpoints are the
reference's ``<epoch>.tar`` (``utils/checkpoint.py``), which the port's eval
reads.  At ``--n_shot >= 50`` the GnnNet head is the compressed 50-shot
variant (reference train_50.py, gnnnet_copy.py; ``cli/train_50.py`` pins
its defaults).  Not ported: backbones other than ResNet10 (ROADMAP Queue 1
item 18).

Run: ``python -m mft_tpu_torch.cli.train --method gnnnet --dataset
miniImageNet --n_shot 5 --train_aug --use_pallas --stop_epoch 400``
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from mft_tpu_torch import config as cfg_mod
from mft_tpu_torch import resolve_device
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.data import registry
from mft_tpu_torch.data.pipeline import BatchStream, EpisodeStream, ReplayBatchStream, ReplayEpisodeStream
from mft_tpu_torch.methods import dampnet as dn
from mft_tpu_torch.methods import gnnnet as gn
from mft_tpu_torch.methods.baseline import init_classifier
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.ops.augment import augment_batch, center_batch, pipeline_dtype
from mft_tpu_torch.train import optimizers as opt
from mft_tpu_torch.train import steps
from mft_tpu_torch.utils import checkpoint as ckpt
from mft_tpu_torch.utils.metrics import AverageMeter, MetricLogger


class TrainResult(NamedTuple):
    ckpt_dir: str
    #: each step's loss, in run order
    losses: list
    #: each step's host seconds from the batch on the host to its loss on
    #: the host (which waits for the device)
    seconds: list


def _no_observer(stage: str, epoch: int, step: int):
    return contextlib.nullcontext()


def build_model(gen: torch.Generator, method: str, model_name: str, n_way: int, n_support: int, num_classes: int,
                *, use_pallas: bool = False, device="cpu"):
    """``(bcfg, gcfg, params, stats)``, drawn from ``gen``: the backbone,
    then the head (the baseline's classifier, GnnNet's fc + GNN with the
    pair-averaging 50-shot variant at ``n_support >= 50``, or DampNet's fc +
    GNN + recovery network, ``gcfg`` then its ``DampNetCfg``; ProtoNet has
    none).  A DampNet model's state starts as ``dn.fresh_state(gcfg)``."""
    bcfg = bb.MODEL_REGISTRY[model_name]()
    feature, stats = bb.init_backbone(gen, bcfg, device=device)
    gcfg = None
    if method == "baseline":
        params = {"feature": feature, "classifier": init_classifier(gen, bcfg.feat_dim, num_classes, device=device)}
    elif method == "protonet":
        params = {"feature": feature}
    elif method.startswith("dampnet"):
        gcfg = dn.method_cfg(method, bcfg.feat_dim, n_way, n_support)
        head, _ = dn.init_dampnet(gen, gcfg, device=device)
        params = {"feature": feature, **head}
    else:
        gcfg = gn.GnnNetCfg(feat_dim=bcfg.feat_dim, n_way=n_way, n_support=n_support,
                            support_compress=2 if n_support >= 50 else 1, use_pallas=use_pallas)
        params = {"feature": feature, **gn.init_head(gen, gcfg, device=device)}
    return bcfg, gcfg, params, stats


#: the training methods of the port
METHODS = ("baseline", "gnnnet", "protonet", "dampnet", "dampnet_full", "dampnet_full_class")


def _refuse_unported(a):
    damp = a.method.startswith("dampnet")
    unported = {
        f"--method {a.method}": a.method not in METHODS,
        f"--model {a.model} (ROADMAP Queue 1 item 18, the other backbones)": a.model not in bb.MODEL_REGISTRY,
        # the JAX driver's DampNet loop samples its episodes and has no FO-MAML stage
        f"--method {a.method} with --fine_tune or --episode_manifest": damp and (a.fine_tune or bool(a.episode_manifest)),
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)} (mft_tpu.cli.train has them)")


def main(argv=None, *, observe_step=_no_observer) -> TrainResult:
    """``observe_step(stage, epoch, step)`` returns a context manager that
    encloses each training step (``stage`` is ``baseline``, ``episodic``,
    ``fine_tune`` or ``dampnet``); a caller can profile one step with it."""
    a = cfg_mod.parse_train_args(argv)
    _refuse_unported(a)
    device = resolve_device(a.device)
    if device.type == "cuda":
        # f32 means f32: cuDNN would otherwise run f32 convs in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    paths = cfg_mod.Paths.load(a.paths_json)
    np.random.seed(a.seed)  # reference seed discipline (train.py:69-70)

    entry = registry.get(a.dataset)
    manifest = registry.build_manifest(entry, paths.as_dict(), split="base")
    aug_cfg = entry.train_aug._replace(image_size=a.image_size)
    # the reference's n_query rule (train.py:112); --n_query pins it
    n_query = a.n_query if a.n_query > 0 else max(1, int(16 * a.test_n_way / a.train_n_way))
    spec = EpisodeSpec(a.train_n_way, a.n_shot, n_query)

    bcfg, gcfg, params, stats = build_model(torch.Generator().manual_seed(a.seed), a.method, a.model, a.train_n_way,
                                            a.n_shot, a.num_classes, use_pallas=a.use_pallas, device=device)
    bcfg = bcfg._replace(compute_dtype=a.dtype)
    tx = opt.torch_adam(1e-3)  # Adam(model.parameters()) defaults (train.py:27-28)
    opt_state = tx.init(params)
    dstate = dn.fresh_state(gcfg, device=device) if a.method.startswith("dampnet") else None

    ckpt_dir = cfg_mod.checkpoint_dir(paths, a.dataset, a.model, a.method, train_aug=a.train_aug,
                                      n_way=a.train_n_way, n_shot=a.n_shot)
    logger = MetricLogger(jsonl_path=os.path.join(ckpt_dir, "train_log.jsonl"))
    start_epoch = a.start_epoch
    if start_epoch != 0:
        resume = ckpt.get_resume_file(ckpt_dir)
        if resume:
            loaded = ckpt.load_checkpoint(resume, bcfg, opt_state, device=device, damp_template=dstate)
            epoch, params, stats, opt_state = loaded[:4]
            if dstate is not None:
                dstate = loaded[4]  # the prototypes and the store resume too
            start_epoch = epoch + 1
            print(f"resumed from {resume} at epoch {start_epoch}")

    result = TrainResult(ckpt_dir, [], [])
    args = (a, manifest, aug_cfg, bcfg, gcfg, spec, params, stats, tx, opt_state, logger, start_epoch, device, result,
            observe_step)
    if dstate is not None:
        run_dampnet(*args, dstate)
    else:
        (run_baseline if a.method == "baseline" else run_episodic)(*args)
    return result


def _save(a, epoch, ckpt_dir, params, stats, opt_state, damp_state=None):
    if epoch % a.save_freq == 0 or epoch == a.stop_epoch:
        ckpt.save_checkpoint(ckpt_dir, epoch, params, stats, opt_state, damp_state)


def _load_manifest(a, key: str):
    with open(a.episode_manifest) as f:
        raw = json.load(f)
    return raw[key] if isinstance(raw, dict) else raw


def run_baseline(a, manifest, aug_cfg, bcfg, gcfg, spec, params, stats, tx, opt_state, logger, start_epoch, device,
                 result: TrainResult, observe_step):
    n_batches = max(1, len(manifest) // a.batch_size)
    dt = pipeline_dtype(bcfg.compute_dtype)
    gen_aug = torch.Generator().manual_seed(a.seed)
    # --episode_manifest, baseline flavour: replay recorded minibatches
    # ({"batches": [[paths]]}, concatenated over epochs)
    replay = None
    if a.episode_manifest:
        replay = _load_manifest(a, "batches")
        n_epochs = a.stop_epoch - start_epoch + 1
        if len(replay) % n_epochs:
            raise SystemExit(f"--episode_manifest holds {len(replay)} batches, not a multiple of {n_epochs} epochs")
        n_batches = len(replay) // n_epochs
        root = a.episode_manifest_root
        label_of = {os.path.relpath(p, root) if root else p: int(lab)
                    for p, lab in zip(manifest.items, manifest.labels)}
        print(f"replaying {len(replay)} recorded batches over {n_epochs} epochs")

    for epoch in range(start_epoch, a.stop_epoch + 1):
        if replay is not None:
            lo = (epoch - start_epoch) * n_batches
            stream = ReplayBatchStream(replay[lo : lo + n_batches], label_of, base_size=a.base_size, root=root)
        else:
            stream = BatchStream(manifest, a.batch_size, n_batches, base_size=a.base_size, seed=a.seed + epoch)
        meter = AverageMeter()
        for i, (bx, by) in enumerate(stream):
            t0 = time.perf_counter()
            with observe_step("baseline", epoch, i):
                base = torch.from_numpy(bx).to(device).permute(0, 3, 1, 2)  # NHWC -> NCHW
                x = (augment_batch(gen_aug, base, aug_cfg, dtype=dt) if a.train_aug
                     else center_batch(base, a.image_size, dtype=dt))
                y = torch.from_numpy(np.asarray(by, np.int64)).to(device)
                params, stats, opt_state, m = steps.baseline_train_step(params, stats, opt_state, x, y, bcfg=bcfg,
                                                                        tx=tx)
                loss = float(m["loss"])
            result.seconds.append(time.perf_counter() - t0)
            result.losses.append(loss)
            meter.update(loss)
            logger.log_train(epoch, i, n_batches, meter.avg, top1=float(m["top1"]))
        _save(a, epoch, result.ckpt_dir, params, stats, opt_state)


def run_episodic(a, manifest, aug_cfg, bcfg, gcfg, spec, params, stats, tx, opt_state, logger, start_epoch, device,
                 result: TrainResult, observe_step):
    e_batch = a.episode_batch
    dt = pipeline_dtype(bcfg.compute_dtype)
    method = "protonet" if a.method == "protonet" else "gnnnet"
    mcfg = steps.MetaFinetuneCfg(epochs=steps.inner_epochs(method, gcfg), batch_size=4, bn_mode=a.bn_mode)
    gen_aug = torch.Generator().manual_seed(a.seed)
    gen_inner = torch.Generator().manual_seed(a.seed + 1)  # the inner minibatch order of --fine_tune
    stage = "fine_tune" if a.fine_tune else "episodic"
    # --episode_manifest: replay recorded episodes instead of sampling (the
    # concatenation over epochs, sliced by --episodes_per_epoch)
    replay = None
    if a.episode_manifest:
        replay = _load_manifest(a, "episodes")
        n_epochs = a.stop_epoch - start_epoch + 1
        if len(replay) != n_epochs * a.episodes_per_epoch:
            raise SystemExit(f"--episode_manifest holds {len(replay)} episodes; expected {n_epochs} epochs x "
                             f"{a.episodes_per_epoch} (--episodes_per_epoch)")
        print(f"replaying {len(replay)} recorded episodes over {n_epochs} epochs")

    n_steps = max(1, a.episodes_per_epoch // e_batch)
    for epoch in range(start_epoch, a.stop_epoch + 1):
        if replay is not None:
            lo = (epoch - start_epoch) * a.episodes_per_epoch
            stream = ReplayEpisodeStream(replay[lo : lo + a.episodes_per_epoch], spec, base_size=a.base_size,
                                         root=a.episode_manifest_root)
        else:
            stream = EpisodeStream(manifest, spec, a.episodes_per_epoch, base_size=a.base_size, seed=a.seed + epoch,
                                   cache_dir=a.episode_cache)
        meter = AverageMeter()
        it = iter(stream)
        t_data = t_step = 0.0
        for i in range(n_steps):
            t0 = time.perf_counter()
            eps = np.stack([next(it)[0] for _ in range(e_batch)])
            t1 = time.perf_counter()
            with observe_step(stage, epoch, i):
                base = torch.from_numpy(eps).to(device).permute(0, 1, 2, 5, 3, 4)  # [E, way, shot, 3, H, W]
                x = (augment_batch(gen_aug, base, aug_cfg, dtype=dt) if a.train_aug
                     else center_batch(base, a.image_size, dtype=dt))
                if a.fine_tune:
                    params, stats, opt_state, m = steps.meta_finetune_train_step(
                        params, stats, opt_state, x, gen_inner, method=method, bcfg=bcfg, gcfg=gcfg, spec=spec,
                        mcfg=mcfg, tx=tx)
                else:
                    params, stats, opt_state, m = steps.episodic_train_step(
                        params, stats, opt_state, x, method=method, bcfg=bcfg, gcfg=gcfg, spec=spec, tx=tx)
                loss = float(m["loss"])  # waits for the step
            t2 = time.perf_counter()
            t_data += t1 - t0
            t_step += t2 - t1
            result.seconds.append(t2 - t1)
            result.losses.append(loss)
            meter.update(loss)
            logger.log_train(epoch, i, n_steps, meter.avg)
        it.close()
        # input against compute: data_s >> step_s means the run waits on the host's decode
        logger.log_train(epoch, n_steps, n_steps, meter.avg, data_s=round(t_data, 3), step_s=round(t_step, 3))
        _save(a, epoch, result.ckpt_dir, params, stats, opt_state)


def run_dampnet(a, manifest, aug_cfg, bcfg, dcfg, spec, params, stats, tx, opt_state, logger, start_epoch, device,
                result: TrainResult, observe_step, dstate):
    """DampNet training (train_loop_full, dampnet_full_class.py:425-469).
    The full family: 'plain' until the prototypes exist, then corrupt and
    recover by call parity; each epoch's clean support features join a
    5-epoch window from which the prototypes are refreshed from epoch 206 on
    (:430,456-462).  The prototype variant: its schedule by ``count``, and
    each step's support banks rotated into the rolling store (dampnet.py:
    54,95-138).  The corruption draws come from a generator seeded by
    ``--seed``."""
    e_batch = a.episode_batch
    dt = pipeline_dtype(bcfg.compute_dtype)
    gen_aug = torch.Generator().manual_seed(a.seed)
    gen_corrupt = torch.Generator().manual_seed(a.seed + 2)
    proto_variant = dcfg.variant == "prototype"
    proto_start = 206  # dampnet_full_class.py:430
    window = []  # the support features of the last 5 epochs
    step_index = 0
    n_steps = max(1, a.episodes_per_epoch // e_batch)
    for epoch in range(start_epoch, a.stop_epoch + 1):
        stream = EpisodeStream(manifest, spec, a.episodes_per_epoch, base_size=a.base_size, seed=a.seed + epoch,
                               cache_dir=a.episode_cache)
        meter = AverageMeter()
        it = iter(stream)
        epoch_bank = []
        for i in range(n_steps):
            eps = np.stack([next(it)[0] for _ in range(e_batch)])
            if proto_variant:
                mode = dn.prototype_training_mode(int(dstate["count"]), e_batch)
            else:
                mode = dn.training_mode(step_index, bool(dstate["initialized"]))
            t1 = time.perf_counter()
            with observe_step("dampnet", epoch, i):
                base = torch.from_numpy(eps).to(device).permute(0, 1, 2, 5, 3, 4)  # [E, way, shot, 3, H, W]
                x = (augment_batch(gen_aug, base, aug_cfg, dtype=dt) if a.train_aug
                     else center_batch(base, a.image_size, dtype=dt))
                params, stats, opt_state, m = steps.dampnet_train_step(
                    params, stats, opt_state, dstate, x, gen_corrupt, mode=mode, bcfg=bcfg, dcfg=dcfg, spec=spec,
                    tx=tx)
                if proto_variant:
                    dstate = dn.update_prototype_store(dstate, m["support_bank"])
                loss = float(m["loss"])  # waits for the step
            result.seconds.append(time.perf_counter() - t1)
            result.losses.append(loss)
            if not proto_variant:
                epoch_bank.append(m["support_bank"].reshape(-1, dcfg.feat_dim))
            step_index += e_batch
            meter.update(loss)
            logger.log_train(epoch, i, n_steps, meter.avg, mode=mode)
        it.close()
        if not proto_variant:
            window = (window + [torch.cat(epoch_bank)])[-5:]
            if epoch >= proto_start:
                dstate = dn.update_prototypes(dstate, torch.cat(window))
        _save(a, epoch, result.ckpt_dir, params, stats, opt_state, dstate)


if __name__ == "__main__":
    main(sys.argv[1:])
