"""Cross-domain evaluation driver of the port (counterpart of
``mft_tpu/cli/finetune.py``).

For each of ``--iter_num`` episodes of the test dataset (or each episode
of ``--episode_manifest``): fan the support set out into ``gen_examples``
augmented replicas (+ the triple clean copy), fine-tune the pretrained
backbone's last block (``--bn_mode``), score with the requested head, and
report mean accuracy +- 1.96*std/sqrt(n) (reference finetune.py:424-682).
The episodes run in batches of ``--eval_batch`` lanes (the last batch may
be short) on each card of the mesh (``--device cuda``: every visible card,
one worker process each; ``cuda:<i>``: that card alone); each keeps its own
generator, seeded by its index, so its answer does not depend on the batch
or the mesh.  Under a ``torch.distributed`` process group (``evaluate``'s
``group``) the ranks take the mesh's place, one shard each.
Per-episode accuracies go to stdout and to
``<save_dir>/eval_log.jsonl``; ``--episode_cache`` keeps the decoded
episodes, ``--trace_dir`` writes a profiler trace.
At ``--n_shot >= 50`` the GnnNet head is the compressed 50-shot variant
(reference finetune_50.py, gnnnet_copy.py).  Checkpoints are the
reference's ``<epoch>.tar`` state dicts (what ``mft_tpu.cli.export_ckpt``
and ``mft_tpu_torch.cli.train`` write) or the JAX package's ``<epoch>.ckpt``
files, read directly (``utils/checkpoint.py``; the ``.tar`` wins where a
directory holds both for an epoch).

``--method dampnet|dampnet_full|dampnet_full_class`` reads the method's own
checkpoint with its ``damp_state``; when that holds no source prototypes
(``initialized`` False, as in a file the reference wrote) they are computed
first from a sweep of ``--dataset`` through the backbone (finetune_50.py:
591-622, ``--sweep_images`` subsamples it).  ``--dampnet_eval`` picks the
composition, ``--unsupervised <dataset>`` the recovery from that dataset's
feature statistics.

Run: ``python -m mft_tpu_torch.cli.finetune --method all --use_pallas
--test_dataset CropDisease --n_shot 5 --fine_tune_epoch 5 --gen_examples 17``
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import io
import json
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from mft_tpu_torch import config as cfg_mod
from mft_tpu_torch import resolve_device
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.data import registry
from mft_tpu_torch.data.pipeline import WORKERS, EpisodeStream, ReplayEpisodeStream, decode_image
from mft_tpu_torch.methods import dampnet as dn
from mft_tpu_torch.methods import gnnnet as gn
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.ops.augment import center_batch
from mft_tpu_torch.parallel import distributed as pdist
from mft_tpu_torch.parallel import mesh as pmesh
from mft_tpu_torch.train import eval_engine as ee
from mft_tpu_torch.utils import checkpoint as ckpt
from mft_tpu_torch.utils.metrics import MetricLogger, eval_batch, profile_trace, span


class EvalResult(NamedTuple):
    mean: float
    ci95: float
    accs: list
    #: seconds of each episode: its batch's seconds over the batch's lanes
    seconds: list
    #: seconds of each batch: its ``eval:run`` span, from the batch's start on the device (after its episodes
    #: are stacked on the host) to its synchronized scores
    batch_seconds: list
    #: the episodes after the first (warm-up) batch over the seconds from that batch's end to the last batch's
    #: end (their ``eval:batch`` spans), so the time between batches counts; the one batch's rate if it is alone
    episodes_per_sec: float
    #: every episode's scores on the CPU, in episode order (``keep_scores``), else None
    scores: Optional[list] = None
    #: kernel launches of the mesh's worker processes (or of every rank of ``group``), summed (empty for a
    #: one-device mesh, which runs in the calling process: its own counts hold them)
    worker_launches: Optional[dict] = None
    #: on a wider mesh, each batch's seconds of each shard in its worker (host clock around the synchronized lane
    #: batch); the batch's own seconds add the wait for the worker's episodes and the answers' way back
    shard_seconds: Optional[list] = None


def _load(path, bcfg, device, need_head: bool):
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path!r} not found")
    _, params, stats, _ = ckpt.load_checkpoint(path, bcfg, None, device=device)
    if need_head and "gnn" not in params:
        raise ValueError(f"checkpoint {path!r} holds no GnnNet head (fc.* / gnn.*)")
    return params, stats


def build_models(a, paths, bcfg, device, dcfg=None):
    """Resolve and load the checkpoints the method needs
    (finetune.py:439-550).  ``--method all`` keeps the reference's quirks:
    the baseline is pinned at epoch 400 (latest with ``--save_iter -1``) in a
    train_aug-gated dir; the GNN at epoch 600 with ``_aug`` always appended
    (finetune.py:121-137 of the JAX driver).  ``gnnnet``, ``gnnnet_maml``,
    ``protonet`` and the DampNet methods (``dcfg``) read their own method's
    directory at ``--save_iter`` (the best file with -1); a ProtoNet
    checkpoint is a backbone alone."""
    models = {}
    if dcfg is not None:
        d = cfg_mod.checkpoint_dir(paths, a.dataset, a.model, a.method, train_aug=a.train_aug, n_way=a.train_n_way,
                                   n_shot=a.n_shot)
        path = ckpt.get_assigned_file(d, a.save_iter) if a.save_iter != -1 else ckpt.get_best_file(d)
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(f"checkpoint {path!r} not found")
        _, p, s, _, dstate = ckpt.load_checkpoint(path, bcfg, None, device=device,
                                                  damp_template=dn.fresh_state(dcfg, device=device))
        if "W_R" not in p or p["W_R"].shape[0] != dcfg.ntn_dim:
            raise ValueError(f"checkpoint {path!r} holds no {a.method} recovery network (NTN width {dcfg.ntn_dim})")
        models["dampnet"] = (p["feature"], s, {k: v for k, v in p.items() if k != "feature"}, dstate)
    if a.method in ("all", "baseline"):
        d = cfg_mod.checkpoint_dir(paths, a.dataset, a.model, "baseline", train_aug=a.train_aug)
        path = ckpt.get_assigned_file(d, 400) if a.save_iter != -1 else ckpt.get_resume_file(d)
        p, s = _load(path, bcfg, device, need_head=False)
        models["baseline"] = (p["feature"], s)
    if a.method in ("all", "gnnnet", "gnnnet_maml", "protonet"):
        method_name = "gnnnet" if a.method == "all" else a.method
        d = cfg_mod.checkpoint_dir(paths, a.dataset, a.model, method_name,
                                   train_aug=True if a.method == "all" else a.train_aug,
                                   n_way=a.train_n_way, n_shot=a.n_shot)
        it = 600 if a.method == "all" else a.save_iter
        path = ckpt.get_assigned_file(d, it) if it != -1 else ckpt.get_best_file(d)
        p, s = _load(path, bcfg, device, need_head=a.method != "protonet")
        if a.method == "protonet":
            models["protonet"] = (p["feature"], s)
        else:
            models["gnn"] = (p["feature"], s, {"fc": p["fc"], "gnn": p["gnn"]})
    return models


def sweep_features(a, paths, dataset_name: str, params, stats, bcfg, device, *, n_images: int = -1,
                   batch: int = 64, order=None) -> torch.Tensor:
    """Center views of ``dataset_name`` through the backbone with
    batch-statistics BN -> f32 features ``[N, feat]``, in batches of 64 (the
    reference's sweep batch, finetune_50.py:592; the ragged last batch keeps
    its size, as the reference's loader's does, since padding would change
    its BN statistics).  ``n_images`` > 0 takes that many evenly spaced
    images; ``order`` (paths relative to the dataset's root) sweeps exactly
    those, in that order: the replay of a recorded ``sweep_order``."""
    if order is not None:
        root = paths.as_dict()[dataset_name]
        items = [os.path.join(root, p) for p in order]
        idx = np.arange(len(items), dtype=np.int64)
    else:
        manifest = registry.build_manifest(registry.get(dataset_name), paths.as_dict())
        items = manifest.items
        cap = len(items) if n_images is None or n_images < 0 else min(n_images, len(items))
        idx = np.linspace(0, len(items) - 1, cap).astype(np.int64)
    out = []
    with cf.ThreadPoolExecutor(WORKERS) as pool, torch.no_grad():
        for start in range(0, len(idx), batch):
            imgs = np.stack(list(pool.map(lambda i: decode_image(items[i], a.base_size), idx[start : start + batch])))
            x = center_batch(torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2), a.image_size)
            out.append(bb.apply_backbone(params, stats, x, cfg=bcfg, train=True)[0].float())
    return torch.cat(out)


def compute_unsup_stats(a, paths, params, stats, bcfg, device, *, n_images: int = -1):
    """Feature mean and unbiased std of the ``--unsupervised`` dataset: the
    external statistics of DampNet's ``unsup`` recovery (set_forward_unsup,
    dampnet_full.py:298-348)."""
    feats = sweep_features(a, paths, a.unsupervised, params, stats, bcfg, device, n_images=n_images)
    return feats.mean(dim=0), feats.std(dim=0, correction=1)


def prepare_dampnet(a, paths, models, bcfg, device):
    """The source prototypes when the checkpoint holds none (a sweep of
    ``--dataset``, the recorded ``sweep_order`` of ``--episode_manifest``
    when it has one), and the ``--unsupervised`` statistics."""
    params, stats, dparams, dstate = models["dampnet"]
    if not bool(dstate["initialized"]):
        order = None
        if a.episode_manifest:
            with open(a.episode_manifest) as f:
                raw = json.load(f)
            order = raw.get("sweep_order") if isinstance(raw, dict) else None
            if order:
                print(f"replaying recorded sweep order ({len(order)} images)")
        feats = sweep_features(a, paths, a.dataset, params, stats, bcfg, device, n_images=a.sweep_images, order=order)
        models["dampnet"] = (params, stats, dparams, dn.update_prototypes(dstate, feats))
        print(f"dampnet source prototypes computed from {a.dataset}")
    if a.unsupervised:
        models["unsup_stats"] = compute_unsup_stats(a, paths, params, stats, bcfg, device, n_images=a.sweep_images)
        print(f"unsup recovery stats from {a.unsupervised}")


def plan_eval_mesh(eval_batch_per_device: int, devices=None):
    """``(mesh, global episode batch)`` of the eval (JAX ``finetune.py:208-220``):
    ``--eval_batch`` is the lane count of one device, so the global batch is
    ``eval_batch`` times the mesh's width."""
    mesh = pmesh.make_mesh(devices)
    return mesh, eval_batch_per_device * len(mesh)


def _run_shard(program, models, images, gens, device):
    """One device's lane batch: its episodes to the device (the span
    ``input:to_device``), the program."""
    with span("input:to_device"):
        base = torch.from_numpy(images).to(device).permute(0, 1, 2, 5, 3, 4)  # NHWC -> NCHW
    return program(models, base, gens)


def _next_images(episodes, n: int) -> np.ndarray:
    """The next ``n`` episodes' images of ``episodes`` stacked on the host
    (the span ``input:stack``; the stream's own span is the wait for each)."""
    loaded = [next(episodes)[0] for _ in range(n)]
    with span("input:stack"):
        return np.stack(loaded)


def _episodes_per_sec(marks: list) -> float:
    """The eval's rate from its batches' ``eval:batch`` records: the
    episodes after the first batch over the seconds from its end to the
    last batch's end; the first batch's own rate when it is alone."""
    if len(marks) == 1:
        return marks[0].episodes / marks[0].seconds
    return sum(m.episodes for m in marks[1:]) / ((marks[-1].end_ns - marks[0].end_ns) / 1e9)


def _generators(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def _shard_step(program, models, episodes, device):
    """A shard's lane-batch step: each call takes the generator seeds of
    the shard's next lane batch, its images from ``episodes`` (an iterator
    over the shard's own episodes in order), and answers with its scores on
    the CPU, its accuracies, this process's kernel launches in the batch and
    the batch's seconds."""
    from mft_tpu_torch import kernels

    def step(seeds):
        images = _next_images(episodes, len(seeds))
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        scores, accs = _run_shard(program, models, images, _generators(seeds), device)
        scores = scores.float().cpu()
        launches = {name: n - before[name] for name, n in kernels.launch_counts().items()}
        return scores, accs, launches, time.perf_counter() - t0

    return step


def _shard_worker(device, payload):
    """A shard's worker process (``pmesh.ShardPool``): the parent's numerics
    settings, the models from their bytes onto ``device``, the lane program,
    and its own episodes (``indices``, every shard's in batch order) loaded
    from its copy of the stream, ahead of the device as in one process;
    then :func:`_shard_step`."""
    program_kw, blob, threads, tf32, stream, indices = payload
    torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if device.type == "cuda":
        torch.cuda.set_device(device)
    models = torch.load(io.BytesIO(blob), map_location=device, weights_only=False)
    return _shard_step(ee.make_eval_program(**program_kw), models, stream.iterate(indices), device)


def _transfer_cfg(a) -> ee.TransferCfg:
    return ee.TransferCfg(fine_tune_epochs=a.fine_tune_epoch, inner_param_dtype=a.inner_param_dtype,
                          inner_scan=a.inner_scan, bn_mode=a.bn_mode, freeze_backbone=a.freeze_backbone,
                          ensemble_fuse=a.ensemble_fuse, fanout_group_pass=a.fanout_group_pass,
                          inner_gather=a.inner_gather, inner_carry=a.inner_carry)


def _episode_stream(a, manifest, spec):
    if a.episode_manifest:
        stream = ReplayEpisodeStream.from_json(a.episode_manifest, spec, base_size=a.base_size,
                                               root=a.episode_manifest_root)
        a.iter_num = len(stream)
        print(f"replaying {a.iter_num} recorded episodes from {a.episode_manifest}")
        return stream
    return EpisodeStream(manifest, spec, a.iter_num, base_size=a.base_size, seed=a.seed, cache_dir=a.episode_cache)


def _episode_seeds(a, first: int, n: int) -> list:
    """One generator seed per episode, by its index: the same draws at any
    ``--eval_batch``, mesh or world."""
    return [a.seed * 1_000_003 + first + j for j in range(n)]


def _plan(a, n_shards: int):
    """``(batches, shards, own)`` of the eval over ``n_shards`` shards: the
    ``(first episode, episodes)`` of each global batch of ``--eval_batch``
    times ``n_shards`` episodes, each batch's shards (slices of it; the last
    batch may leave shards short or empty), and each shard's episodes over
    all batches in order."""
    global_batch = a.eval_batch * n_shards
    batches = [(b, min(global_batch, a.iter_num - b)) for b in range(0, a.iter_num, global_batch)]
    shards = [pmesh.episode_sharding(-(-n // a.eval_batch), n, a.eval_batch) for _, n in batches]
    own = [[b + i for (b, _), sl in zip(batches, shards) if k < len(sl) for i in range(sl[k].start, sl[k].stop)]
           for k in range(n_shards)]
    return batches, shards, own


class _RankShards:
    """The ranks of a process group as the eval's shards, with
    ``pmesh.ShardPool``'s ``map``: rank r runs shard r of each batch here
    (``step``, :func:`_shard_step`), then every rank gathers every rank's
    answer (``all_gather_object``, between lane batches: the lane batch
    itself issues no collective)."""

    def __init__(self, step, group):
        self.step, self.group = step, group
        self.rank, self.world = pdist.rank_world(group)

    def map(self, messages) -> list:
        mine = self.step(*messages[self.rank]) if self.rank < len(messages) else None
        every = [None] * self.world
        dist.all_gather_object(every, mine, group=self.group)
        return every[: len(messages)]


def evaluate(a, models, manifest, *, aug_cfg, bcfg, gcfg, spec, device, dcfg=None, logger=None,
             mesh_devices=None, keep_scores: bool = False, group=None) -> EvalResult:
    """The episode loop; prints each episode's accuracy (and logs it to
    ``logger``).  The episodes run in global batches of ``--eval_batch``
    times the mesh's width (``mesh_devices``; by default every visible card
    for a plain ``cuda`` device, as the JAX driver spans every device, and
    ``device`` alone for ``cuda:<i>`` or the CPU): on a mesh of one device
    the batch runs in this process; on a wider one
    each device takes the next ``--eval_batch`` episodes (the last may be
    short) in a worker process of its own (``pmesh.ShardPool``), which loads
    them itself, and the answers are gathered in episode order.
    ``group`` (a ``torch.distributed`` process group, ``parallel/
    distributed.py``): the ranks are the shards, rank r the r-th of each
    global batch of ``--eval_batch`` times the world, run in this process on
    ``device``; every rank returns the whole eval (:class:`_RankShards`).
    ``keep_scores``: the result carries every episode's scores on the CPU.
    Each global batch is a lane batch of the span recorder
    (``utils/metrics.eval_batch``, ``eval:batch``), from its first episode's
    wait to the end of its report: the stream's ``input:wait`` for each
    episode, ``input:stack``, ``eval:run`` (the batch's seconds, with
    ``input:to_device`` and the eval engine's phases inside) and
    ``eval:report``."""
    program_kw = dict(method=a.method, bcfg=bcfg, gcfg=gcfg, spec=spec, tcfg=_transfer_cfg(a), aug_cfg=aug_cfg,
                      gen_examples=a.gen_examples, dcfg=dcfg, dampnet_eval=a.dampnet_eval)
    if group is not None:
        rank, world = pdist.rank_world(group)
        mesh = [device] * world
    else:
        if mesh_devices is None:
            mesh_devices = None if device.type == "cuda" and device.index is None else [device]
        mesh, _ = plan_eval_mesh(a.eval_batch, mesh_devices)
    stream = _episode_stream(a, manifest, spec)
    batches, shards, own = _plan(a, len(mesh))
    accs, scores, seconds, batch_seconds, shard_seconds, launches, marks = [], [], [], [], [], {}, []
    pool = None
    with contextlib.ExitStack() as stack:
        if group is not None or len(mesh) == 1:
            program = ee.make_eval_program(**program_kw)
            models = pytree.tree_map(lambda t: t.to(mesh[0]) if isinstance(t, torch.Tensor) else t, models)
            if group is None:
                episodes = iter(stream)
            else:
                pool = _RankShards(_shard_step(program, models, stream.iterate(own[rank]), device), group)
        else:
            blob = io.BytesIO()
            torch.save(models, blob)
            common = (program_kw, blob.getvalue(), torch.get_num_threads(),
                      (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32), stream)
            pool = stack.enter_context(pmesh.ShardPool(mesh, _shard_worker, [common + (ix,) for ix in own]))
        for k, ((done, n), slices) in enumerate(zip(batches, shards)):
            with eval_batch(k, n) as mark:
                seeds = _episode_seeds(a, done, n)
                if pool is None:
                    images = _next_images(episodes, n)
                    with span("eval:run") as ran:
                        batch_scores, batch_accs = _run_shard(program, models, images, _generators(seeds), mesh[0])
                        if mesh[0].type == "cuda":
                            torch.cuda.synchronize(mesh[0])
                        if keep_scores:
                            scores += list(batch_scores.float().cpu())
                else:
                    with span("eval:run") as ran:
                        answers = pool.map([(seeds[s],) for s in slices])
                        batch_accs = [acc for _, shard_accs, _, _ in answers for acc in shard_accs]
                        for shard_scores, _, counts, _ in answers:
                            if keep_scores:
                                scores += list(shard_scores)
                            for name, c in counts.items():
                                launches[name] = launches.get(name, 0) + c
                        shard_seconds.append([t for *_, t in answers])
                batch_seconds.append(ran.seconds)
                seconds += [batch_seconds[-1] / n] * n
                with span("eval:report"):
                    for j, acc in enumerate(batch_accs):
                        print(acc)  # per-episode accuracy (reference finetune.py:631)
                        if logger:
                            logger._write({"kind": "episode", "index": done + j, "acc": acc})
                accs += batch_accs
            marks.append(mark)
    mean, ci = ee.mean_ci95(np.asarray(accs))
    return EvalResult(mean, ci, accs, seconds, batch_seconds, _episodes_per_sec(marks),
                      scores if keep_scores else None, launches, shard_seconds)


def _refuse_unported(a):
    cfg_mod.check_model(a.model)
    if a.method not in ee.METHODS:
        raise NotImplementedError(f"not ported yet: --method {a.method}")
    if a.inner_scan == "fused" and not bb.final_block_has_shortcut(bb.MODEL_REGISTRY[a.model]()):
        raise SystemExit(f"--inner_scan fused: the scan's kernels take a final block with a 1x1 shortcut conv "
                         f"(ResNet10, ResNet10_FW); {a.model}'s final block has an identity shortcut, so it runs "
                         "--inner_scan eager")
    if not a.method.startswith("dampnet") and (a.unsupervised or a.dampnet_eval != "finetune"):
        raise SystemExit("--unsupervised and --dampnet_eval apply to --method dampnet|dampnet_full|dampnet_full_class")


def main(argv=None, *, mesh_devices=None, keep_scores: bool = False) -> EvalResult:
    """``mesh_devices``: the eval's episode mesh (:func:`evaluate`), devices
    in shard order, a device named twice runs two shards; ``keep_scores``:
    the result carries every episode's scores."""
    a = cfg_mod.parse_finetune_args(argv)
    _refuse_unported(a)
    device = resolve_device(a.device)
    if device.type == "cuda":
        # f32 means f32: cuDNN would otherwise run f32 convs in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    np.random.seed(a.seed)
    paths = cfg_mod.Paths.load(a.paths_json)
    spec = EpisodeSpec(a.test_n_way, a.n_shot, a.n_query if a.n_query > 0 else 15)
    bcfg = bb.MODEL_REGISTRY[a.model]()._replace(compute_dtype=a.dtype)
    gcfg = gn.GnnNetCfg(feat_dim=bcfg.feat_dim, n_way=a.test_n_way, n_support=a.n_shot,
                        support_compress=2 if a.n_shot >= 50 else 1, use_pallas=a.use_pallas)
    entry = registry.get(a.test_dataset)
    print(f"Loading {a.test_dataset}")
    manifest = registry.build_manifest(entry, paths.as_dict(), split="novel")
    dcfg = dn.method_cfg(a.method, bcfg.feat_dim, a.test_n_way, a.n_shot) if a.method.startswith("dampnet") else None
    models = build_models(a, paths, bcfg, device, dcfg)
    if dcfg is not None:
        prepare_dampnet(a, paths, models, bcfg, device)
    logger = MetricLogger(jsonl_path=os.path.join(paths.save_dir, "eval_log.jsonl"))
    with profile_trace(a.trace_dir):
        res = evaluate(a, models, manifest, aug_cfg=entry.eval_aug._replace(image_size=a.image_size), bcfg=bcfg,
                       gcfg=gcfg, spec=spec, device=device, dcfg=dcfg, logger=logger, mesh_devices=mesh_devices,
                       keep_scores=keep_scores)
    print(a.test_dataset)
    logger.log_eval(a.iter_num, res.mean, res.ci95, eps_per_sec=res.episodes_per_sec)  # the "N Test Acc" line
    print(f"episodes/sec = {res.episodes_per_sec:.3f} (after the first batch, the time between batches included)")
    print(f"seconds/episode = {np.mean(res.seconds):.3f}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
