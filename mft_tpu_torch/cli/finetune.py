"""Cross-domain evaluation driver of the port (counterpart of
``mft_tpu/cli/finetune.py``).

For each of ``--iter_num`` episodes of the test dataset (or each episode
of ``--episode_manifest``): fan the support set out into ``gen_examples``
augmented replicas (+ the triple clean copy), fine-tune the pretrained
backbone's last block (``--bn_mode``), score with the requested head, and
report mean accuracy +- 1.96*std/sqrt(n) (reference finetune.py:424-682).
At ``--n_shot >= 50`` the GnnNet head is the compressed 50-shot variant
(reference finetune_50.py, gnnnet_copy.py).  Checkpoints are the
reference's ``<epoch>.tar`` state dicts (what ``mft_tpu.cli.export_ckpt``
and ``mft_tpu_torch.cli.train`` write).

Run: ``python -m mft_tpu_torch.cli.finetune --method all --use_pallas
--test_dataset CropDisease --n_shot 5 --fine_tune_epoch 5 --gen_examples 17``
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from mft_tpu_torch import config as cfg_mod
from mft_tpu_torch import resolve_device
from mft_tpu_torch.convert import from_state_dict, load_tar
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.data import registry
from mft_tpu_torch.data.pipeline import EpisodeStream, ReplayEpisodeStream
from mft_tpu_torch.methods import gnnnet as gn
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.train import eval_engine as ee
from mft_tpu_torch.utils import checkpoint as ckpt


class EvalResult(NamedTuple):
    mean: float
    ci95: float
    accs: list
    #: device seconds of each episode (host clock, synchronized)
    seconds: list


def _load(path, bcfg, device, need_head: bool):
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path!r} not found")
    _, sd = load_tar(path)
    params, stats = from_state_dict(sd, bcfg, device=device)
    if need_head and "gnn" not in params:
        raise ValueError(f"checkpoint {path!r} holds no GnnNet head (fc.* / gnn.*)")
    return params, stats


def build_models(a, paths, bcfg, device):
    """Resolve and load the checkpoints the method needs
    (finetune.py:439-550).  ``--method all`` keeps the reference's quirks:
    the baseline is pinned at epoch 400 (latest with ``--save_iter -1``) in a
    train_aug-gated dir; the GNN at epoch 600 with ``_aug`` always appended
    (finetune.py:121-137 of the JAX driver).  ``gnnnet``, ``gnnnet_maml`` and
    ``protonet`` read their own method's directory at ``--save_iter`` (the
    best file with -1); a ProtoNet checkpoint is a backbone alone."""
    models = {}
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


def evaluate(a, models, manifest, *, aug_cfg, bcfg, gcfg, spec, device) -> EvalResult:
    """The episode loop; prints each episode's accuracy."""
    tcfg = ee.TransferCfg(fine_tune_epochs=a.fine_tune_epoch, inner_param_dtype=a.inner_param_dtype,
                           inner_scan=a.inner_scan, bn_mode=a.bn_mode)
    program = ee.make_eval_program(method=a.method, bcfg=bcfg, gcfg=gcfg, spec=spec, tcfg=tcfg, aug_cfg=aug_cfg,
                                   gen_examples=a.gen_examples)
    if a.episode_manifest:
        stream = ReplayEpisodeStream.from_json(a.episode_manifest, spec, base_size=a.base_size,
                                               root=a.episode_manifest_root)
        a.iter_num = len(stream)
        print(f"replaying {a.iter_num} recorded episodes from {a.episode_manifest}")
    else:
        stream = EpisodeStream(manifest, spec, a.iter_num, base_size=a.base_size, seed=a.seed)
    accs, seconds = [], []
    for i, (images, _) in enumerate(stream):
        gen = torch.Generator().manual_seed(a.seed * 1_000_003 + i)
        t0 = time.perf_counter()
        base = torch.from_numpy(images).to(device).permute(0, 1, 4, 2, 3)  # NHWC -> NCHW
        _, acc = program(models, base, gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        accs.append(acc)
        print(acc)  # per-episode accuracy (reference finetune.py:631)
    mean, ci = ee.mean_ci95(np.asarray(accs))
    return EvalResult(mean, ci, accs, seconds)


def _refuse_unported(a):
    unported = {
        f"--method {a.method} (ROADMAP Queue 1 item 16, DampNet)": a.method.startswith("dampnet"),
        f"--method {a.method}": a.method not in ee.METHODS and not a.method.startswith("dampnet"),
        f"--model {a.model} (ROADMAP Queue 1 item 18, the other backbones)": a.model not in bb.MODEL_REGISTRY,
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)} (mft_tpu.cli.finetune has them)")


def main(argv=None) -> EvalResult:
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
    models = build_models(a, paths, bcfg, device)
    res = evaluate(a, models, manifest, aug_cfg=entry.eval_aug._replace(image_size=a.image_size), bcfg=bcfg,
                   gcfg=gcfg, spec=spec, device=device)
    print(a.test_dataset)
    print("%d Test Acc = %4.2f%% +- %4.2f%%" % (a.iter_num, res.mean, res.ci95))
    print(f"seconds/episode = {np.mean(res.seconds):.3f}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
