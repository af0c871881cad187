"""Paths, checkpoint layout and the flag sets of the eval and training
drivers (port of ``mft_tpu/config.py``; the logic is a copy, the flags are
those of the JAX drivers that the port implements, plus ``--device``).

Only flags that the port acts on are defined, so argparse rejects the JAX
drivers' others (eval: ``--freeze_backbone``, ``--eval_batch``; both:
``--episode_cache``, ``--trace_dir`` and the dampnet-only flags).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass


@dataclass
class Paths:
    """Dataset roots + save dir (reference configs.py:1-9)."""

    save_dir: str = "./logs"
    miniImageNet: str = "content/miniImagenet3"
    DTD: str = "/ssd/dtd/images/"
    ISIC: str = "content"
    ChestX: str = "content"
    CropDisease: str = "content/CropDiseases"
    EuroSAT: str = "content/2750"
    cifar100: str = "content/cifar100"
    caltech256: str = "content/caltech256"
    CUB: str = "filelists/CUB"
    cross: str = "filelists/cross"

    @classmethod
    def load(cls, json_path: str | None = None) -> "Paths":
        """Defaults <- optional JSON file (MFT_TPU_PATHS or ./mft_paths.json)
        <- MFT_<NAME>_PATH env vars."""
        p = cls()
        json_path = json_path or os.environ.get("MFT_TPU_PATHS")
        if json_path is None and os.path.exists("mft_paths.json"):
            json_path = "mft_paths.json"
        if json_path and os.path.exists(json_path):
            with open(json_path) as f:
                for k, v in json.load(f).items():
                    if hasattr(p, k):
                        setattr(p, k, v)
        for f_ in dataclasses.fields(cls):
            env = os.environ.get(f"MFT_{f_.name.upper()}_PATH")
            if env:
                setattr(p, f_.name, env)
        return p

    def as_dict(self):
        return dataclasses.asdict(self)


def checkpoint_dir(paths: Paths, dataset: str, model: str, method: str, *, train_aug: bool,
                   n_way: int | None = None, n_shot: int | None = None) -> str:
    """``<save_dir>/checkpoints/<dataset>/<model>_<method>[_aug][_<W>way_<S>shot]``
    (reference train.py:175-180)."""
    d = os.path.join(paths.save_dir, "checkpoints", dataset, f"{model}_{method}")
    if train_aug:
        d += "_aug"
    if method not in ("baseline", "baseline++") and n_way is not None:
        d += f"_{n_way}way_{n_shot}shot"
    return d


def parse_finetune_args(argv=None):
    """The eval driver's flags (reference io_utils.py:10-47 + the JAX
    package's extras).  Defaults to the fast bf16 path, as
    ``mft_tpu.cli.finetune`` does; ``--dtype float32 --inner_param_dtype
    float32`` is the strict one."""
    ap = argparse.ArgumentParser(description="mft_tpu_torch cross-domain few-shot eval")
    ap.add_argument("--device", default="cuda", help="torch device; 'cuda' raises when no card is present")
    ap.add_argument("--dataset", default="miniImageNet", help="training base dataset (checkpoint dir)")
    ap.add_argument("--test_dataset", default="", help="cross-domain test dataset")
    ap.add_argument("--model", default="ResNet10", help="backbone architecture")
    ap.add_argument("--method", default="baseline", help="all | gnnnet | gnnnet_maml | baseline | protonet")
    ap.add_argument("--train_n_way", default=5, type=int)
    ap.add_argument("--test_n_way", default=5, type=int)
    ap.add_argument("--n_shot", default=5, type=int)
    ap.add_argument("--train_aug", action="store_true")
    ap.add_argument("--save_iter", default=-1, type=int)
    ap.add_argument("--fine_tune_epoch", default=100, type=int)
    ap.add_argument("--gen_examples", default=10, type=int)
    ap.add_argument("--image_size", default=224, type=int)
    ap.add_argument("--base_size", default=-1, type=int, help="host decode resolution; -1 = int(1.15*image_size)")
    ap.add_argument("--iter_num", default=600, type=int, help="eval episodes")
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--inner_param_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--n_query", default=-1, type=int, help="queries per class; -1 = 15")
    ap.add_argument("--seed", default=10, type=int)
    ap.add_argument("--paths_json", default=None)
    ap.add_argument("--use_pallas", action="store_true", help="the CUDA edge kernel in the GNN head")
    ap.add_argument("--inner_scan", default="eager", choices=["eager", "fused"],
                    help="the GNN member's inner loop: one eager step per minibatch, or the fused CUDA scan")
    ap.add_argument("--bn_mode", default="episode", choices=["episode", "minibatch"],
                    help="inner loop: the final block on a frozen-trunk feature bank (episode), or the whole backbone "
                         "on every minibatch (minibatch, the reference's own semantics)")
    ap.add_argument("--episode_manifest", default=None,
                    help="JSON of recorded episodes ({'episodes': [...]}: n_way lists of n_shot + n_query paths) to "
                         "replay instead of sampling; --iter_num becomes its length")
    ap.add_argument("--episode_manifest_root", default=None, help="base directory of the manifest's relative paths")
    a = ap.parse_args(argv)
    if a.base_size <= 0:
        a.base_size = int(a.image_size * 1.15)
    return a


def parse_train_args(argv=None):
    """The training driver's flags (reference io_utils.py:10-47, the train
    branch, + the JAX package's extras that the port implements).  Defaults
    as in ``mft_tpu.cli.train``: strict f32, ``--stop_epoch`` inclusive."""
    ap = argparse.ArgumentParser(description="mft_tpu_torch few-shot training")
    ap.add_argument("--device", default="cuda", help="torch device; 'cuda' raises when no card is present")
    ap.add_argument("--dataset", default="miniImageNet", help="training base dataset")
    ap.add_argument("--model", default="ResNet10", help="backbone architecture")
    ap.add_argument("--method", default="baseline", help="baseline | gnnnet | protonet")
    ap.add_argument("--train_n_way", default=5, type=int)
    ap.add_argument("--test_n_way", default=5, type=int)
    ap.add_argument("--n_shot", default=5, type=int)
    ap.add_argument("--n_query", default=-1, type=int,
                    help="queries per class; -1 = the reference rule max(1, int(16*test_n_way/train_n_way))")
    ap.add_argument("--train_aug", action="store_true")
    ap.add_argument("--fine_tune", action="store_true", help="meta fine-tuning stage (FO-MAML)")
    ap.add_argument("--num_classes", default=200, type=int)
    ap.add_argument("--save_freq", default=50, type=int)
    ap.add_argument("--start_epoch", default=0, type=int)
    ap.add_argument("--stop_epoch", default=400, type=int,
                    help="LAST epoch index, inclusive (the reference's --stop_epoch 401 is this --stop_epoch 400)")
    ap.add_argument("--episodes_per_epoch", default=100, type=int)
    ap.add_argument("--batch_size", default=16, type=int, help="baseline pretraining batch")
    ap.add_argument("--episode_batch", default=1, type=int, help="episodes per training step")
    ap.add_argument("--bn_mode", default="episode", choices=["episode", "minibatch"],
                    help="meta fine-tune inner loop: stop-gradient trunk bank, or the whole backbone per minibatch")
    ap.add_argument("--image_size", default=224, type=int)
    ap.add_argument("--base_size", default=-1, type=int, help="host decode resolution; -1 = int(1.15*image_size)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--seed", default=10, type=int, help="reference seed discipline (train.py:69)")
    ap.add_argument("--paths_json", default=None)
    ap.add_argument("--use_pallas", action="store_true", help="the CUDA edge kernel in the GNN head")
    ap.add_argument("--episode_manifest", default=None,
                    help="JSON of recorded episodes ({'episodes': [...]}) or, for --method baseline, batches "
                         "({'batches': [...]}) to replay instead of sampling")
    ap.add_argument("--episode_manifest_root", default=None, help="base directory of the manifest's relative paths")
    a = ap.parse_args(argv)
    if a.base_size <= 0:
        a.base_size = int(a.image_size * 1.15)
    return a
