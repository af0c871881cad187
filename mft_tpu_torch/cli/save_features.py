"""Feature extraction driver of the port (counterpart of
``mft_tpu/cli/save_features.py``).

The upstream cdfsl-benchmark ``save_features.py`` stage, absent from the
reference but for its flags (io_utils.py:38-40) and its consumer
(data/feature_loader.py): embed a dataset split with a trained backbone, in
eval mode (running BN statistics), batches of 64 with the last one
zero-padded, and write ``{all_feats, all_labels, count}``
(``data/feature_store.py``) to ``<save_dir>/features/<dataset>/<model>_
<method>.../<split>.npz`` for ``cli.test``.  The checkpoint is the
reference's ``<epoch>.tar`` in the method's directory (``--save_iter``, or
the best file).

Run: ``python -m mft_tpu_torch.cli.save_features --dataset miniImageNet
--method baseline --split novel``
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from mft_tpu_torch import config as cfg_mod
from mft_tpu_torch import resolve_device
from mft_tpu_torch.data import registry
from mft_tpu_torch.data.feature_store import save_features
from mft_tpu_torch.data.pipeline import WORKERS, decode_image
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.ops.augment import center_batch, pipeline_dtype
from mft_tpu_torch.utils import checkpoint as ckpt

#: images a batch (the JAX driver's)
BATCH = 64


class SaveResult(NamedTuple):
    path: str
    n_images: int
    #: host seconds of the embedding loop (decode included)
    seconds: float


def model_dir(a, paths) -> str:
    """The checkpoint directory of ``--method`` (the JAX drivers' rule: no
    way/shot suffix for the baseline)."""
    baseline = a.method in ("baseline", "baseline++")
    return cfg_mod.checkpoint_dir(paths, a.dataset, a.model, a.method, train_aug=a.train_aug,
                                  n_way=None if baseline else a.train_n_way, n_shot=a.n_shot)


def features_path(a, paths) -> str:
    return os.path.join(model_dir(a, paths).replace("checkpoints", "features"), f"{a.split}.npz")


def main(argv=None) -> SaveResult:
    a = cfg_mod.parse_features_args("save_features", argv)
    cfg_mod.check_model(a.model)
    device = resolve_device(a.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    paths = cfg_mod.Paths.load(a.paths_json)
    bcfg = bb.MODEL_REGISTRY[a.model]()._replace(compute_dtype=a.dtype)
    d = model_dir(a, paths)
    path = ckpt.get_assigned_file(d, a.save_iter) if a.save_iter != -1 else ckpt.get_best_file(d)
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path!r} not found")
    _, params, stats, _ = ckpt.load_checkpoint(path, bcfg, None, device=device)
    manifest = registry.build_manifest(registry.get(a.dataset), paths.as_dict(), split=a.split)
    items, dt = manifest.items, pipeline_dtype(bcfg.compute_dtype)
    feats = []
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(WORKERS) as pool, torch.no_grad():
        for i in range(0, len(items), BATCH):
            chunk = items[i : i + BATCH]
            imgs = np.stack(list(pool.map(lambda it: decode_image(it, a.base_size), chunk)))
            if len(chunk) < BATCH:  # static batch shapes, as the JAX driver's; eval-mode BN keeps rows apart
                imgs = np.concatenate([imgs, np.zeros((BATCH - len(chunk),) + imgs.shape[1:], imgs.dtype)])
            x = center_batch(torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2), a.image_size, dtype=dt)
            f, _ = bb.apply_backbone(params["feature"], stats, x, cfg=bcfg, train=False)
            feats.append(f[: len(chunk)].float().cpu().numpy())
    seconds = time.perf_counter() - t0
    out = features_path(a, paths)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_features(out, np.concatenate(feats), np.asarray(manifest.labels[: len(items)]))
    print(f"saved {len(items)} features to {out} ({seconds:.3f} s)")
    return SaveResult(out, len(items), seconds)


if __name__ == "__main__":
    main(sys.argv[1:])
