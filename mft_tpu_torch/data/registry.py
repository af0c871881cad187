"""Dataset registry (a copy of ``mft_tpu/data/registry.py``): one parameterized table replacing the reference's eight
copied dataset modules (SURVEY.md §1 "collapse this to one parameterized
registry").

Each entry records the manifest builder, the class count, and the train/eval
augmentation hyperparameters lifted from the per-dataset TransformLoader /
TransformLoader2 definitions (citations inline).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

from mft_tpu_torch.data import manifests as mf
from mft_tpu_torch.ops.augment import AugmentCfg

# torchvision RandomResizedCrop defaults (miniImageNet train pipeline,
# datasets/miniImageNet_few_shot.py:122-123 + data/datamgr.py:25-26)
_MINI_TRAIN = AugmentCfg(scale_min=0.08, scale_max=1.0, brightness=0.4, contrast=0.4, color=0.4, hflip=True)

_REGISTRY = {}


@dataclass(frozen=True)
class DatasetEntry:
    name: str
    n_classes: Optional[int]
    builder: Callable[..., mf.Manifest]  # (cfg_paths) -> Manifest
    train_aug: AugmentCfg
    eval_aug: AugmentCfg
    #: optional per-split builders for filelist-backed datasets
    #: (base/val/novel.json — the reference's data/ JSON pipeline,
    #: data/dataset.py:10-26); ``builder`` stays the training (base) split.
    split_builders: Optional[dict] = None


def register(entry: DatasetEntry):
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> DatasetEntry:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build_manifest(entry: DatasetEntry, paths: dict, split: Optional[str] = None) -> mf.Manifest:
    """Build the manifest for ``split`` if the dataset is split-aware
    (filelist-backed), else the dataset's single manifest."""
    if split and entry.split_builders and split in entry.split_builders:
        return entry.split_builders[split](paths)
    return entry.builder(paths)


def names():
    return sorted(_REGISTRY)


def _filelist_splits(path_key: str) -> dict:
    """base/val/novel.json builders rooted at ``paths[path_key]``."""
    return {
        s: (lambda paths, s=s: mf.json_filelist(os.path.join(paths[path_key], f"{s}.json")))
        for s in ("base", "val", "novel")
    }


register(
    DatasetEntry(
        "miniImageNet",
        64,
        lambda paths: mf.image_folder(paths["miniImageNet"]),
        train_aug=_MINI_TRAIN,
        eval_aug=_MINI_TRAIN,
    )
)

register(
    DatasetEntry(
        "CropDisease",
        38,
        lambda paths: mf.image_folder(os.path.join(paths["CropDisease"], "dataset", "train")),
        # CropDisease_few_shot.py:214,225: jitter .1/.1/.05, scale (0.6,0.9), H flip
        train_aug=AugmentCfg(scale_min=0.6, scale_max=0.9, brightness=0.1, contrast=0.1, color=0.05, hflip=True),
        # TransformLoader2 :248,259,271: jitter .2/.2/.05, scale (0.5,0.9), H+V flips
        eval_aug=AugmentCfg(scale_min=0.5, scale_max=0.9, brightness=0.2, contrast=0.2, color=0.05, hflip=True, vflip=True),
    )
)

register(
    DatasetEntry(
        "EuroSAT",
        10,
        lambda paths: mf.image_folder(paths["EuroSAT"]),
        # EuroSAT_few_shot.py:210,221,233: jitter .1/.1/.05, scale (0.5,0.9), H+V
        train_aug=AugmentCfg(scale_min=0.5, scale_max=0.9, brightness=0.1, contrast=0.1, color=0.05, hflip=True, vflip=True),
        eval_aug=AugmentCfg(scale_min=0.5, scale_max=0.9, brightness=0.1, contrast=0.1, color=0.05, hflip=True, vflip=True),
    )
)

register(
    DatasetEntry(
        "ISIC",
        7,
        lambda paths: mf.isic_csv(
            os.path.join(paths["ISIC"], "ISIC2018_Task3_Training_GroundTruth", "ISIC2018_Task3_Training_GroundTruth.csv"),
            os.path.join(paths["ISIC"], "ISIC2018_Task3_Training_Input"),
        ),
        # ISIC_few_shot.py:268,279,291: jitter .1/.1/.05, scale (0.5,0.9), H+V
        train_aug=AugmentCfg(scale_min=0.5, scale_max=0.9, brightness=0.1, contrast=0.1, color=0.05, hflip=True, vflip=True),
        eval_aug=AugmentCfg(scale_min=0.5, scale_max=0.9, brightness=0.1, contrast=0.1, color=0.05, hflip=True, vflip=True),
    )
)

register(
    DatasetEntry(
        "ChestX",
        7,
        lambda paths: mf.chestx_csv(
            os.path.join(paths["ChestX"], "Data_Entry_2017.csv"), os.path.join(paths["ChestX"], "images")
        ),
        # Chest_few_shot.py:299,312,326: jitter .1/.1/.001, scale (0.6,0.95), no flips
        train_aug=AugmentCfg(scale_min=0.6, scale_max=0.95, brightness=0.1, contrast=0.1, color=0.001, hflip=False),
        eval_aug=AugmentCfg(scale_min=0.6, scale_max=0.95, brightness=0.1, contrast=0.1, color=0.001, hflip=False),
    )
)

register(
    DatasetEntry(
        "DTD",
        47,
        lambda paths: mf.image_folder(paths["DTD"]),
        train_aug=_MINI_TRAIN,  # DTD_few_shot.py uses the generic train stack
        eval_aug=_MINI_TRAIN,
    )
)

register(
    DatasetEntry(
        "cifar100",
        34,  # base split = label % 3 == 0 (cifar_few_shot.py:27-29,63-71)
        lambda paths: mf.cifar100(paths["cifar100"], "base"),
        train_aug=_MINI_TRAIN,
        eval_aug=_MINI_TRAIN,
    )
)

register(
    DatasetEntry(
        "caltech256",
        256,  # folders 001..256; clutter never globbed (caltech256_few_shot.py:51-54)
        lambda paths: mf.caltech256(paths["caltech256"]),
        train_aug=_MINI_TRAIN,
        eval_aug=_MINI_TRAIN,
    )
)

register(
    DatasetEntry(
        "CUB",
        None,  # split-dependent (200 classes split by index, write_CUB_filelist.py)
        lambda paths: mf.json_filelist(os.path.join(paths["CUB"], "base.json")),
        train_aug=_MINI_TRAIN,  # generic train stack via data/datamgr.py:11-43
        eval_aug=_MINI_TRAIN,
        split_builders=_filelist_splits("CUB"),
    )
)

register(
    DatasetEntry(
        "cross",
        None,  # base = all 100 miniImageNet classes; val/novel from CUB
        lambda paths: mf.json_filelist(os.path.join(paths["cross"], "base.json")),
        train_aug=_MINI_TRAIN,
        eval_aug=_MINI_TRAIN,
        split_builders=_filelist_splits("cross"),
    )
)

register(
    DatasetEntry(
        "synthetic",
        10,
        lambda paths: mf.synthetic(),
        train_aug=_MINI_TRAIN,
        eval_aug=AugmentCfg(scale_min=0.5, scale_max=0.9, brightness=0.2, contrast=0.2, color=0.05, hflip=True, vflip=True),
    )
)
