"""Dataset manifests: (image source, integer label) lists.

A copy of ``mft_tpu/data/manifests.py`` (the port imports nothing of the
JAX package).

One parameterized layer replacing the reference's eight near-identical
dataset modules (SURVEY.md §2.4).  A manifest is just two parallel lists —
``items`` (file paths or in-memory arrays) and ``labels`` — plus the class
count; all sampling and decoding happens downstream.

Sources with reference citations:

* ImageFolder walk — CropDisease / EuroSAT / DTD / miniImageNet use
  ``torchvision.datasets.ImageFolder`` (e.g. CropDisease_few_shot.py:32),
* JSON filelists ``{label_names, image_names, image_labels}`` written by the
  filelists/ tooling (data/dataset.py:10-26, write_miniImagenet_filelist.py),
* ISIC: CSV ground truth, label = argmax of the one-hot columns
  (ISIC_few_shot.py:19-59),
* ChestX: Data_Entry_2017.csv filtered to 7 single-label pathologies
  (Chest_few_shot.py:19-74),
* CIFAR-100: base/val/novel split by class-index groups
  (cifar_few_shot.py:12-98).
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".tif", ".tiff", ".webp"}


@dataclass
class Manifest:
    items: List  # file paths (str) or ndarray images
    labels: np.ndarray  # int64 [n]
    n_classes: int
    class_names: Optional[List[str]] = None

    def by_class(self) -> List[np.ndarray]:
        """Per-class index lists (the reference's ``sub_meta`` grouping,
        data/dataset.py:35-41)."""
        return [np.nonzero(self.labels == c)[0] for c in range(self.n_classes)]

    def __len__(self):
        return len(self.items)


def image_folder(root: str, exclude_prefixes: tuple = ()) -> Manifest:
    """torchvision ImageFolder semantics: class = sorted subdirectory name.

    ``exclude_prefixes``: class directories whose name starts with one of
    these are dropped (see :func:`caltech256`)."""
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d))
        and not (exclude_prefixes and d.startswith(tuple(exclude_prefixes)))
    )
    items, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for dirpath, _, fnames in sorted(os.walk(cdir)):
            for f in sorted(fnames):
                if os.path.splitext(f)[1].lower() in IMG_EXTS:
                    items.append(os.path.join(dirpath, f))
                    labels.append(ci)
    return Manifest(items, np.asarray(labels, np.int64), len(classes), classes)


def caltech256(root: str) -> Manifest:
    """Caltech-256 with the reference's effective class set: its loader
    globs ``'%03d*' % cat`` for cat in range(0, 257)
    (caltech256_few_shot.py:51-54), so folder ``000*`` never exists (label 0
    is a ghost empty class) and ``257.clutter`` is never reached — the
    usable classes are folders 001..256, clutter EXCLUDED.  Labels here are
    the compacted 0..255 (the reference's raw 1..256 numbering into its
    257-way baseline classifier is a class-index permutation with dead
    outputs; the classifier is discarded at eval)."""
    return image_folder(root, exclude_prefixes=("257",))


def json_filelist(path: str) -> Manifest:
    """The ``base/val/novel.json`` filelist format (data/dataset.py:10-26)."""
    with open(path) as f:
        meta = json.load(f)
    labels = np.asarray(meta["image_labels"], np.int64)
    uniq = np.unique(labels)
    remap = {int(c): i for i, c in enumerate(uniq)}
    labels = np.asarray([remap[int(l)] for l in labels], np.int64)
    return Manifest(list(meta["image_names"]), labels, len(uniq), meta.get("label_names"))


def isic_csv(csv_path: str, image_dir: str) -> Manifest:
    """ISIC2018 Task 3 ground truth: first column = image name, remaining
    one-hot columns -> label = the FIRST NONZERO column
    (``(labels != 0).argmax(axis=1)``, ISIC_few_shot.py:39-40 — identical to
    a value argmax for one-hot rows, but matched exactly)."""
    import csv as _csv

    items, labels = [], []
    with open(csv_path) as f:
        reader = _csv.reader(f)
        header = next(reader)
        n_classes = len(header) - 1
        for row in reader:
            items.append(os.path.join(image_dir, row[0] + ".jpg"))
            labels.append(int(np.argmax([float(v) != 0 for v in row[1:]])))
    return Manifest(items, np.asarray(labels, np.int64), n_classes, header[1:])


#: the 7 single-label pathologies kept by the reference (Chest_few_shot.py:38-44)
CHESTX_LABELS = ["Atelectasis", "Cardiomegaly", "Effusion", "Infiltration", "Mass", "Nodule", "Pneumothorax"]


def chestx_csv(csv_path: str, image_dir: str) -> Manifest:
    import csv as _csv

    name_to_idx = {n: i for i, n in enumerate(CHESTX_LABELS)}
    items, labels = [], []
    with open(csv_path) as f:
        reader = _csv.reader(f)
        header = next(reader)
        for row in reader:
            finding = row[1]
            if finding in name_to_idx:  # single-label rows only
                items.append(os.path.join(image_dir, row[0]))
                labels.append(name_to_idx[finding])
    return Manifest(items, np.asarray(labels, np.int64), len(CHESTX_LABELS), CHESTX_LABELS)


def cifar100(root: str, split: str = "base") -> Manifest:
    """CIFAR-100 from the standard python pickle archive, with the
    reference's base/val/novel class grouping (cifar_few_shot.py:27-37,
    63-71): ``label % 3 == {0: base, 1: val, 2: novel}``.  (The %2/%4
    grouping belongs to the CUB filelist writer, not cifar.)

    Labels are compacted to 0..len(group)-1 — equivalent to the reference's
    episodic path (its SetDataset builds sub-loaders only for the kept
    classes, :69-71).  Deviation note: the reference's BASELINE pretrain
    keeps raw label values into a 100-way classifier with 66 dead outputs
    (train.py:89-93, num_classes=100); here the classifier sees the
    compacted indices — a class-index permutation, and the classifier is
    discarded at eval either way."""
    path = os.path.join(root, "train")
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    images = d["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC uint8
    labels = np.asarray(d["fine_labels"], np.int64)
    type_ = {"base": 0, "val": 1, "novel": 2}[split]
    groups = [c for c in range(100) if c % 3 == type_]
    keep = np.isin(labels, groups)
    remap = {c: i for i, c in enumerate(groups)}
    labels = np.asarray([remap[int(l)] for l in labels[keep]], np.int64)
    return Manifest(list(images[keep]), labels, len(groups))


def synthetic(n_classes: int = 10, per_class: int = 48, base_size: int = 64, seed: int = 0, tint: float = 0.55) -> Manifest:
    """In-memory synthetic dataset (class-tinted noise) for tests/benchmarks.
    Deterministic per (seed, class, index).  ``tint`` sets class
    separability: 0.55 is near-trivially separable; ~0.2 calibrates eval
    accuracy to a non-vacuous ~80-95% so accuracy regressions are visible."""
    rs = np.random.RandomState(seed)
    tints = rs.rand(n_classes, 1, 1, 3).astype(np.float32)
    items, labels = [], []
    for c in range(n_classes):
        noise = rs.rand(per_class, base_size, base_size, 3).astype(np.float32)
        imgs = np.clip(tint * tints[c] + (1.0 - tint) * noise, 0.0, 1.0)
        items.extend(list(imgs))
        labels.extend([c] * per_class)
    return Manifest(items, np.asarray(labels, np.int64), n_classes)
