"""Offline filelist writers of the port (its own copy of
``mft_tpu/data/filelists.py``; the image extensions are the port's
``data/manifests.py`` ``IMG_EXTS``) — capability parity with the reference
``filelists/`` tooling (SURVEY.md §2.6).

The reference ships per-dataset scripts that walk a downloaded image tree
and emit ``base/val/novel.json`` manifests of the form
``{"label_names", "image_names", "image_labels"}``:

* miniImagenet: the Ravi split CSVs select images per class per split
  (filelists/miniImagenet/write_miniImagenet_filelist.py:24-69),
* CUB: all 200 classes split by class index — base = i % 2 == 0,
  val = i % 4 == 1, novel = i % 4 == 3
  (filelists/CUB/write_CUB_filelist.py),
* cross: base = ALL miniImageNet classes, val/novel from CUB
  (filelists/miniImagenet/write_cross_filelist.py).

Here one parameterized writer covers the class-index-split pattern, plus a
CSV-driven splitter for Ravi-style miniImageNet splits.  Downloading is
``cli/fetch_data.py``'s.

CLI: ``python -m mft_tpu_torch.cli.make_filelists --data_root DIR --out DIR
[--mode index_split|csv_split]``.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List

from mft_tpu_torch.data.manifests import IMG_EXTS


def _walk_classes(data_root: str) -> Dict[str, List[str]]:
    classes = {}
    for cname in sorted(os.listdir(data_root)):
        cdir = os.path.join(data_root, cname)
        if not os.path.isdir(cdir):
            continue
        files = []
        for dirpath, _, fnames in sorted(os.walk(cdir)):
            for f in sorted(fnames):
                if os.path.splitext(f)[1].lower() in IMG_EXTS:
                    files.append(os.path.join(dirpath, f))
        if files:
            classes[cname] = files
    return classes


def _write(out_path: str, label_names: List[str], image_names: List[str], image_labels: List[int]):
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"label_names": label_names, "image_names": image_names, "image_labels": image_labels}, f)
    print(f"{out_path} -OK")  # reference writer's completion print


def write_index_split_filelists(data_root: str, out_dir: str) -> None:
    """The CUB-style class-index split (write_CUB_filelist.py):
    base = classes with index % 2 == 0, val = % 4 == 1, novel = % 4 == 3."""
    classes = _walk_classes(data_root)
    names = list(classes)
    splits = {
        "base": [i for i in range(len(names)) if i % 2 == 0],
        "val": [i for i in range(len(names)) if i % 4 == 1],
        "novel": [i for i in range(len(names)) if i % 4 == 3],
    }
    for split, idxs in splits.items():
        image_names, image_labels = [], []
        for i in idxs:
            image_names.extend(classes[names[i]])
            image_labels.extend([i] * len(classes[names[i]]))
        _write(os.path.join(out_dir, f"{split}.json"), names, image_names, image_labels)


def write_csv_split_filelists(data_root: str, out_dir: str, csv_dir: str) -> None:
    """Ravi-split miniImageNet writer (write_miniImagenet_filelist.py): each
    of train/val/test.csv lists (filename, class); they become
    base/val/novel.json.  Image paths resolve under ``data_root/<class>/``.
    """
    split_map = {"train": "base", "val": "val", "test": "novel"}
    label_names: List[str] = []
    for csv_name, split in split_map.items():
        path = os.path.join(csv_dir, f"{csv_name}.csv")
        per_class: Dict[str, List[str]] = {}
        with open(path) as f:
            reader = csv.reader(f)
            header = next(reader)
            for row in reader:
                if not row:
                    continue
                fname, cls = row[0], row[1]
                per_class.setdefault(cls, []).append(os.path.join(data_root, cls, fname))
        image_names, image_labels = [], []
        for cls in sorted(per_class):
            if cls not in label_names:
                label_names.append(cls)
            li = label_names.index(cls)
            image_names.extend(per_class[cls])
            image_labels.extend([li] * len(per_class[cls]))
        _write(os.path.join(out_dir, f"{split}.json"), list(label_names), image_names, image_labels)


def write_cross_filelists(mini_root: str, cub_root: str, out_dir: str) -> None:
    """Cross-domain split (write_cross_filelist.py): base.json = every
    miniImageNet class; val/novel from the CUB class-index split."""
    mini = _walk_classes(mini_root)
    names = list(mini)
    image_names, image_labels = [], []
    for i, c in enumerate(names):
        image_names.extend(mini[c])
        image_labels.extend([i] * len(mini[c]))
    _write(os.path.join(out_dir, "base.json"), names, image_names, image_labels)

    cub = _walk_classes(cub_root)
    cub_names = list(cub)
    for split, residue in (("val", 1), ("novel", 3)):
        image_names, image_labels = [], []
        for i in range(len(cub_names)):
            if i % 4 == residue:
                image_names.extend(cub[cub_names[i]])
                image_labels.extend([i] * len(cub[cub_names[i]]))
        _write(os.path.join(out_dir, f"{split}.json"), cub_names, image_names, image_labels)
