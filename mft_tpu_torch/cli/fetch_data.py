"""Dataset acquisition + staging driver of the port (its own copy of
``mft_tpu/cli/fetch_data.py``, host-only code that calls the port's
``data/filelists.py``) — the reference's download/prep shell tooling rebuilt
as one testable CLI (SURVEY.md §2.6, L0).

The reference ships per-dataset wget/tar wrappers and points at kaggle for
the rest:

* filelists/CUB/download_CUB.sh:1-3 (CUB tgz -> tar -zx -> filelist writer)
* filelists/miniImagenet/download_miniImagenet.sh:1-3 (ImageNet tarball)
* filelists/miniImagenet/configure_miniImagenet.sh:1-6 (Ravi split CSVs ->
  miniImagenet + cross filelist writers)
* README.md:44-68 (EuroSAT/ISIC/CropDisease/ChestX URLs + kaggle slugs)
* README.md:86 (downsampled miniImagenet3.zip used by the study)
* README.md:107 (pre-trained logs.zip)

Here each dataset is a declarative ``Recipe`` of steps (download | kaggle |
unpack | filelists | note) that stage the exact on-disk layout
``data/registry.py`` consumes, plus a ``--verify`` pass that checks the
staged tree against those expectations.  Network fetches are isolated in
one function with a clear no-egress error; ``--archive NAME=PATH`` feeds a
locally-obtained archive through the identical unpack/post pipeline, which
is how the offline tests exercise everything but the socket.

Examples:
  python -m mft_tpu_torch.cli.fetch_data --plan                       # all steps
  python -m mft_tpu_torch.cli.fetch_data --dataset EuroSAT --run      # wget+unzip
  python -m mft_tpu_torch.cli.fetch_data --dataset CUB --run \
      --archive CUB=/tmp/CUB_200_2011.tgz                       # no network
  python -m mft_tpu_torch.cli.fetch_data --verify                     # check tree
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import tarfile
import zipfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from mft_tpu_torch.data import filelists


@dataclass(frozen=True)
class Step:
    kind: str  # download | kaggle | unpack | filelists | note
    # download: (url, dest_rel)       kaggle: (slug, dest_rel)
    # unpack:   (archive_rel, dest_rel)
    # filelists:(mode, kwargs)        note: (text,)
    args: Tuple


@dataclass(frozen=True)
class Recipe:
    name: str
    steps: Tuple[Step, ...]
    # staged paths (relative to --dest) whose existence --verify checks;
    # mirrors what data/registry.py resolves for this dataset.
    expect: Tuple[str, ...]


def _dl(url: str, dest: str) -> Step:
    return Step("download", (url, dest))


def _kg(slug: str, dest: str) -> Step:
    return Step("kaggle", (slug, dest))


def _un(archive: str, dest: str) -> Step:
    return Step("unpack", (archive, dest))


def _fl(mode: str, **kw) -> Step:
    return Step("filelists", (mode, kw))


def _note(text: str) -> Step:
    return Step("note", (text,))


# Archive filenames are keyed per recipe so --archive NAME=PATH can replace
# the download while the unpack/post steps run unchanged.
RECIPES: Dict[str, Recipe] = {
    "miniImagenet": Recipe(
        "miniImagenet",
        (
            # README.md:86 — the downsampled images actually used upstream.
            _dl("https://www.dropbox.com/s/sbttsmb1cca0y0k/miniImagenet3.zip?dl=1", "miniImagenet3.zip"),
            _un("miniImagenet3.zip", "content"),
        ),
        ("content/miniImagenet3",),
    ),
    "miniImagenet_csv": Recipe(
        # configure_miniImagenet.sh:1-6 — Ravi split CSVs + filelist writers.
        "miniImagenet_csv",
        (
            _dl("https://raw.githubusercontent.com/twitter/meta-learning-lstm/master/data/miniImagenet/train.csv", "ravi/train.csv"),
            _dl("https://raw.githubusercontent.com/twitter/meta-learning-lstm/master/data/miniImagenet/val.csv", "ravi/val.csv"),
            _dl("https://raw.githubusercontent.com/twitter/meta-learning-lstm/master/data/miniImagenet/test.csv", "ravi/test.csv"),
            _fl("csv_split", data_root="content/miniImagenet3", out_dir="filelists/miniImagenet", csv_dir="ravi"),
        ),
        ("filelists/miniImagenet/base.json", "filelists/miniImagenet/val.json", "filelists/miniImagenet/novel.json"),
    ),
    "CUB": Recipe(
        # download_CUB.sh:1-3 (the wget line is commented upstream too — the
        # caltech host requires a browser session; archive is user-supplied).
        "CUB",
        (
            _note("CUB_200_2011.tgz must be obtained from the Caltech vision site (download_CUB.sh's wget is commented upstream); pass --archive CUB=PATH"),
            _un("CUB_200_2011.tgz", "."),
            _fl("index_split", data_root="CUB_200_2011/images", out_dir="filelists/CUB"),
        ),
        ("filelists/CUB/base.json", "filelists/CUB/val.json", "filelists/CUB/novel.json"),
    ),
    "cross": Recipe(
        # write_cross_filelist.py via configure_miniImagenet.sh:6.
        "cross",
        (_fl("cross", mini_root="content/miniImagenet3", cub_root="CUB_200_2011/images", out_dir="filelists/cross"),),
        ("filelists/cross/base.json", "filelists/cross/val.json", "filelists/cross/novel.json"),
    ),
    "EuroSAT": Recipe(
        "EuroSAT",
        (_dl("http://madm.dfki.de/files/sentinel/EuroSAT.zip", "EuroSAT.zip"), _un("EuroSAT.zip", "content")),
        ("content/2750",),
    ),
    "ISIC": Recipe(
        "ISIC",
        (
            _note("ISIC2018 task-3 data is login-gated (README.md:54); download ISIC2018_Task3_Training_Input.zip and ISIC2018_Task3_Training_GroundTruth.zip then pass --archive ISIC_input=... --archive ISIC_gt=..."),
            _un("ISIC2018_Task3_Training_Input.zip", "content"),
            _un("ISIC2018_Task3_Training_GroundTruth.zip", "content"),
        ),
        (
            "content/ISIC2018_Task3_Training_GroundTruth/ISIC2018_Task3_Training_GroundTruth.csv",
            "content/ISIC2018_Task3_Training_Input",
        ),
    ),
    "CropDisease": Recipe(
        "CropDisease",
        (_kg("plant-disease/data", "kaggle/CropDisease"), _un("kaggle/CropDisease/data.zip", "content/CropDiseases")),
        ("content/CropDiseases/dataset/train",),
    ),
    "ChestX": Recipe(
        "ChestX",
        (
            _kg("nih-chest-xrays/data", "kaggle/ChestX"),
            _un("kaggle/ChestX/data.zip", "content"),
            _note("NIH ships images in images_001..012 shards; consolidate them under content/images (registry expects Data_Entry_2017.csv + images/)"),
        ),
        ("content/Data_Entry_2017.csv", "content/images"),
    ),
    "pretrained": Recipe(
        # README.md:107 — the study's released checkpoints.
        "pretrained",
        (_dl("https://www.dropbox.com/s/drzg0ptexfjrv7f/logs.zip?dl=1", "logs.zip"), _un("logs.zip", ".")),
        ("logs",),
    ),
}

# Paths-field -> staged location (relative to --dest), for --emit_paths:
# writes an mft_paths.json so config.Paths.load picks the staged tree up
# without hand-editing (reference configs.py:1-9 equivalents).
PATHS_MAP = {
    "miniImageNet": "content/miniImagenet3",
    "EuroSAT": "content/2750",
    "ISIC": "content",
    "ChestX": "content",
    "CropDisease": "content/CropDiseases",
    "CUB": "filelists/CUB",
    "cross": "filelists/cross",
    "save_dir": "logs",
}

# --archive keys that feed multi-archive recipes map onto these filenames.
ARCHIVE_KEYS = {
    "CUB": "CUB_200_2011.tgz",
    "miniImagenet": "miniImagenet3.zip",
    "EuroSAT": "EuroSAT.zip",
    "ISIC_input": "ISIC2018_Task3_Training_Input.zip",
    "ISIC_gt": "ISIC2018_Task3_Training_GroundTruth.zip",
    "CropDisease": "kaggle/CropDisease/data.zip",
    "ChestX": "kaggle/ChestX/data.zip",
    "pretrained": "logs.zip",
}


def download(url: str, dest: str) -> None:
    """One urllib fetch; converts socket failures into an actionable error
    (a host without egress gets told to pass ``--archive``)."""
    import urllib.error
    import urllib.request

    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
    except (urllib.error.URLError, OSError) as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"download of {url} failed ({e}). If this host has no network "
            f"egress, obtain the file elsewhere and pass --archive NAME=PATH."
        ) from e
    os.replace(tmp, dest)
    print(f"downloaded {url} -> {dest}")


def kaggle_download(slug: str, dest_dir: str) -> None:
    """``kaggle datasets download -d SLUG`` (README.md:62,68)."""
    if shutil.which("kaggle") is None:
        raise RuntimeError(
            f"kaggle CLI not on PATH; run `kaggle datasets download -d {slug}` "
            f"on a networked machine and pass --archive NAME=PATH."
        )
    os.makedirs(dest_dir, exist_ok=True)
    subprocess.run(["kaggle", "datasets", "download", "-d", slug, "-p", dest_dir], check=True)


def _safe_members(names, dest: str):
    """Refuse archive members that would escape dest (path traversal)."""
    base = os.path.realpath(dest)
    for n in names:
        target = os.path.realpath(os.path.join(dest, n))
        if target != base and not target.startswith(base + os.sep):
            raise RuntimeError(f"archive member escapes destination: {n!r}")


def unpack(archive: str, dest: str) -> None:
    os.makedirs(dest, exist_ok=True)
    if tarfile.is_tarfile(archive):
        with tarfile.open(archive) as t:
            names = t.getnames()
            _safe_members(names, dest)
            for m in t.getmembers():
                if m.issym() or m.islnk():
                    raise RuntimeError(f"refusing archive link member: {m.name!r}")
            t.extractall(dest, filter="data")
    elif zipfile.is_zipfile(archive):
        with zipfile.ZipFile(archive) as z:
            _safe_members(z.namelist(), dest)
            z.extractall(dest)
    else:
        raise RuntimeError(f"{archive}: not a tar or zip archive")
    print(f"unpacked {archive} -> {dest}")


def run_filelists(mode: str, kw: dict, dest: str) -> None:
    j = lambda p: os.path.join(dest, p)  # noqa: E731
    if mode == "index_split":
        filelists.write_index_split_filelists(j(kw["data_root"]), j(kw["out_dir"]))
    elif mode == "csv_split":
        filelists.write_csv_split_filelists(j(kw["data_root"]), j(kw["out_dir"]), j(kw["csv_dir"]))
    elif mode == "cross":
        filelists.write_cross_filelists(j(kw["mini_root"]), j(kw["cub_root"]), j(kw["out_dir"]))
    else:  # pragma: no cover - registry is static
        raise ValueError(mode)


def run_recipe(recipe: Recipe, dest: str, archives: Dict[str, str]) -> None:
    for step in recipe.steps:
        if step.kind == "download":
            url, rel = step.args
            out = os.path.join(dest, rel)
            if os.path.exists(out):
                print(f"have {out}, skipping download")
            else:
                key = next((k for k, v in ARCHIVE_KEYS.items() if v == rel), None)
                if key and key in archives:
                    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
                    shutil.copyfile(archives[key], out)
                    print(f"staged --archive {key} -> {out}")
                else:
                    download(url, out)
        elif step.kind == "kaggle":
            slug, rel = step.args
            key = next((k for k, v in ARCHIVE_KEYS.items() if v.startswith(rel)), None)
            if key and key in archives:
                out = os.path.join(dest, ARCHIVE_KEYS[key])
                os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
                shutil.copyfile(archives[key], out)
                print(f"staged --archive {key} -> {out}")
            else:
                kaggle_download(slug, os.path.join(dest, rel))
        elif step.kind == "unpack":
            rel, out_rel = step.args
            key = next((k for k, v in ARCHIVE_KEYS.items() if v == rel), None)
            src = os.path.join(dest, rel)
            if not os.path.exists(src) and key and key in archives:
                src = archives[key]
            unpack(src, os.path.join(dest, out_rel))
        elif step.kind == "filelists":
            mode, kw = step.args
            run_filelists(mode, kw, dest)
        elif step.kind == "note":
            print(f"NOTE [{recipe.name}]: {step.args[0]}")


def verify(recipe: Recipe, dest: str) -> List[str]:
    return [p for p in recipe.expect if not os.path.exists(os.path.join(dest, p))]


def plan(recipe: Recipe) -> List[str]:
    out = [f"{recipe.name}:"]
    for s in recipe.steps:
        if s.kind == "download":
            out.append(f"  download {s.args[0]} -> {s.args[1]}")
        elif s.kind == "kaggle":
            out.append(f"  kaggle datasets download -d {s.args[0]} -p {s.args[1]}")
        elif s.kind == "unpack":
            out.append(f"  unpack {s.args[0]} -> {s.args[1]}")
        elif s.kind == "filelists":
            out.append(f"  filelists --mode {s.args[0]} {s.args[1]}")
        else:
            out.append(f"  NOTE: {s.args[0]}")
    out.append("  expect: " + ", ".join(recipe.expect))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="download/stage datasets (reference filelists/ shell tooling)")
    p.add_argument("--dataset", default="all", help="recipe name or 'all'")
    p.add_argument("--dest", default=".", help="staging root (paths in the recipes are relative to this)")
    p.add_argument("--plan", action="store_true", help="print steps, do nothing")
    p.add_argument("--run", action="store_true", help="execute the recipe steps")
    p.add_argument("--verify", action="store_true", help="check the staged tree against registry expectations")
    p.add_argument("--archive", action="append", default=[], metavar="NAME=PATH",
                   help=f"locally-obtained archive replacing a download; names: {', '.join(ARCHIVE_KEYS)}")
    p.add_argument("--emit_paths", default=None, metavar="JSON",
                   help="write an mft_paths.json mapping every dataset root to the staged "
                        "location under --dest (config.Paths.load / MFT_TPU_PATHS consume it)")
    a = p.parse_args(argv)
    names = list(RECIPES) if a.dataset == "all" else [a.dataset]
    for n in names:
        if n not in RECIPES:
            p.error(f"unknown dataset {n!r}; choose from {', '.join(RECIPES)} or 'all'")
    archives = {}
    for spec in a.archive:
        k, _, v = spec.partition("=")
        if k not in ARCHIVE_KEYS or not v:
            p.error(f"--archive must be NAME=PATH with NAME in {', '.join(ARCHIVE_KEYS)}")
        archives[k] = v
    rc = 0
    for n in names:
        r = RECIPES[n]
        if a.plan or not (a.run or a.verify):
            print("\n".join(plan(r)))
        if a.run:
            try:
                run_recipe(r, a.dest, archives)
            except RuntimeError as e:
                print(f"FETCH {n}: {e}", file=sys.stderr)
                rc = 1
                continue
        if a.verify:
            missing = verify(r, a.dest)
            if missing:
                print(f"VERIFY {n}: MISSING " + ", ".join(missing))
                rc = 1
            else:
                print(f"VERIFY {n}: ok")
    if a.emit_paths:
        import json

        dest = os.path.abspath(a.dest)
        blob = {k: os.path.join(dest, rel) for k, rel in PATHS_MAP.items()}
        os.makedirs(os.path.dirname(os.path.abspath(a.emit_paths)) or ".", exist_ok=True)
        with open(a.emit_paths, "w") as f:
            json.dump(blob, f, indent=1)
        print(f"wrote {a.emit_paths} (point MFT_TPU_PATHS at it)")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
