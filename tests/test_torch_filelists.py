"""The port's filelist writers (``mft_tpu_torch/data/filelists.py``,
``mft_tpu_torch/cli/make_filelists.py``), case by case as
``tests/test_filelists.py`` holds the JAX ones, and each JSON file
byte-identical to the JAX writer's on the same staged tree.  The written
lists are consumed by the port's registry, episode stream and an episodic
training step.  Tolerance: none (bytes and labels are exact)."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mft_tpu.cli import make_filelists as jmake
from mft_tpu.data import filelists as jfilelists
from mft_tpu_torch.cli import make_filelists
from mft_tpu_torch.data import filelists, manifests

SPLITS = ("base", "val", "novel")


def _tree(root, n_classes=8, per_class=3):
    rs = np.random.RandomState(0)
    for c in range(n_classes):
        d = os.path.join(root, f"cls{c:03d}")
        os.makedirs(d)
        for i in range(per_class):
            Image.fromarray((rs.rand(8, 8, 3) * 255).astype(np.uint8)).save(os.path.join(d, f"{i}.jpg"))
    # files the writers must skip: a non-image, a nested image, an upper-case extension
    open(os.path.join(root, "cls000", "notes.txt"), "w").close()
    os.makedirs(os.path.join(root, "cls001", "sub"))
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(os.path.join(root, "cls001", "sub", "x.PNG"))


def _same_bytes(port_out, jax_out, names=SPLITS):
    for split in names:
        with open(os.path.join(port_out, f"{split}.json"), "rb") as a, open(os.path.join(jax_out, f"{split}.json"),
                                                                           "rb") as b:
            assert a.read() == b.read(), split


def test_index_split_writer_and_roundtrip(tmp_path):
    data, out = tmp_path / "data", tmp_path / "out"
    os.makedirs(data)
    _tree(str(data))
    make_filelists.main(["--mode", "index_split", "--data_root", str(data), "--out", str(out)])
    jmake.main(["--mode", "index_split", "--data_root", str(data), "--out", str(tmp_path / "jax")])
    _same_bytes(str(out), str(tmp_path / "jax"))
    # CUB-style residues: base %2==0 -> {0,2,4,6}; val %4==1 -> {1,5}; novel %4==3 -> {3,7}
    base = json.load(open(out / "base.json"))
    assert sorted(set(base["image_labels"])) == [0, 2, 4, 6]
    assert sorted(set(json.load(open(out / "novel.json"))["image_labels"])) == [3, 7]
    m = manifests.json_filelist(str(out / "base.json"))
    assert m.n_classes == 4 and len(m) == 12
    assert len(json.load(open(out / "val.json"))["image_names"]) == 7  # cls001's nested x.PNG counts


def test_csv_split_writer(tmp_path):
    data, csvd, out = tmp_path / "data", tmp_path / "csv", tmp_path / "out"
    os.makedirs(data)
    os.makedirs(csvd)
    _tree(str(data), n_classes=4, per_class=2)
    for csv_name, classes in [("train", ["cls000", "cls001"]), ("val", ["cls002"]), ("test", ["cls003"])]:
        with open(csvd / f"{csv_name}.csv", "w") as f:
            f.write("filename,label\n")
            for c in classes:
                for i in range(2):
                    f.write(f"{i}.jpg,{c}\n")
    argv = ["--mode", "csv_split", "--data_root", str(data), "--csv_dir", str(csvd)]
    make_filelists.main(argv + ["--out", str(out)])
    jmake.main(argv + ["--out", str(tmp_path / "jax")])
    _same_bytes(str(out), str(tmp_path / "jax"))
    assert len(json.load(open(out / "base.json"))["image_names"]) == 4
    novel = json.load(open(out / "novel.json"))
    assert len(novel["image_names"]) == 2 and novel["label_names"] == ["cls000", "cls001", "cls002", "cls003"]


def test_cross_writer(tmp_path):
    mini, cub, out = tmp_path / "mini", tmp_path / "cub", tmp_path / "out"
    os.makedirs(mini)
    os.makedirs(cub)
    _tree(str(mini), n_classes=3, per_class=2)
    _tree(str(cub), n_classes=8, per_class=2)
    filelists.write_cross_filelists(str(mini), str(cub), str(out))
    jfilelists.write_cross_filelists(str(mini), str(cub), str(tmp_path / "jax"))
    _same_bytes(str(out), str(tmp_path / "jax"))
    assert sorted(set(json.load(open(out / "base.json"))["image_labels"])) == [0, 1, 2]  # ALL mini classes
    assert sorted(set(json.load(open(out / "val.json"))["image_labels"])) == [1, 5]


@pytest.mark.parametrize("mode, missing", [("csv_split", "--csv_dir"), ("cross", "--cub_root")])
def test_cli_requires_its_mode_flag(tmp_path, mode, missing, capsys):
    for tool in (make_filelists, jmake):
        with pytest.raises(SystemExit) as e:
            tool.main(["--mode", mode, "--data_root", str(tmp_path), "--out", str(tmp_path / "o")])
        assert e.value.code == 2 and missing in capsys.readouterr().err


def test_cub_filelists_consumed_end_to_end(tmp_path):
    """make_filelists -> the port's registry CUB entry -> EpisodeStream -> an
    episodic GnnNet step: the written lists are datasets, not just files."""
    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.data import registry
    from mft_tpu_torch.data.pipeline import EpisodeStream
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.models import backbone as bb
    from mft_tpu_torch.train import optimizers as opt
    from mft_tpu_torch.train import steps

    data, out = tmp_path / "cub_images", tmp_path / "filelists" / "CUB"
    os.makedirs(data)
    _tree(str(data), n_classes=8, per_class=6)
    make_filelists.main(["--mode", "index_split", "--data_root", str(data), "--out", str(out)])
    entry, paths = registry.get("CUB"), {"CUB": str(out)}
    base = registry.build_manifest(entry, paths, split="base")
    novel = registry.build_manifest(entry, paths, split="novel")
    assert base.n_classes == 4 and novel.n_classes == 2

    spec = EpisodeSpec(n_way=2, n_support=2, n_query=1)
    images, _ = next(iter(EpisodeStream(novel, spec, 2, base_size=16, seed=0)))
    assert images.shape == (2, 3, 16, 16, 3) and images.dtype == np.uint8

    bcfg = bb.ResNetCfg((1, 1), (8, 16))
    gcfg = gn.GnnNetCfg(feat_dim=16, n_way=2, n_support=2, proj_dim=8, gnn_nf=4)
    g = torch.Generator().manual_seed(0)
    feature, stats = bb.init_backbone(g, bcfg)
    params = {"feature": feature, **gn.init_head(g, gcfg)}
    tx = opt.torch_adam(1e-3)
    ep, _ = next(iter(EpisodeStream(base, spec, 1, base_size=16, seed=0)))
    x = torch.from_numpy(ep).float().div(255.0).permute(0, 1, 4, 2, 3)[None]  # [1, n_way, s+q, 3, H, W]
    out_step = steps.episodic_train_step(params, stats, tx.init(params), x, method="gnnnet", bcfg=bcfg, gcfg=gcfg,
                                         spec=spec, tx=tx)
    assert np.isfinite(float(out_step[-1]["loss"]))


def test_cross_filelists_consumed(tmp_path):
    """The cross entry: base = the miniImageNet classes, novel = a CUB subset."""
    from mft_tpu_torch.data import registry

    mini, cub, out = tmp_path / "mini", tmp_path / "cub", tmp_path / "filelists" / "cross"
    os.makedirs(mini)
    os.makedirs(cub)
    _tree(str(mini), n_classes=3, per_class=2)
    _tree(str(cub), n_classes=8, per_class=2)
    filelists.write_cross_filelists(str(mini), str(cub), str(out))
    paths, entry = {"cross": str(out)}, registry.get("cross")
    base = registry.build_manifest(entry, paths, split="base")
    novel = registry.build_manifest(entry, paths, split="novel")
    assert base.n_classes == 3 and novel.n_classes == 2
    assert len(registry.build_manifest(entry, paths)) == len(base)  # the default builder is the base split


def test_image_extensions_are_the_ports():
    """The writers read the port's IMG_EXTS (the same set as the JAX package's)."""
    from mft_tpu.data.manifests import IMG_EXTS as JAX_EXTS

    assert filelists.IMG_EXTS is manifests.IMG_EXTS and manifests.IMG_EXTS == JAX_EXTS
