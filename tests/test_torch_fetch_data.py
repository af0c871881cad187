"""The port's dataset acquisition driver (``mft_tpu_torch/cli/fetch_data.py``),
case by case as ``tests/test_fetch_data.py`` holds the JAX one: everything
but the socket (archive staging, traversal-safe unpack, filelist chaining,
verify, the no-egress error), offline.  Each staged tree and filelist is
held byte for byte against the JAX driver's on the same archives, and the
two drivers' recipes, plans and paths maps are the same.  Tolerance: none."""

import dataclasses
import io
import os
import tarfile
import zipfile

import numpy as np
import pytest
from PIL import Image

from mft_tpu.cli import fetch_data as jfetch
from mft_tpu_torch.cli import fetch_data


def _img_bytes():
    buf = io.BytesIO()
    Image.fromarray((np.zeros((4, 4, 3))).astype(np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def _make_cub_tgz(path, n_classes=8, per_class=2):
    data = _img_bytes()
    with tarfile.open(path, "w:gz") as t:
        for c in range(n_classes):
            for i in range(per_class):
                info = tarfile.TarInfo(f"CUB_200_2011/images/{c:03d}.cls/{i}.jpg")
                info.size = len(data)
                t.addfile(info, io.BytesIO(data))


def _files(root):
    """Every file under ``root`` and its bytes, with paths relative to it."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _both(argv_of, tmp_path):
    """Run both drivers, each into its own --dest; return their exit codes
    and staged trees.  Filelists name absolute paths, so the JAX tree's
    paths are rewritten to the port's --dest before comparing."""
    res = {}
    for name, tool in (("port", fetch_data), ("jax", jfetch)):
        dest = tmp_path / name
        rc = tool.main(argv_of(str(dest)))
        res[name] = (rc, {k: v.replace(str(dest).encode(), b"<dest>") for k, v in _files(str(dest)).items()})
    return res["port"], res["jax"]


def test_cub_archive_to_filelists(tmp_path):
    """download_CUB.sh:1-3 equivalent: tgz -> unpack -> index-split filelists."""
    tgz = tmp_path / "CUB_200_2011.tgz"
    _make_cub_tgz(str(tgz))
    port, jax_side = _both(lambda dest: ["--dataset", "CUB", "--run", "--verify", "--archive", f"CUB={tgz}",
                                         "--dest", dest], tmp_path)
    assert port[0] == jax_side[0] == 0
    for split in ("base", "val", "novel"):
        assert f"filelists/CUB/{split}.json" in port[1]
    assert port[1] == jax_side[1]


def test_eurosat_zip_and_verify(tmp_path):
    zp = tmp_path / "EuroSAT.zip"
    with zipfile.ZipFile(zp, "w") as z:
        z.writestr("2750/Forest/Forest_1.jpg", _img_bytes())
    port, jax_side = _both(lambda dest: ["--dataset", "EuroSAT", "--run", "--verify", "--archive", f"EuroSAT={zp}",
                                         "--dest", dest], tmp_path)
    assert port[0] == jax_side[0] == 0
    assert "content/2750/Forest/Forest_1.jpg" in port[1] and port[1] == jax_side[1]


def test_verify_reports_missing(tmp_path, capsys):
    rc = fetch_data.main(["--dataset", "EuroSAT", "--verify", "--dest", str(tmp_path)])
    assert rc == 1
    assert "MISSING" in capsys.readouterr().out


def test_tar_traversal_refused(tmp_path):
    tgz = tmp_path / "evil.tgz"
    with tarfile.open(tgz, "w:gz") as t:
        info = tarfile.TarInfo("../evil.txt")
        info.size = 1
        t.addfile(info, io.BytesIO(b"x"))
    with pytest.raises(RuntimeError, match="escapes"):
        fetch_data.unpack(str(tgz), str(tmp_path / "out"))
    assert not (tmp_path / "evil.txt").exists()


def test_zip_traversal_refused(tmp_path):
    zp = tmp_path / "evil.zip"
    with zipfile.ZipFile(zp, "w") as z:
        z.writestr("../evil.txt", b"x")
    with pytest.raises(RuntimeError, match="escapes"):
        fetch_data.unpack(str(zp), str(tmp_path / "out"))
    assert not (tmp_path / "evil.txt").exists()


def test_tar_link_member_refused(tmp_path):
    tgz = tmp_path / "link.tgz"
    with tarfile.open(tgz, "w:gz") as t:
        info = tarfile.TarInfo("sym")
        info.type = tarfile.SYMTYPE
        info.linkname = "/etc/passwd"
        t.addfile(info)
    with pytest.raises(RuntimeError, match="link member"):
        fetch_data.unpack(str(tgz), str(tmp_path / "out"))


def test_download_failure_is_actionable(tmp_path, monkeypatch):
    import urllib.error
    import urllib.request

    def boom(url, timeout=None):
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(urllib.request, "urlopen", boom)
    with pytest.raises(RuntimeError, match="--archive"):
        fetch_data.download("http://example.com/x.zip", str(tmp_path / "x.zip"))
    assert not (tmp_path / "x.zip.part").exists()


def test_kaggle_missing_cli_is_actionable(monkeypatch, tmp_path):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="kaggle datasets download"):
        fetch_data.kaggle_download("plant-disease/data", str(tmp_path / "nowhere"))


def test_plan_all_covers_every_recipe(capsys):
    rc = fetch_data.main(["--plan"])
    out = capsys.readouterr().out
    assert rc == 0
    for name in fetch_data.RECIPES:
        assert f"{name}:" in out
    for ds in ("miniImagenet", "CUB", "cross", "EuroSAT", "ISIC", "CropDisease", "ChestX"):
        assert ds in out
    assert jfetch.main(["--plan"]) == 0
    assert capsys.readouterr().out == out  # the JAX driver's plan, line for line


def test_recipes_and_maps_equal_the_jax_drivers():
    as_tuples = lambda recipes: {k: dataclasses.astuple(r) for k, r in recipes.items()}  # noqa: E731
    assert as_tuples(fetch_data.RECIPES) == as_tuples(jfetch.RECIPES)
    assert fetch_data.PATHS_MAP == jfetch.PATHS_MAP and fetch_data.ARCHIVE_KEYS == jfetch.ARCHIVE_KEYS


def test_emit_paths_roundtrip(tmp_path, monkeypatch):
    """--emit_paths output loads through the port's config.Paths (MFT_TPU_PATHS)."""
    out = tmp_path / "mft_paths.json"
    rc = fetch_data.main(["--dataset", "EuroSAT", "--plan", "--dest", str(tmp_path), "--emit_paths", str(out)])
    assert rc == 0 and out.exists()
    monkeypatch.setenv("MFT_TPU_PATHS", str(out))
    for k in ("MFT_EUROSAT_PATH", "MFT_CROPDISEASE_PATH", "MFT_MINIIMAGENET_PATH"):
        monkeypatch.delenv(k, raising=False)
    from mft_tpu_torch.config import Paths

    p = Paths.load()
    assert p.EuroSAT == str(tmp_path / "content" / "2750")
    assert p.CropDisease == str(tmp_path / "content" / "CropDiseases")


def test_mini_csv_chain(tmp_path):
    """configure_miniImagenet.sh:1-6 equivalent with pre-staged CSVs."""
    def stage(dest):
        img_root = os.path.join(dest, "content", "miniImagenet3")
        for c in ("n01", "n02", "n03"):
            os.makedirs(os.path.join(img_root, c))
            for i in range(2):
                with open(os.path.join(img_root, c, f"{i}.jpg"), "wb") as f:
                    f.write(_img_bytes())
        os.makedirs(os.path.join(dest, "ravi"))
        for split, c in (("train", "n01"), ("val", "n02"), ("test", "n03")):
            with open(os.path.join(dest, "ravi", f"{split}.csv"), "w") as f:
                f.write(f"filename,label\n0.jpg,{c}\n1.jpg,{c}\n")
        return ["--dataset", "miniImagenet_csv", "--run", "--verify", "--dest", dest]

    port, jax_side = _both(stage, tmp_path)
    assert port[0] == jax_side[0] == 0 and port[1] == jax_side[1]
    assert "filelists/miniImagenet/novel.json" in port[1]
