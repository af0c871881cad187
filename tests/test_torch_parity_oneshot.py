"""The port's day-one real-data parity harness
(mft_tpu_torch/tools/parity_oneshot.py), the contracts of
tests/test_parity_oneshot.py on the port's drivers:

* the stage check names every missing dataset with its ``MFT_*_PATH``
  pointer and layout and exits 2; staged synthetic data exits 0;
* ``--import_ckpts`` lays a seeded reference ``.tar`` tree (the reference's
  upper-case ``miniImagenet`` directory) out in the port's checkpoint
  directories with a fresh Adam state, and reports a missing 50-shot tree;
* ``--smoke`` with the drivers' depths patched to the minimum trains the
  three stages on the CPU, renames 0.tar -> 400.tar and 1.tar -> 600.tar,
  and writes ``parity_report.json`` with the fast and the strict cell;
* the published targets, and ``--device cuda`` refusing to run without a
  card.
"""

import json
import os

import pytest
import torch

from mft_tpu_torch import config as cfg_mod
from mft_tpu_torch import convert
from mft_tpu_torch.cli import finetune
from mft_tpu_torch.methods import gnnnet as gn
from mft_tpu_torch.methods.baseline import init_classifier
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.tools import parity_oneshot
from mft_tpu_torch.utils import checkpoint as ckpt

DATASETS = ("MINIIMAGENET", "CROPDISEASE", "EUROSAT", "ISIC", "CHESTX")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_status_missing_datasets_exits_2(tmp_path, monkeypatch, capsys):
    for name in DATASETS:
        monkeypatch.setenv(f"MFT_{name}_PATH", str(tmp_path / name.lower()))
    assert parity_oneshot.main(["--status"]) == 2
    out = capsys.readouterr().out
    for name in ("miniImageNet", "CropDisease", "EuroSAT", "ISIC", "ChestX"):
        assert f"[MISSING] {name}" in out
    for name in DATASETS:
        assert f"MFT_{name}_PATH" in out
    assert out.count("expected layout") == 5


def test_status_synthetic_staged_exits_0(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MFT_SAVE_DIR_PATH", str(tmp_path / "logs"))
    assert parity_oneshot.main(["--status", "--smoke"]) == 0
    assert "[staged] synthetic" in capsys.readouterr().out


def _reference_tree(ref, need50: bool):
    """A reference save_dir of seeded ``.tar`` files (``{'epoch', 'state'}``)
    at narrow widths, under the reference's ``miniImagenet`` casing."""
    cfg = bb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, 16))
    g = torch.Generator().manual_seed(0)
    feature, stats = bb.init_backbone(g, cfg)
    head = gn.init_head(g, gn.GnnNetCfg(feat_dim=16, n_way=5, n_support=5))
    root = ref / "checkpoints" / "miniImagenet"
    files = {"ResNet10_baseline_aug": ({"feature": feature, "classifier": init_classifier(g, 16, 64)}, (400,)),
             "ResNet10_gnnnet_aug_5way_5shot": ({"feature": feature, **head}, (400, 600))}
    if need50:
        files["ResNet10_gnnnet_aug_5way_50shot"] = ({"feature": feature, **head}, (600,))
    for name, (params, epochs) in files.items():
        (root / name).mkdir(parents=True)
        for e in epochs:
            convert.save_tar(str(root / name / f"{e}.tar"), e, convert.to_state_dict(params, stats))
    return cfg


def test_import_reference_ckpts_lays_out_the_port_dirs(tmp_path, monkeypatch, capsys):
    ref = tmp_path / "ref_logs"
    cfg = _reference_tree(ref, need50=False)
    monkeypatch.setenv("MFT_SAVE_DIR_PATH", str(tmp_path / "logs"))
    paths = cfg_mod.Paths.load()
    assert parity_oneshot._import_reference_ckpts(str(ref), paths, "miniImageNet", need50=False)
    out_b = cfg_mod.checkpoint_dir(paths, "miniImageNet", "ResNet10", "baseline", train_aug=True)
    out_g = cfg_mod.checkpoint_dir(paths, "miniImageNet", "ResNet10", "gnnnet", train_aug=True, n_way=5, n_shot=5)
    assert sorted(os.listdir(out_b)) == ["400.tar"]
    assert sorted(os.listdir(out_g)) == ["400.tar", "600.tar"]
    # the port's own files: the reference's tensors, a fresh Adam state beside them
    epoch, sd, adam, _ = ckpt.read_checkpoint(os.path.join(out_g, "600.tar"))
    _, want = convert.load_tar(str(ref / "checkpoints" / "miniImagenet" / "ResNet10_gnnnet_aug_5way_5shot"
                                   / "600.tar"))
    assert epoch == 600 and sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in want)
    assert adam is not None
    epoch, params, _, opt_state = ckpt.load_checkpoint(os.path.join(out_g, "600.tar"), cfg,
                                                       parity_oneshot_adam_template(cfg))
    assert epoch == 600 and "gnn" in params and int(opt_state["t"]) == 0
    # a missing 50-shot tree is reported, not skipped
    assert not parity_oneshot._import_reference_ckpts(str(ref), paths, "miniImageNet", need50=True)
    assert "MISSING" in capsys.readouterr().out
    # no miniImagenet directory at all
    assert not parity_oneshot._import_reference_ckpts(str(tmp_path / "nowhere"), paths, "miniImageNet", need50=False)


def parity_oneshot_adam_template(cfg):
    from mft_tpu_torch.train import optimizers as opt

    g = torch.Generator().manual_seed(0)
    feature, _ = bb.init_backbone(g, cfg)
    params = {"feature": feature, **gn.init_head(g, gn.GnnNetCfg(feat_dim=16, n_way=5, n_support=5))}
    return opt.torch_adam(1e-3).init(params)


def test_smoke_writes_the_fast_and_strict_cells(tmp_path, monkeypatch, capsys):
    """The whole flow on synthetic data at the least depth: two baseline
    steps of 240 images an epoch, one episode an epoch of the episodic and
    fine-tune stages, one eval batch of two episodes with one augmented
    replica, one inner epoch of the GNN member and of the linear member, in
    both cells."""
    real_tcfg = finetune._transfer_cfg
    monkeypatch.setattr(finetune, "_transfer_cfg", lambda a: real_tcfg(a)._replace(linear_epochs=1))
    monkeypatch.setenv("MFT_SAVE_DIR_PATH", str(tmp_path / "logs"))
    monkeypatch.setattr(parity_oneshot, "TINY_TRAIN", ["--stop_epoch", "1", "--episodes_per_epoch", "1",
                                                       "--save_freq", "1", "--batch_size", "240", "--n_query", "2"])
    monkeypatch.setattr(parity_oneshot, "TINY_FINETUNE", ["--start_epoch", "1", "--stop_epoch", "2",
                                                          "--episodes_per_epoch", "1", "--save_freq", "1",
                                                          "--n_query", "2"])
    monkeypatch.setattr(parity_oneshot, "TINY_EVAL", ["--eval_batch", "2", "--gen_examples", "1",
                                                      "--fine_tune_epoch", "1", "--n_query", "3"])
    monkeypatch.setattr(parity_oneshot, "TINY_ITER_NUM", 2)
    assert parity_oneshot.main(["--smoke", "--device", "cpu"]) == 0
    paths = cfg_mod.Paths.load()
    bdir = cfg_mod.checkpoint_dir(paths, "synthetic", "ResNet10", "baseline", train_aug=True)
    gdir = cfg_mod.checkpoint_dir(paths, "synthetic", "ResNet10", "gnnnet", train_aug=True, n_way=5, n_shot=5)
    assert {"0.tar", "1.tar", "400.tar"} <= set(os.listdir(bdir))
    assert {"0.tar", "1.tar", "2.tar", "600.tar"} <= set(os.listdir(gdir))
    with open(os.path.join(str(tmp_path / "logs"), "parity_report.json")) as f:
        report = json.load(f)
    cell = report["results"]["synthetic/5shot"]
    assert set(cell) == {"acc", "ci95", "wall_s", "acc_strict", "ci95_strict", "wall_s_strict"}
    assert all(0.0 <= cell[k] <= 100.0 for k in ("acc", "acc_strict"))
    assert report["device"] == "cpu" and report["tolerance_pp"] == parity_oneshot.TOLERANCE_PP
    assert report["published"] == {"CropDisease/5shot": [98.78, 0.19]}
    out = capsys.readouterr().out
    assert "strict parity" in out and "[info]" in out


def test_cuda_is_refused_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is of a host without one")
    monkeypatch.setenv("MFT_SAVE_DIR_PATH", str(tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        parity_oneshot.main(["--smoke"])


def test_published_targets():
    assert parity_oneshot.PUBLISHED[("CropDisease", 5)] == (98.78, 0.19)
    assert parity_oneshot.PUBLISHED_AVERAGE == 73.78
    assert parity_oneshot.TOLERANCE_PP == 0.3
