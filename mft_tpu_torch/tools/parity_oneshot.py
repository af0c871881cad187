"""One-command real-data accuracy-parity run of the port against the
reference's published numbers (counterpart of ``tools/parity_oneshot.py``).

The standing goal is to reproduce the reference's CDFSL accuracies
(CropDisease 5-way 5-shot 98.78 % +- 0.19 over 600 episodes, the 73.78 %
average across all trials) the day the datasets are staged.  This tool
makes that run one command on the card:

    python -m mft_tpu_torch.tools.parity_oneshot                 # stage check + full run
    python -m mft_tpu_torch.tools.parity_oneshot --status        # stage check only
    python -m mft_tpu_torch.tools.parity_oneshot --skip_train    # eval existing checkpoints
    python -m mft_tpu_torch.tools.parity_oneshot --import_ckpts <ref_save_dir>
                                                                 # eval checkpoints already
                                                                 # TRAINED WITH THE REFERENCE
    python -m mft_tpu_torch.tools.parity_oneshot --smoke         # end-to-end on synthetic
    python -m mft_tpu_torch.tools.parity_oneshot --smoke_disk    # end-to-end on tiny staged
                                                                 # JPEG trees at REAL paths

It (1) checks that every dataset is staged (printing the ``MFT_*_PATH`` env
var / mft_paths.json key and the expected layout of each one that is not),
(2) runs the reference's training schedule through the port's drivers
(``mft_tpu_torch.cli.train`` / ``train_50``: baseline epochs 0-400, episodic
GnnNet 0-400, meta fine-tune 401-600), (3) runs the headline ``--method
all`` evals (``cli.finetune`` / ``finetune_50``, with the episode cache) and
(4) prints the comparison against the published numbers and writes
``parity_report.json`` into the save dir.  ``--device`` (default ``cuda``,
which raises without a card) goes to every driver.

Gated cells run twice: the gate is judged on the strict flags
(``--bn_mode minibatch --dtype float32 --inner_param_dtype float32``), with
the fast path (the port's main path: ``--use_pallas --inner_scan fused``,
bf16, episode BN) reported beside them, so that a failed gate points at
semantics or at the fast path's approximations.  Tolerance: +-0.3
points on CropDisease 5-shot; other cells are reported, not gated.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time

PUBLISHED = {
    # (test_dataset, n_shot) -> (mean, ci) from the reference README
    ("CropDisease", 5): (98.78, 0.19),
}
PUBLISHED_AVERAGE = 73.78  # across all 12 trials
TOLERANCE_PP = 0.3

#: expected on-disk layout per dataset
LAYOUT = {
    "miniImageNet": "miniImagenet3/ as unpacked from the reference's dropbox zip (train/val/test class dirs)",
    "CropDisease": "CropDiseases/train/<class>/*.jpg (kaggle plant-disease)",
    "EuroSAT": "2750/<class>/*.jpg",
    "ISIC": "ISIC2018_Task3_Training_{Input,GroundTruth}/ under the path",
    "ChestX": "Data_Entry_2017.csv + images/ under the path",
}

#: the rehearsals' depth (--smoke, --smoke_disk): epochs 0 and 1 of each
#: training stage, the fine-tune's epoch 2, TINY_ITER_NUM eval episodes
TINY_TRAIN = ["--stop_epoch", "1", "--episodes_per_epoch", "2", "--save_freq", "1"]
TINY_FINETUNE = ["--start_epoch", "1", "--stop_epoch", "2", "--episodes_per_epoch", "2", "--save_freq", "1"]
TINY_EVAL = ["--eval_batch", "2", "--gen_examples", "2", "--fine_tune_epoch", "1"]
TINY_ITER_NUM = 4
#: the fast cell: the port's main path (the edge kernel, the fused inner scan, bf16)
FAST = ["--use_pallas", "--inner_scan", "fused"]
#: the strict-parity flags the gate is judged on (the faithful BN mode runs the eager inner loop)
STRICT = ["--bn_mode", "minibatch", "--dtype", "float32", "--inner_param_dtype", "float32", "--inner_scan", "eager"]


def _import_reference_ckpts(root: str, paths, train_ds: str, *, need50: bool) -> bool:
    """Lay a reference training run's ``.tar`` checkpoints (``root``: its
    save_dir or its ``checkpoints/``) out in the port's checkpoint
    directories through ``cli.import_ckpt``, which adds the fresh Adam state
    the port's files carry.  The reference's ``miniImagenet`` directory is
    matched case-insensitively."""
    from mft_tpu_torch import config as cfg_mod
    from mft_tpu_torch.cli import import_ckpt as ic

    base = os.path.join(root, "checkpoints") if os.path.isdir(os.path.join(root, "checkpoints")) else root
    dirs = [d for d in glob.glob(os.path.join(base, "*")) if os.path.isdir(d)]
    ds_dir = next((d for d in dirs if os.path.basename(d).lower().startswith("miniimagenet")), None)
    if ds_dir is None:
        print(f"[import] no miniImagenet checkpoint directory under {base}")
        return False
    specs = [("baseline", None, None), ("gnnnet", 5, 5)]
    if need50:
        specs.append(("gnnnet", 5, 50))
    ok = True
    for method, way, shot in specs:
        name = f"ResNet10_{method}_aug" + (f"_{way}way_{shot}shot" if way else "")
        src = os.path.join(ds_dir, name)
        if not os.path.isdir(src) or not glob.glob(os.path.join(src, "*.tar")):
            print(f"[import] MISSING {src} (no .tar checkpoints)")
            ok = False
            continue
        out = cfg_mod.checkpoint_dir(paths, train_ds, "ResNet10", method, train_aug=True, n_way=way, n_shot=shot)
        args = [src, "--model", "ResNet10", "--method", method, "--out_dir", out]
        if way:
            args += ["--n_way", str(way), "--n_shot", str(shot)]
        ic.main(args)
        print(f"[import] {name} -> {out}")
    return ok


def _write_tree(root: str, n_classes: int = 6, per_class: int = 24, size: int = 64, seed: int = 0):
    """A tiny class-tinted JPEG ImageFolder tree: the --smoke_disk stand-in
    for a real dataset (path config -> ImageFolder manifest -> decode ->
    episode cache on files)."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    tints = rs.rand(n_classes, 1, 1, 3)
    for c in range(n_classes):
        d = os.path.join(root, f"class_{c:02d}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            img = np.clip(0.55 * tints[c] + 0.45 * rs.rand(size, size, 3), 0, 1)
            Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(d, f"{i:03d}.jpg"), quality=88)


def check_staged(datasets):
    """Build every needed manifest: ``(staged {name: images}, missing
    [(name, path, why)])``."""
    from mft_tpu_torch import config as cfg_mod
    from mft_tpu_torch.data import registry

    paths = cfg_mod.Paths.load()
    ok, missing = {}, []
    for name in datasets:
        try:
            entry = registry.get(name)
            man = registry.build_manifest(entry, paths.as_dict(), split="base" if name == "miniImageNet" else None)
            if len(man) == 0:
                raise FileNotFoundError("manifest is empty")
            ok[name] = len(man)
        except Exception as e:  # noqa: BLE001 - anything is reported as unstaged
            missing.append((name, getattr(paths, name, "?"), str(e)))
    return ok, missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--test_datasets", nargs="+", default=["CropDisease", "EuroSAT", "ISIC", "ChestX"])
    ap.add_argument("--shots", nargs="+", type=int, default=[5, 20, 50])
    ap.add_argument("--iter_num", type=int, default=600)
    ap.add_argument("--device", default="cuda", help="torch device of every driver; 'cuda' raises without a card")
    ap.add_argument("--status", action="store_true", help="stage check only")
    ap.add_argument("--skip_train", action="store_true", help="evaluate existing checkpoints")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny end-to-end rehearsal on the synthetic dataset (no real data needed)")
    ap.add_argument("--smoke_disk", action="store_true",
                    help="like --smoke but on tiny JPEG ImageFolder trees staged for miniImageNet/CropDisease at "
                         "real paths (MFT_*_PATH -> ImageFolder manifests -> decode -> episode cache)")
    ap.add_argument("--episode_cache", default=None,
                    help="decoded-episode cache dir (default <save_dir>/epcache; '' disables)")
    ap.add_argument("--import_ckpts", default=None, metavar="REF_SAVE_DIR",
                    help="import checkpoints already trained with the reference (.tar) from this save_dir (or its "
                         "checkpoints/ root) instead of training (cli/import_ckpt.py); implies --skip_train")
    a = ap.parse_args(argv)

    tiny = a.smoke or a.smoke_disk
    if a.smoke:
        a.test_datasets, a.shots, a.iter_num = ["synthetic"], [5], TINY_ITER_NUM
        os.environ.setdefault("MFT_SAVE_DIR_PATH", os.path.join(tempfile.gettempdir(), "mft_parity_smoke", "logs"))
    elif a.smoke_disk:
        root = tempfile.mkdtemp(prefix="mft_parity_disk_")
        _write_tree(os.path.join(root, "mini"))
        _write_tree(os.path.join(root, "crop", "dataset", "train"), seed=1)
        os.environ["MFT_MINIIMAGENET_PATH"] = os.path.join(root, "mini")
        os.environ["MFT_CROPDISEASE_PATH"] = os.path.join(root, "crop")
        os.environ.setdefault("MFT_SAVE_DIR_PATH", os.path.join(root, "logs"))
        a.test_datasets, a.shots, a.iter_num = ["CropDisease"], [5], TINY_ITER_NUM
        print(f"[smoke_disk] staged tiny JPEG trees under {root}")

    from mft_tpu_torch import config as cfg_mod

    paths = cfg_mod.Paths.load()
    train_ds = "synthetic" if a.smoke else "miniImageNet"
    needed = [train_ds] + [d for d in a.test_datasets if d != train_ds]
    ok, missing = check_staged(needed)
    for name, n in ok.items():
        print(f"[staged] {name}: {n} images")
    for name, path, err in missing:
        print(f"[MISSING] {name} (looked at {path!r}: {err})")
        print(f"          -> set MFT_{name.upper()}_PATH or the {name!r} key in mft_paths.json")
        print(f"          -> expected layout: {LAYOUT.get(name, 'see data/registry.py')}")
    if missing:
        print("\nStage the datasets above, then re-run.  (The download links are in the reference's README.)")
        return 2
    if a.status:
        return 0

    cache = a.episode_cache
    if cache is None:
        cache = os.path.join(paths.save_dir, "epcache")
    cache_args = ["--episode_cache", cache] if cache else []

    from mft_tpu_torch.cli import finetune as ft
    from mft_tpu_torch.cli import finetune_50 as ft50
    from mft_tpu_torch.cli import train as tr
    from mft_tpu_torch.cli import train_50 as tr50

    size_args = ["--image_size", "32", "--base_size", "48"] if tiny else []
    device = ["--device", a.device]
    common = ["--dataset", train_ds, "--model", "ResNet10", "--train_aug"] + size_args + device
    if a.import_ckpts:
        if not _import_reference_ckpts(a.import_ckpts, paths, train_ds, need50=any(s >= 50 for s in a.shots)):
            return 2
        a.skip_train = True
    if not a.skip_train:
        # the reference schedule; --stop_epoch is the inclusive last epoch (the reference's 401 / 601 are 400 / 600)
        t0 = time.time()
        ep = TINY_TRAIN if tiny else ["--stop_epoch", "400"]
        ft_ep = TINY_FINETUNE if tiny else ["--start_epoch", "401", "--stop_epoch", "600"]
        tr.main(common + ["--method", "baseline"] + ep)
        tr.main(common + ["--method", "gnnnet", "--n_shot", "5"] + ep)
        tr.main(common + ["--method", "gnnnet", "--n_shot", "5", "--fine_tune"] + ft_ep)
        if any(s >= 50 for s in a.shots):
            tr50.main(common + ["--method", "gnnnet", "--n_shot", "50"] + ep)
            tr50.main(common + ["--method", "gnnnet", "--n_shot", "50", "--fine_tune"] + ft_ep)
        print(f"[train] full schedule done in {(time.time() - t0) / 60:.1f} min")
        if tiny:
            # --method all pins baseline@400 and gnn@600; the short schedule's files are renamed to those epochs
            bdir = cfg_mod.checkpoint_dir(paths, train_ds, "ResNet10", "baseline", train_aug=True)
            shutil.copy(os.path.join(bdir, "0.tar"), os.path.join(bdir, "400.tar"))
            for shot in a.shots:
                gdir = cfg_mod.checkpoint_dir(paths, train_ds, "ResNet10", "gnnnet", train_aug=True, n_way=5,
                                              n_shot=shot)
                shutil.copy(os.path.join(gdir, "1.tar"), os.path.join(gdir, "600.tar"))

    results = {}
    for ds in a.test_datasets:
        for shot in a.shots:
            driver = ft50 if shot >= 50 else ft
            eval_args = (["--dataset", train_ds, "--model", "ResNet10", "--method", "all", "--train_aug",
                          "--test_dataset", ds, "--n_shot", str(shot), "--save_iter", "600",
                          "--iter_num", str(a.iter_num)] + FAST + size_args + cache_args + device)
            eval_args += TINY_EVAL if tiny else ["--gen_examples", "17", "--fine_tune_epoch", "5"]
            print(f"\n=== eval {ds} {shot}-shot (fast path) ===")
            t0 = time.time()
            res = driver.main(eval_args)
            cell = {"acc": round(res.mean, 2), "ci95": round(res.ci95, 2), "wall_s": round(time.time() - t0, 1)}
            if (ds, shot) in PUBLISHED or tiny:
                # gated (or rehearsed) cell: the strict settings too
                print(f"\n=== eval {ds} {shot}-shot (strict parity: f32 + minibatch BN) ===")
                t0 = time.time()
                res_s = driver.main(eval_args + STRICT)
                cell.update(acc_strict=round(res_s.mean, 2), ci95_strict=round(res_s.ci95, 2),
                            wall_s_strict=round(time.time() - t0, 1))
            results[f"{ds}/{shot}shot"] = cell

    print("\n================ parity vs published reference numbers ================")
    rows = []
    for key, r in results.items():
        ds, shot = key.split("/")
        shot = int(shot.replace("shot", ""))
        pub = PUBLISHED.get((ds, shot))
        if pub:
            # the gate is the strict cell; rehearsals on tiny data are reported, not gated
            delta = r.get("acc_strict", r["acc"]) - pub[0]
            verdict = "smoke" if tiny else ("PASS" if abs(delta) <= TOLERANCE_PP else "FAIL")
            rows.append((key, r, f"{pub[0]:.2f}+-{pub[1]:.2f}", f"{delta:+.2f}", verdict))
        else:
            rows.append((key, r, "-", "-", "info"))
    for key, r, pub, delta, verdict in rows:
        strict = f"  strict {r['acc_strict']:6.2f} +-{r['ci95_strict']:.2f}" if "acc_strict" in r else ""
        print(f"{key:24s} fast {r['acc']:6.2f} +-{r['ci95']:.2f}{strict}   published {pub:>12s}  "
              f"d(strict) {delta:>6s}  [{verdict}]")
    if len(results) >= 12:
        avg = sum(r["acc"] for r in results.values()) / len(results)
        print(f"{'average (all trials)':24s} {avg:6.2f}          published {PUBLISHED_AVERAGE:>12.2f}  "
              f"d {avg - PUBLISHED_AVERAGE:+.2f}")

    report = os.path.join(paths.save_dir, "parity_report.json")
    os.makedirs(paths.save_dir, exist_ok=True)
    with open(report, "w") as f:
        json.dump({"results": results, "published": {f"{k[0]}/{k[1]}shot": v for k, v in PUBLISHED.items()},
                   "tolerance_pp": TOLERANCE_PP, "device": a.device}, f, indent=1)
    print(f"report -> {report}")
    return 1 if any(r[4] == "FAIL" for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
