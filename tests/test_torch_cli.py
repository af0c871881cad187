"""The port's eval driver (mft_tpu_torch/cli/finetune.py) end to end on the
CPU, loading checkpoints that the JAX package wrote (JAX init -> ``.ckpt``
-> ``mft_tpu.cli.export_ckpt`` -> reference ``.tar``), and the port's
isolation from JAX.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def save_dir(tmp_path_factory):
    from mft_tpu import config as jcfg
    from mft_tpu.cli import export_ckpt
    from mft_tpu.methods import gnnnet as jgn
    from mft_tpu.models import backbone as jbb
    from mft_tpu.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("mft_save")
    paths = jcfg.Paths(save_dir=str(root))
    init = jax.jit(lambda k: jbb.init_backbone(k, jbb.resnet10()))
    for method, epoch, kw, seed in (("baseline", 400, dict(train_aug=False), 0),
                                    ("gnnnet", 600, dict(train_aug=True, n_way=5, n_shot=5), 1)):
        p, s = init(jax.random.PRNGKey(seed))
        params = {"feature": p}
        if method == "gnnnet":
            params.update(jgn.init_head(jax.random.PRNGKey(7), jgn.GnnNetCfg()))
        d = jcfg.checkpoint_dir(paths, "miniImageNet", "ResNet10", method, **kw)
        src = save_checkpoint(os.path.join(str(root), "jax", method), epoch,
                              {"epoch": epoch, "params": params, "stats": s})
        os.makedirs(d)
        assert export_ckpt.main([src, "--model", "ResNet10", "--out", os.path.join(d, f"{epoch}.tar")]) == 0
    return str(root)


def test_finetune_method_all_on_cpu(save_dir, capsys):
    from mft_tpu_torch.cli import finetune

    pj = os.path.join(save_dir, "paths.json")
    with open(pj, "w") as f:
        f.write('{"save_dir": "%s"}' % save_dir)
    res = finetune.main(["--device", "cpu", "--method", "all", "--use_pallas", "--test_dataset", "synthetic",
                         "--image_size", "32", "--n_shot", "5", "--n_query", "3", "--gen_examples", "1",
                         "--fine_tune_epoch", "1", "--iter_num", "2", "--paths_json", pj])
    out = capsys.readouterr().out
    assert "2 Test Acc = " in out
    assert len(res.accs) == 2 and all(np.isfinite(res.accs)) and all(0.0 <= a <= 100.0 for a in res.accs)
    # the synthetic classes are tinted: even random weights separate them
    assert res.mean > 100.0 / 5


def test_entry_point_needs_a_card_unless_cpu_is_asked(tmp_path):
    import torch

    from mft_tpu_torch import resolve_device
    from mft_tpu_torch.cli import finetune

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            finetune.main(["--method", "all", "--test_dataset", "synthetic"])
    # DampNet evaluates since it was ported: a JAX-written reference .tar (no
    # damp_state, so the prototypes are swept first; recovery widths cut to
    # keep the file small)
    from unittest import mock

    from mft_tpu.methods import dampnet as jdn
    from mft_tpu.models import backbone as jbb
    from mft_tpu.utils import torch_import as ti
    from mft_tpu_torch import config as tcfg
    from mft_tpu_torch.methods import dampnet as tdn

    narrow = dict(ntn_dim=8, mlp_hidden=16)
    fp, fs = jax.jit(lambda k: jbb.init_backbone(k, jbb.resnet10()))(jax.random.PRNGKey(3))
    dp, _ = jax.jit(lambda k: jdn.init_dampnet(k, jdn.DampNetCfg(n_support=2, **narrow)))(jax.random.PRNGKey(4))
    sd = ti.export_state_dict(jax.tree.map(np.asarray, {"feature": fp, **dp}), jax.tree.map(np.asarray, fs),
                              jbb.resnet10())
    d = tcfg.checkpoint_dir(tcfg.Paths(save_dir=str(tmp_path)), "synthetic", "ResNet10", "dampnet_full_class",
                            train_aug=False, n_way=5, n_shot=2)
    os.makedirs(d)
    torch.save({"epoch": 1, "state": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
               os.path.join(d, "1.tar"))
    pj = str(tmp_path / "paths.json")
    with open(pj, "w") as f:
        f.write('{"save_dir": "%s"}' % tmp_path)
    real = tdn.method_cfg
    with mock.patch.object(tdn, "method_cfg", lambda *a: real(*a)._replace(**narrow)):
        res = finetune.main(["--device", "cpu", "--method", "dampnet_full_class", "--dataset", "synthetic",
                             "--test_dataset", "synthetic", "--image_size", "32", "--n_shot", "2", "--n_query", "2",
                             "--gen_examples", "1", "--fine_tune_epoch", "1", "--iter_num", "1", "--sweep_images",
                             "64", "--paths_json", pj])
    assert len(res.accs) == 1 and 0.0 <= res.accs[0] <= 100.0
    with pytest.raises(NotImplementedError, match="--method relationnet"):
        finetune.main(["--device", "cpu", "--method", "relationnet", "--test_dataset", "synthetic"])
    # the registry's split-backbone pieces have no driver path, as in the JAX package
    with pytest.raises(SystemExit, match="the drivers run"):
        finetune.main(["--device", "cpu", "--method", "all", "--test_dataset", "synthetic", "--eval_batch", "2",
                       "--model", "ResNet_fin"])


def test_port_imports_neither_jax_nor_mft_tpu():
    """Every module of mft_tpu_torch, and chip_smoke.py with the modules its
    phases import, in a fresh interpreter: no jax, no mft_tpu."""
    code = """
import importlib, pkgutil, sys
import mft_tpu_torch
for m in pkgutil.walk_packages(mft_tpu_torch.__path__, "mft_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
import torch.profiler
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith(("jax.", "jaxlib", "flax", "optax"))
             or k == "mft_tpu" or k.startswith("mft_tpu."))
print("BAD", bad)
print("N", sum(k.startswith("mft_tpu_torch") for k in sys.modules))
need = ["mft_tpu_torch." + m for m in ("cli.train", "train.steps", "methods.protonet", "utils.checkpoint",
                                         "utils.metrics", "data.pipeline", "train.inner_loop", "cli.finetune_50",
                                         "cli.train_50", "methods.dampnet", "train.optimizers", "convert",
                                         "ops.norm", "ops.augment", "ops.convpool", "models.backbone", "models.gnn",
                                         "methods.gnnnet", "methods.baseline", "train.eval_engine",
                                         "kernels.fused_inner_scan", "cli.finetune", "config")]
print("MISSING", [m for m in need if m not in sys.modules])
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("N ")[1].split()[0]) >= 25
    assert "MISSING []" in out.stdout, out.stdout
