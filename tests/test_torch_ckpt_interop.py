"""The port reads and writes the JAX package's ``.ckpt`` checkpoints
(``mft_tpu_torch/utils/checkpoint.py``, ``convert.py``'s state-dict forms,
``cli/import_ckpt.py``, ``cli/export_ckpt.py``), held against JAX's own
writer, reader and tools on the same trees:

* files that JAX's ``save_checkpoint`` wrote (ResNet10 GnnNet and baseline,
  ResNet10_FW under ``freeze_masked``, ``dampnet_full_class`` with its
  ``damp_state``; nonzero Adam moments and step count) load bit-exact:
  weights equal ``from_jax``, the Adam state ``adam_from_jax`` of the same
  trees;
* ``save_flax_checkpoint`` writes the bytes JAX's ``save_checkpoint``
  writes for the same trees, and JAX's ``load_checkpoint`` restores them
  with its training driver's template;
* the eval from a directory of ``.ckpt`` files alone equals the eval from
  ``.tar`` files (the GNN member at 32 px; ``--method all`` loads the same
  trees from both); a ``.ckpt`` resume of
  ``cli.train`` equals a ``.tar`` resume;
* ``import_ckpt`` and ``export_ckpt`` give the JAX tools' tensors on the same
  inputs, and the same DampNet variant error; the resolution helpers take a
  ``.ckpt`` where no ``.tar`` of that epoch exists.

Tolerance: none; every comparison is exact.  The DampNet recovery network
is cut to NTN 8 and MLPs 16 (its widths do not touch the format).
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization as ser

from mft_tpu import config as jcfg
from mft_tpu.cli import export_ckpt as jexport
from mft_tpu.cli import import_ckpt as jimport
from mft_tpu.cli.train import build_model as jbuild_model
from mft_tpu.methods import dampnet as jdn
from mft_tpu.models import backbone as jbb
from mft_tpu.train import optimizers as jopt
from mft_tpu.utils import checkpoint as jckpt
from mft_tpu.utils.torch_import import export_state_dict, load_torch_tar
from mft_tpu_torch import config as tcfg
from mft_tpu_torch import convert
from mft_tpu_torch.cli import export_ckpt, finetune, import_ckpt, train
from mft_tpu_torch.methods import dampnet as tdn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.train import optimizers as topt
from mft_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_tx(params):
    """The JAX training driver's optimizer for ``params`` (cli/train.py:103-108)."""
    tx = jopt.torch_adam(1e-3)
    trainable = jbb.fwt_trainable_mask(params)
    return jopt.freeze_masked(tx, trainable) if not all(jax.tree.leaves(trainable)) else tx


def _port_tx(params):
    tx = topt.torch_adam(1e-3)
    trainable = tbb.fwt_trainable_mask(params)
    return topt.freeze_masked(tx, trainable) if not all(torch.utils._pytree.tree_leaves(trainable)) else tx


def _moved(opt_state):
    """An Adam state as after some steps: nonzero moments and count."""
    return jax.tree.map(lambda x: x + 0.25 if np.issubdtype(x.dtype, np.floating) else x + 3, opt_state)


TINY_DAMP = dict(feat_dim=512, n_way=5, n_support=5, ntn_dim=8, mlp_hidden=16, stat="class")


def _jax_run(kind: str, seed: int = 0):
    """JAX trees of one checkpoint: ``(params, stats, opt_state, damp_state)``."""
    key = jax.random.PRNGKey(seed)
    if kind == "dampnet_full_class":
        kb, kh = jax.random.split(key)
        feature, stats = jbb.init_backbone(kb, jbb.resnet10())
        dparams, dstate = jdn.init_dampnet(kh, jdn.DampNetCfg(**TINY_DAMP))
        params = {"feature": feature, **dparams}
        dstate = {**dstate, "proto_mean": dstate["proto_mean"] + 1.5, "initialized": np.asarray(True)}
    else:
        method, model = {"gnnnet": ("gnnnet", "ResNet10"), "baseline": ("baseline", "ResNet10"),
                         "fw": ("gnnnet", "ResNet10_FW")}[kind]
        _, _, params, stats, dstate = jbuild_model(key, method, model, 5, 5, 64)
    return params, stats, _moved(_jax_tx(params).init(params)), dstate


MODELS = {"gnnnet": "ResNet10", "baseline": "ResNet10", "fw": "ResNet10_FW", "dampnet_full_class": "ResNet10"}


def _keyed_equal(a, b):
    ka, kb = ckpt.keyed(a), ckpt.keyed(b)
    assert sorted(ka) == sorted(kb)
    for k in ka:
        assert ka[k].dtype == kb[k].dtype and torch.equal(ka[k], kb[k]), k


@pytest.mark.parametrize("kind", list(MODELS))
def test_jax_ckpt_loads_bit_exact(kind, tmp_path):
    params, stats, opt_state, dstate = _jax_run(kind)
    tree = {"epoch": 41, "params": params, "stats": stats, "opt_state": opt_state}
    if dstate is not None:
        tree["damp_state"] = dstate
    path = jckpt.save_checkpoint(str(tmp_path), 41, tree)
    want_p, want_s = convert.from_jax(_np(params), _np(stats))
    want_o = convert.adam_from_jax(_np(opt_state))
    damp_template = tdn.fresh_state(tdn.DampNetCfg(**TINY_DAMP)) if dstate is not None else None
    got = ckpt.load_checkpoint(path, tbb.MODEL_REGISTRY[MODELS[kind]](), _port_tx(want_p).init(want_p),
                               damp_template=damp_template)
    epoch, p, s, o = got[:4]
    assert epoch == 41 and o["t"] == want_o["t"] == 3
    _keyed_equal(p, want_p)
    _keyed_equal(s, want_s)
    _keyed_equal(o["mu"], want_o["mu"])
    _keyed_equal(o["nu"], want_o["nu"])
    if kind == "fw":  # freeze_masked: the noise strengths keep no moments
        assert not any("fwt" in k for k in ckpt.keyed(o["mu"])) and any("fwt" in k for k in ckpt.keyed(p))
    if dstate is not None:
        _keyed_equal(got[4], convert.damp_state_from_jax(_np(dstate)))
        assert bool(got[4]["initialized"]) and got[4]["initialized"].dtype == torch.bool
    # the raw state-dict form of the optimizer equals the optax form
    from mft_tpu_torch.utils import flax_msgpack

    raw = convert.adam_from_state_dict(flax_msgpack.read(path)["opt_state"])
    _keyed_equal(raw["mu"], want_o["mu"])


@pytest.mark.parametrize("kind", list(MODELS))
def test_save_flax_checkpoint_is_jax_save_checkpoint(kind, tmp_path):
    """Same trees, same bytes; JAX restores the file with its driver's
    template (``cli/train.py:119-126``)."""
    params, stats, opt_state, dstate = _jax_run(kind, seed=1)
    tree = {"epoch": 7, "params": params, "stats": stats, "opt_state": opt_state}
    if dstate is not None:
        tree["damp_state"] = dstate
    want = jckpt.save_checkpoint(str(tmp_path / "jax"), 7, tree)
    p, s = convert.from_jax(_np(params), _np(stats))
    o = convert.adam_from_jax(_np(opt_state))
    d = convert.damp_state_from_jax(_np(dstate)) if dstate is not None else None
    got = ckpt.save_flax_checkpoint(str(tmp_path / "port"), 7, p, s, o, d)
    assert got.endswith("7.ckpt") and open(got, "rb").read() == open(want, "rb").read()
    template = {"epoch": 0, "params": params, "stats": stats, "opt_state": _jax_tx(params).init(params)}
    if dstate is not None:
        template["damp_state"] = dstate
    back = jckpt.load_checkpoint(got, template)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(tree))))
    if kind == "gnnnet":  # without an Adam state: a fresh one, which JAX restores too
        fresh = ckpt.save_flax_checkpoint(str(tmp_path / "fresh"), 8, p, s)
        back = jckpt.load_checkpoint(fresh, template)
        assert int(back["epoch"]) == 8 and int(back["opt_state"][0].count) == 0


def test_resolution_prefers_tar(tmp_path):
    d = str(tmp_path)
    assert ckpt.get_resume_file(d) is None and ckpt.get_assigned_file(d, 3).endswith("3.tar")
    for name in ("3.ckpt", "5.ckpt", "5.tar", "best_model.ckpt"):
        open(os.path.join(d, name), "wb").close()
    assert ckpt.get_assigned_file(d, 3) == os.path.join(d, "3.ckpt")
    assert ckpt.get_assigned_file(d, 5) == os.path.join(d, "5.tar")
    assert ckpt.get_resume_file(d) == os.path.join(d, "5.tar")
    assert ckpt.get_best_file(d) == os.path.join(d, "best_model.ckpt")
    open(os.path.join(d, "7.ckpt"), "wb").close()
    open(os.path.join(d, "best_model.tar"), "wb").close()
    assert ckpt.get_resume_file(d) == os.path.join(d, "7.ckpt")
    assert ckpt.get_best_file(d) == os.path.join(d, "best_model.tar")


@pytest.fixture(scope="module")
def tar_and_ckpt_runs(tmp_path_factory):
    """chip_smoke's seeded ``.tar`` checkpoints, and the same weights as
    ``.ckpt`` files alone in a second save dir."""
    sys.path.insert(0, REPO)
    import chip_smoke

    tar_root = str(tmp_path_factory.mktemp("tar_run"))
    pj_tar = chip_smoke.write_checkpoints(torch, tar_root)
    ckpt_root = str(tmp_path_factory.mktemp("ckpt_run"))
    for dirpath, _, names in os.walk(os.path.join(tar_root, "checkpoints")):
        for name in names:
            epoch, p, s, _ = ckpt.load_checkpoint(os.path.join(dirpath, name), tbb.resnet10(), None)
            ckpt.save_flax_checkpoint(os.path.join(ckpt_root, os.path.relpath(dirpath, tar_root)), epoch, p, s)
    pj_ckpt = os.path.join(ckpt_root, "paths.json")
    with open(pj_ckpt, "w") as f:
        json.dump({"save_dir": ckpt_root}, f)
    return pj_tar, pj_ckpt, tar_root, ckpt_root


def test_eval_from_ckpt_files_equals_eval_from_tar(tar_and_ckpt_runs):
    pj_tar, pj_ckpt, _, ckpt_root = tar_and_ckpt_runs
    files = [n for _, _, names in os.walk(ckpt_root) for n in names]
    assert files and not any(n.endswith(".tar") for n in files)
    # the GNN member alone (its fused scan); --method all's loader, which reads baseline@400 too, below
    argv = ["--device", "cpu", "--method", "gnnnet", "--train_aug", "--save_iter", "600", "--use_pallas",
            "--inner_scan", "fused", "--test_dataset", "synthetic", "--image_size", "32", "--n_shot", "5", "--n_query",
            "3", "--gen_examples", "1", "--fine_tune_epoch", "1", "--iter_num", "2", "--eval_batch", "2", "--dtype",
            "float32", "--inner_param_dtype", "float32"]
    from_tar = finetune.main(argv + ["--paths_json", pj_tar])
    from_ckpt = finetune.main(argv + ["--paths_json", pj_ckpt])
    assert from_ckpt.accs == from_tar.accs and len(from_tar.accs) == 2
    a = tcfg.parse_finetune_args(["--device", "cpu", "--method", "all", "--paths_json", pj_ckpt])
    models = finetune.build_models(a, tcfg.Paths.load(pj_ckpt), tbb.resnet10(), torch.device("cpu"))
    a = tcfg.parse_finetune_args(["--device", "cpu", "--method", "all", "--paths_json", pj_tar])
    want = finetune.build_models(a, tcfg.Paths.load(pj_tar), tbb.resnet10(), torch.device("cpu"))
    _keyed_equal(models, want)


def test_jax_eval_reads_the_ports_ckpt(tar_and_ckpt_runs):
    """The JAX eval's strict loader (``cli/finetune.py:_load_backbone_state``)
    maps every tree of a port-written ``.ckpt``."""
    from mft_tpu.cli import finetune as jfinetune
    from mft_tpu.methods import gnnnet as jgn

    _, pj_ckpt, tar_root, ckpt_root = tar_and_ckpt_runs
    d = tcfg.checkpoint_dir(tcfg.Paths(save_dir=ckpt_root), "miniImageNet", "ResNet10", "gnnnet", train_aug=True,
                            n_way=5, n_shot=5)
    head = jgn.init_head(jax.random.PRNGKey(0), jgn.GnnNetCfg())
    p, s = jfinetune._load_backbone_state(os.path.join(d, "600.ckpt"), jbb.resnet10(),
                                          template_extra={"fc": head["fc"], "gnn": head["gnn"]})
    _, tp, ts, _ = ckpt.load_checkpoint(os.path.join(d.replace(ckpt_root, tar_root), "600.tar"), tbb.resnet10(), None)
    want_p, want_s = convert.from_jax(_np(p), _np(s))
    _keyed_equal(want_p, tp)
    _keyed_equal(want_s, ts)


def test_ckpt_resume_equals_tar_resume(tmp_path):
    """One episodic GnnNet epoch to ``0.tar``; the same file as ``0.ckpt``
    alone in a second save dir; both resume one more epoch: equal weights
    and Adam state."""
    roots = {}
    for name in ("tar", "ckpt"):
        root = tmp_path / name
        root.mkdir()
        with open(root / "paths.json", "w") as f:
            json.dump({"save_dir": str(root)}, f)
        roots[name] = str(root)
    argv = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "32", "--method", "gnnnet", "--train_aug",
            "--use_pallas", "--episodes_per_epoch", "1", "--n_query", "2"]
    first = train.main(argv + ["--start_epoch", "0", "--stop_epoch", "0", "--paths_json",
                               os.path.join(roots["tar"], "paths.json")])
    d_tar = first.ckpt_dir
    d_ckpt = d_tar.replace(roots["tar"], roots["ckpt"])
    bcfg, _, params, _ = train.build_model(torch.Generator().manual_seed(0), "gnnnet", "ResNet10", 5, 5, 200)
    template = topt.torch_adam(1e-3).init(params)
    e, p, s, o = ckpt.load_checkpoint(os.path.join(d_tar, "0.tar"), bcfg, template)
    ckpt.save_flax_checkpoint(d_ckpt, e, p, s, o)
    assert o["t"] == 1 and ckpt.get_resume_file(d_ckpt) == os.path.join(d_ckpt, "0.ckpt")
    for name in ("tar", "ckpt"):
        train.main(argv + ["--start_epoch", "1", "--stop_epoch", "1", "--paths_json",
                           os.path.join(roots[name], "paths.json")])
    got = ckpt.load_checkpoint(os.path.join(d_ckpt, "1.tar"), bcfg, template)
    want = ckpt.load_checkpoint(os.path.join(d_tar, "1.tar"), bcfg, template)
    assert got[0] == want[0] == 1 and got[3]["t"] == want[3]["t"] == 2
    for g, w in zip(got[1:3] + (got[3]["mu"], got[3]["nu"]), want[1:3] + (want[3]["mu"], want[3]["nu"])):
        _keyed_equal(g, w)


def _reference_tar(path, kind: str, seed: int):
    """A reference ``{'epoch', 'state'}`` file of a JAX run's weights."""
    params, stats, _, _ = _jax_run(kind, seed)
    p, s = convert.from_jax(_np(params), _np(stats))
    convert.save_tar(str(path), 400, convert.to_state_dict(p, s))


@pytest.mark.parametrize("kind", ["gnnnet", "fw"])
def test_import_matches_the_jax_importer(kind, tmp_path):
    """A reference ``.tar`` through both importers: the same weights and a
    fresh (``freeze_masked`` on ResNet10_FW) Adam state; then a JAX
    ``.ckpt`` through the port's importer keeps its Adam state; a directory
    of both kinds imports every file, ``best_model`` keeps its name."""
    model = MODELS[kind]
    src = tmp_path / "src"
    src.mkdir()
    _reference_tar(src / "400.tar", kind, 2)
    assert jimport.main([str(src / "400.tar"), "--model", model, "--out_dir", str(tmp_path / "jax")]) == 0
    assert import_ckpt.main([str(src / "400.tar"), "--model", model, "--out_dir", str(tmp_path / "port")]) == 0
    bcfg = tbb.MODEL_REGISTRY[model]()
    _, p, s, o = ckpt.load_checkpoint(str(tmp_path / "jax" / "400.ckpt"), bcfg, None)
    tmpl = _port_tx(p).init(p)
    jax_side = ckpt.load_checkpoint(str(tmp_path / "jax" / "400.ckpt"), bcfg, tmpl)
    port_side = ckpt.load_checkpoint(str(tmp_path / "port" / "400.tar"), bcfg, tmpl)
    assert jax_side[0] == port_side[0] == 400 and jax_side[3]["t"] == port_side[3]["t"] == 0
    for a, b in zip(jax_side[1:3] + (jax_side[3]["mu"],), port_side[1:3] + (port_side[3]["mu"],)):
        _keyed_equal(a, b)
    # a JAX .ckpt with moved Adam state, and a best_model, from one directory
    params, stats, opt_state, _ = _jax_run(kind, 3)
    run = tmp_path / "run"
    jckpt.save_checkpoint(str(run), 9, {"epoch": 9, "params": params, "stats": stats, "opt_state": opt_state})
    shutil.copy(src / "400.tar", run / "best_model.tar")
    assert import_ckpt.main([str(run), "--model", model, "--out_dir", str(tmp_path / "port2")]) == 0
    assert sorted(os.listdir(tmp_path / "port2")) == ["9.tar", "best_model.tar"]
    got = ckpt.load_checkpoint(str(tmp_path / "port2" / "9.tar"), bcfg, tmpl)
    want = convert.adam_from_jax(_np(opt_state))
    assert got[3]["t"] == 3
    _keyed_equal(got[3]["mu"], want["mu"])
    _keyed_equal(got[3]["nu"], want["nu"])


def test_import_dampnet_variant_error_and_state(tmp_path, capsys):
    """A DampNet file needs its --method (the JAX importer's error, word for
    word); with it, a reference .tar gets a fresh damp_state and a JAX
    .ckpt keeps its own."""
    params, stats, opt_state, dstate = _jax_run("dampnet_full_class", 4)
    p, s = convert.from_jax(_np(params), _np(stats))
    convert.save_tar(str(tmp_path / "400.tar"), 400, convert.to_state_dict(p, s))
    errors = []
    for tool in (jimport, import_ckpt):
        with pytest.raises(SystemExit) as e:
            tool.main([str(tmp_path / "400.tar"), "--out_dir", str(tmp_path / "x"), "--method", "gnnnet"])
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and "pass the correct --method" in errors[0]
    assert import_ckpt.main([str(tmp_path / "400.tar"), "--out_dir", str(tmp_path / "port"), "--method",
                             "dampnet_full_class"]) == 0
    blob = torch.load(tmp_path / "port" / "400.tar", weights_only=True)
    assert not bool(blob["damp_state"]["initialized"]) and blob["adam"]["t"] == 0
    jckpt.save_checkpoint(str(tmp_path / "run"), 5, {"epoch": 5, "params": params, "stats": stats,
                                                     "opt_state": opt_state, "damp_state": dstate})
    assert import_ckpt.main([str(tmp_path / "run" / "5.ckpt"), "--out_dir", str(tmp_path / "port"), "--method",
                             "dampnet_full_class"]) == 0
    blob = torch.load(tmp_path / "port" / "5.tar", weights_only=True)
    want = convert.damp_state_from_jax(_np(dstate))
    assert sorted(blob["damp_state"]) == sorted(want)
    assert all(torch.equal(blob["damp_state"][k], want[k]) for k in want) and blob["adam"]["t"] == 3


@pytest.mark.parametrize("kind", ["gnnnet", "fw", "baseline"])
def test_export_matches_the_jax_exporter(kind, tmp_path):
    """A JAX ``.ckpt`` through the port's exporter gives the state dict of
    JAX's ``export_state_dict`` (keys, dtypes, shapes, values), as the JAX
    exporter computes it; the port's own ``.tar`` exports without its
    ``adam``."""
    model = MODELS[kind]
    params, stats, opt_state, _ = _jax_run(kind, 5)
    src = jckpt.save_checkpoint(str(tmp_path / "run"), 12, {"epoch": 12, "params": params, "stats": stats,
                                                             "opt_state": opt_state})
    assert jexport.main([src, "--model", model, "--out", str(tmp_path / "jax.tar")]) == 0
    assert export_ckpt.main([src, "--model", model, "--out", str(tmp_path / "port.tar")]) == 0
    raw = ser.msgpack_restore(open(src, "rb").read())
    want = export_state_dict(raw["params"], raw["stats"], jbb.MODEL_REGISTRY[model]())
    blob = torch.load(tmp_path / "port.tar", weights_only=True)
    assert blob["epoch"] == 12 and set(blob) == {"epoch", "state"}
    got = blob["state"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype and np.array_equal(got[k].numpy(), want[k]), k
    # the JAX tool's file: the same values (its writer stores num_batches_tracked as shape [1], not [])
    e1, cli = load_torch_tar(str(tmp_path / "jax.tar"))
    assert e1 == 12 and sorted(cli) == sorted(want)
    assert all(np.array_equal(cli[k].reshape(-1), got[k].numpy().reshape(-1)) for k in want)
    # the port's .tar with its Adam state: exported to a directory, without 'adam'
    p, s = convert.from_jax(_np(params), _np(stats))
    port_tar = ckpt.save_checkpoint(str(tmp_path / "port_run"), 12, p, s, convert.adam_from_jax(_np(opt_state)))
    out = tmp_path / "out"
    out.mkdir()
    assert export_ckpt.main([port_tar, "--model", model, "--out", str(out)]) == 0
    blob = torch.load(out / "12.tar", weights_only=True)
    assert set(blob) == {"epoch", "state"} and sorted(blob["state"]) == sorted(want)
    with pytest.raises(SystemExit):  # exporting a .tar beside itself would overwrite it
        export_ckpt.main([port_tar, "--model", model])


def test_jax_paths_layout_matches(tmp_path):
    """``--dataset``/``--method`` derive the same directory in both importers."""
    kw = dict(train_aug=True, n_way=5, n_shot=5)
    assert (tcfg.checkpoint_dir(tcfg.Paths(save_dir=str(tmp_path)), "miniImageNet", "ResNet10", "gnnnet", **kw)
            == jcfg.checkpoint_dir(jcfg.Paths(save_dir=str(tmp_path)), "miniImageNet", "ResNet10", "gnnnet", **kw))
