"""DampNet through the port's drivers on the CPU at 32 px, its conversion
to and from the reference's state dict, and ``damp_state`` in the port's
checkpoints.

The drivers run ResNet10 on the synthetic dataset with the recovery
networks cut to tiny widths (``method_cfg`` patched: NTN 8, MLPs 16): at
the published widths one prototype-variant checkpoint with its Adam state
is 3 GB (chip_smoke.py drives those widths on the card).

* ``cli.train``: ``--method dampnet_full_class --train_aug`` and the
  prototype variant ``--method dampnet`` (the plain, corrupt and recover
  modes, the rolling store's count 150 -> 154, resumed to 156, as
  tests/test_e2e_variants.py pins the JAX driver's).
* ``cli.finetune``: the prototype precompute when the checkpoint holds no
  prototypes, ``--unsupervised``, ``--dampnet_eval nofinetune`` (the probe
  fused: row sums 1.5), and ``cli.finetune_50`` with ``--method
  dampnet_full_class`` (the uncompressed 255-node graph).
"""

import json
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from mft_tpu.methods import dampnet as jdn
from mft_tpu.models import backbone as jbb
from mft_tpu.utils import torch_import as ti
from mft_tpu_torch import config as tcfg
from mft_tpu_torch import convert
from mft_tpu_torch.methods import dampnet as tdn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.train import eval_engine as ee
from mft_tpu_torch.utils import checkpoint as ckpt

COMMON = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "32", "--n_shot", "2", "--n_query", "2"]
EVAL = COMMON + ["--test_dataset", "synthetic", "--gen_examples", "1", "--fine_tune_epoch", "1", "--iter_num", "1"]
TINY = tbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, 16))
JTINY = jbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, 16), "simple", flatten=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# conversion and checkpoints
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["dampnet_full_class", "dampnet"])
def test_state_dict_round_trip_under_reference_names(method):
    """The JAX exporter's reference state dict (mft_tpu/utils/torch_import.py)
    and the port's carry the same keys and tensors, both ways; the Bilinear
    weights ``[out, in1, in2]`` verbatim."""
    jc = jdn.prototype_cfg(16, 3, 2) if method == "dampnet" else jdn.DampNetCfg(feat_dim=16, n_way=3, n_support=2)
    fp, fs = jbb.init_backbone(jax.random.PRNGKey(0), JTINY)
    dp, _ = jdn.init_dampnet(jax.random.PRNGKey(1), jc)
    params = jax.tree.map(np.asarray, {"feature": fp, **dp})
    stats = jax.tree.map(np.asarray, fs)
    want = ti.export_state_dict(params, stats, JTINY)
    tp, ts = convert.from_jax(params, stats)
    got = convert.to_state_dict(tp, ts)
    assert sorted(got) == sorted(want)
    assert tuple(got["W_R.weight"].shape) == (jc.ntn_dim, 16, 16) and tuple(got["V_R.weight"].shape) == (jc.ntn_dim, 32)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    back, back_s = convert.from_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in want.items()}, TINY)
    assert convert.to_state_dict(back, back_s).keys() == got.keys()
    for k, v in convert.to_state_dict(back, back_s).items():
        assert torch.equal(v, got[k]), k
    heads = convert.heads_from_state_dict({k: v for k, v in got.items() if not k.startswith("feature.")})
    assert sorted(heads) == sorted(k for k in tp if k != "feature")


def test_damp_state_saved_loaded_and_missing(tmp_path):
    gen = torch.Generator().manual_seed(0)
    fp, fs = tbb.init_backbone(gen, TINY)
    cfg = tdn.prototype_cfg(16, 3, 2)._replace(ntn_dim=8, mlp_hidden=8, mlp_hidden2=8)
    dp, fresh = tdn.init_dampnet(gen, cfg)
    state = tdn.update_prototype_store(fresh, torch.randn(2, 6, 16, generator=gen))
    state = tdn.update_prototypes(state, torch.randn(20, 16, generator=gen))
    path = ckpt.save_checkpoint(str(tmp_path), 3, {"feature": fp, **dp}, fs, damp_state=state)
    epoch, params, _, opt_state, loaded = ckpt.load_checkpoint(path, TINY, None, damp_template=tdn.fresh_state(cfg))
    assert epoch == 3 and opt_state is None and sorted(loaded) == sorted(state)
    for k, v in state.items():
        assert torch.equal(loaded[k], v) and loaded[k].dtype == v.dtype, k
    assert int(loaded["count"]) == 152 and bool(loaded["initialized"])
    assert torch.equal(params["W_R"], dp["W_R"])
    # the full family's state does not fit a prototype-variant file
    with pytest.raises(ValueError, match="damp_state"):
        ckpt.load_checkpoint(path, TINY, None, damp_template=tdn.fresh_state(tdn.DampNetCfg(feat_dim=16)))
    # a reference-format file (no damp_state) loads with the fresh state
    ref = os.path.join(str(tmp_path), "ref.tar")
    convert.save_tar(ref, 4, convert.to_state_dict({"feature": fp, **dp}, fs))
    *_, got = ckpt.load_checkpoint(ref, TINY, None, damp_template=fresh)
    assert got is fresh and not bool(got["initialized"])
    assert len(ckpt.load_checkpoint(ref, TINY, None)) == 4


# --------------------------------------------------------------------------
# the drivers
# --------------------------------------------------------------------------


METHOD_CFG = tdn.method_cfg


def _tiny_method_cfg(method, feat_dim, n_way, n_support):
    return METHOD_CFG(method, feat_dim, n_way, n_support)._replace(ntn_dim=8, mlp_hidden=16, mlp_hidden2=None)


@pytest.fixture(autouse=True, scope="module")
def _tiny_heads():
    with mock.patch.object(tdn, "method_cfg", _tiny_method_cfg):
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory, _tiny_heads):
    from mft_tpu_torch.cli import train

    root = str(tmp_path_factory.mktemp("damp_save"))
    pj = os.path.join(root, "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": root}, f)
    out = {"root": root, "pj": pj}
    out["full_class"] = train.main(COMMON + ["--method", "dampnet_full_class", "--train_aug", "--episodes_per_epoch",
                                             "2", "--stop_epoch", "0", "--paths_json", pj])
    proto = COMMON + ["--method", "dampnet", "--episodes_per_epoch", "2", "--save_freq", "1", "--paths_json", pj]
    out["proto"] = train.main(proto + ["--stop_epoch", "1"])
    out["resumed"] = train.main(proto + ["--start_epoch", "2", "--stop_epoch", "2"])
    return out


def _log(ckpt_dir):
    with open(os.path.join(ckpt_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f if '"mode"' in line]


def test_train_dampnet_variants(trained):
    full = trained["full_class"]
    assert len(full.losses) == 2 and all(np.isfinite(full.losses))
    assert full.ckpt_dir.endswith("ResNet10_dampnet_full_class_aug_5way_2shot")
    _, sd = convert.load_tar(os.path.join(full.ckpt_dir, "0.tar"))
    assert tuple(sd["W_R.weight"].shape) == (8, 512, 512) and tuple(sd["layer3_add.weight"].shape) == (512, 16)
    blob = torch.load(os.path.join(full.ckpt_dir, "0.tar"), weights_only=True)
    assert sorted(blob) == ["adam", "damp_state", "epoch", "state"]
    # before epoch 206 the full family has no prototypes and trains plainly
    assert not bool(blob["damp_state"]["initialized"])
    assert [r["mode"] for r in _log(full.ckpt_dir)] == ["plain", "plain"]

    d = trained["proto"].ckpt_dir
    assert [r["mode"] for r in _log(d)] == ["plain", "corrupt", "recover", "corrupt", "recover", "corrupt"]
    counts = [int(torch.load(os.path.join(d, f"{e}.tar"), weights_only=True)["damp_state"]["count"]) for e in (0, 1, 2)]
    assert counts == [152, 154, 156]  # the resumed run carried the store on
    st = torch.load(os.path.join(d, "2.tar"), weights_only=True)["damp_state"]
    assert tuple(st["store_std"].shape) == (20, 10, 512) and float(st["store_std"][150 % 20].abs().sum()) > 0
    assert all(np.isfinite(trained["proto"].losses + trained["resumed"].losses))


def test_refusals_and_flags():
    from mft_tpu_torch.cli import finetune, train

    with pytest.raises(NotImplementedError, match="--fine_tune or --episode_manifest"):
        train.main(COMMON + ["--method", "dampnet", "--fine_tune"])
    with pytest.raises(SystemExit, match="apply to --method dampnet"):
        finetune.main(EVAL + ["--method", "gnnnet", "--unsupervised", "synthetic"])
    a = tcfg.parse_finetune_args(["--method", "dampnet", "--dampnet_eval", "nofinetune", "--sweep_images", "7"])
    assert (a.dampnet_eval, a.sweep_images, a.unsupervised) == ("nofinetune", 7, "")


def _scores_spy():
    seen = []
    make = ee.make_eval_program

    def spy(**kw):
        program = make(**kw)

        def run(models, base, gens):
            scores, accs = program(models, base, gens)
            seen.extend(scores)
            return scores, accs

        return run

    return seen, mock.patch.object(ee, "make_eval_program", spy)


def test_eval_dampnet_compositions(trained, capsys):
    from mft_tpu_torch.cli import finetune

    pj = trained["pj"]
    res = finetune.main(EVAL + ["--method", "dampnet", "--save_iter", "2", "--sweep_images", "40", "--paths_json", pj])
    out = capsys.readouterr().out
    assert "dampnet source prototypes computed from synthetic" in out and "1 Test Acc = " in out
    assert len(res.accs) == 1 and 0.0 <= res.accs[0] <= 100.0
    seen, spy = _scores_spy()
    with spy:
        finetune.main(EVAL + ["--method", "dampnet_full_class", "--train_aug", "--save_iter", "0", "--sweep_images",
                              "40", "--unsupervised", "synthetic", "--paths_json", pj])
        assert "unsup recovery stats from synthetic" in capsys.readouterr().out
        finetune.main(EVAL + ["--method", "dampnet_full_class", "--train_aug", "--save_iter", "0", "--sweep_images",
                              "40", "--dampnet_eval", "nofinetune", "--paths_json", pj])
    assert len(seen) == 2
    np.testing.assert_allclose(seen[0].sum(1).numpy(), np.ones(10), rtol=1e-5)
    np.testing.assert_allclose(seen[1].sum(1).numpy(), np.full(10, 1.5), rtol=1e-5)


def test_finetune_50_dampnet_full_class_from_a_reference_file(tmp_path, capsys):
    """A reference-format 50-shot ``.tar`` (no damp_state) through
    ``cli.finetune_50``: prototypes swept first, the uncompressed
    5 x 51 = 255-node graph, the fused scan's plain version."""
    from mft_tpu_torch.cli import finetune_50, train

    paths = tcfg.Paths(save_dir=str(tmp_path))
    _, _, params, stats = train.build_model(torch.Generator().manual_seed(0), "dampnet_full_class", "ResNet10", 5, 50,
                                            200)
    d = tcfg.checkpoint_dir(paths, "synthetic", "ResNet10", "dampnet_full_class", train_aug=False, n_way=5, n_shot=50)
    os.makedirs(d)
    convert.save_tar(os.path.join(d, "7.tar"), 7, convert.to_state_dict(params, stats))
    pj = os.path.join(str(tmp_path), "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": str(tmp_path)}, f)
    seen, spy = _scores_spy()
    with spy:
        finetune_50.main(["--device", "cpu", "--dataset", "synthetic", "--test_dataset", "synthetic", "--image_size",
                          "32", "--n_query", "1", "--gen_examples", "0", "--fine_tune_epoch", "1", "--iter_num", "1",
                          "--method", "dampnet_full_class", "--save_iter", "7", "--sweep_images", "64",
                          "--inner_scan", "fused", "--paths_json", pj])
    assert "dampnet source prototypes computed from synthetic" in capsys.readouterr().out
    assert tuple(seen[0].shape) == (5, 5) and torch.isfinite(seen[0]).all()
