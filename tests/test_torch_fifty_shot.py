"""The port's 50-shot path: the compressed GnnNet head (reference
gnnnet_copy.py; support embeddings pair-averaged after the projector, so a
5-way 50-shot graph has 5 * (25 + 1) = 130 nodes), its training goldens,
its conversion, and the 50-shot drivers ``cli/finetune_50.py`` and
``cli/train_50.py`` end to end on the CPU.

Goldens: the reference's own gnnnet_copy runs of
tests/fixtures/golden_reference.npz, at the JAX tests' tolerances
(tests/test_golden_reference.py:170, 998, 1040): the set forward in f32
(rtol 1e-3, atol 1e-4), the episodic train backward (loss rtol 1e-9,
gradients rtol 1e-6 with 1e-8 of each tensor's largest value) and the
5-epoch meta fine-tune backward (loss and stats rtol 1e-8, gradients rtol
1e-5 with 1e-7) in f64.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mft_tpu.methods import gnnnet as jgn
from mft_tpu.models import backbone as jbb
from mft_tpu.utils import torch_import as ti
from mft_tpu_torch import convert
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.train import steps
from mft_tpu_torch.train.inner_loop import InnerLoopCfg, schedule_from_perms
from mft_tpu_torch.utils.checkpoint import keyed
from tests import test_golden_reference as tg
from tests.test_torch_train_golden import TINY, _close, _grads, _trees

HERE = os.path.dirname(__file__)
GCFG50 = tgn.GnnNetCfg(feat_dim=16, n_way=2, n_support=4, support_compress=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g():
    with np.load(os.path.join(HERE, "fixtures", "golden_reference.npz")) as z:
        return {k: z[k] for k in z.files if k.startswith(("g50", "gnnnet50"))}


# --------------------------------------------------------------------------
# the reference's gnnnet_copy goldens through the port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gnnnet50_compressed_set_forward(g, use_pallas):
    """gnnnet_copy.set_forward(is_feature=True) (gnnnet_copy.py:51-78) with
    the head built by the JAX golden test's own tree builders and carried
    over by ``convert.from_jax``; ``use_pallas`` takes the edge kernel's
    wrapper, which on CPU tensors computes its plain version."""
    head = {
        "fc": {"linear": tg.lin_mat(g["gnnnet50.fc.0.weight"], g["gnnnet50.fc.0.bias"]),
               "bn": {"scale": g["gnnnet50.fc.1.weight"], "bias": g["gnnnet50.fc.1.bias"]}},
        "gnn": {
            "layers": [{"w": tg._wcompute_tree(g, f"gnnnet50.gnn.layer_w{i}"),
                        "l": tg._gconv_tree(g, f"gnnnet50.gnn.layer_l{i}")} for i in range(2)],
            "w_last": tg._wcompute_tree(g, "gnnnet50.gnn.w_comp_last"),
            "l_last": tg._gconv_tree(g, "gnnnet50.gnn.layer_last", bn=False),
        },
    }
    head, _ = convert.from_jax(jax.tree.map(np.asarray, head))
    cfg = tgn.GnnNetCfg(feat_dim=16, n_way=3, n_support=4, support_compress=2, use_pallas=use_pallas)
    scores = tgn.gnn_scores(head, torch.from_numpy(g["gnnnet50.feats"]), cfg, n_query=15)
    np.testing.assert_allclose(scores.numpy(), g["gnnnet50.scores"], rtol=1e-3, atol=1e-4)


def _ep(seed):
    return torch.from_numpy(np.random.RandomState(seed).rand(2, 20, 3, 224, 224))


def test_gnnnet50_train_backward_golden(g):
    """gnnnet_copy.set_forward_loss(x).backward() (train_loop50): backbone,
    projector, post-projection pair-averaging, the halved graphs, f64."""
    params, stats = _trees(g, "g50")
    spec = EpisodeSpec(2, 4, 16)
    ep = _ep(888)
    loss, _, grads = _grads(lambda p: steps._episode_loss(p, stats, ep, method="gnnnet", bcfg=TINY, gcfg=GCFG50,
                                                          spec=spec), params)
    np.testing.assert_allclose(loss, float(g["g50.loss"]), rtol=1e-9)
    want, _ = _trees(g, "g50", grads="g50.grad")
    _close(grads, want, 1e-6, 1e-8, "grad")


def test_gnnnet50_finetune_backward_golden(g):
    """gnnnet_copy.set_forward_loss_finetune(x).backward()
    (train_loop_finetune50): the inner 5-epoch Adam(0.01) x batch-4 loop
    over the whole uncompressed support bank with train-mode BN (recorded
    permutations), the running-stat trajectory, the first-order outer
    gradients, f64.  The port's ``inner_epochs`` gives the 5 epochs."""
    params, stats = _trees(g, "g50")
    spec = EpisodeSpec(2, 4, 16)
    epochs = steps.inner_epochs("gnnnet", GCFG50)
    assert epochs == 5
    mcfg = steps.MetaFinetuneCfg(epochs=epochs, batch_size=4, bn_mode="minibatch")
    sched = schedule_from_perms(g["g50ft.perms"], InnerLoopCfg(epochs, 4, 8))
    ep = _ep(889)
    loss, new_stats, grads = _grads(
        lambda p: steps._meta_finetune_episode_loss(p, stats, ep, None, method="gnnnet", bcfg=TINY, gcfg=GCFG50,
                                                    spec=spec, mcfg=mcfg, schedule=sched), params)
    np.testing.assert_allclose(loss, float(g["g50ft.loss"]), rtol=1e-8)
    _, want_stats = _trees(g, "g50", stats_from="g50ft.post_stats")
    _close(new_stats, want_stats, 1e-8, 1e-10, "post_stats")
    want, _ = _trees(g, "g50", grads="g50ft.grad")
    _close(grads, want, 1e-5, 1e-7, "grad")


# --------------------------------------------------------------------------
# the 50-shot head at full width: conversion and the 130-node graphs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def head50():
    """A full-width 50-shot GnnNet (ResNet10 + compressed head) drawn by JAX,
    as numpy trees."""
    gcfg = jgn.GnnNetCfg(feat_dim=512, n_way=5, n_support=50, support_compress=2)
    kb, kh = jax.random.split(jax.random.PRNGKey(5))
    feature, stats = jax.jit(lambda k: jbb.init_backbone(k, jbb.resnet10()))(kb)
    head = jax.jit(lambda k: jgn.init_head(k, gcfg))(kh)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return gcfg, to_np({"feature": feature, **head}), to_np(stats)


def test_fifty_shot_head_converts_from_jax_and_from_a_tar(head50, tmp_path):
    """The compressed head's parameters do not depend on N: the JAX tree
    (``from_jax``) and the reference ``.tar`` that the JAX exporter writes
    (``load_tar`` + ``from_state_dict``) give the port the same tensors, and
    the port's scores on 130-node graphs match JAX's."""
    gcfg, params, stats = head50
    want_p, want_s = convert.from_jax(params, stats)
    path = str(tmp_path / "600.tar")
    ti.save_torch_tar(path, 600, ti.export_state_dict(params, stats, jbb.resnet10()))
    epoch, sd = convert.load_tar(path)
    got_p, got_s = convert.from_state_dict(sd, tbb.resnet10())
    assert epoch == 600
    for label, a, b in (("params", got_p, want_p), ("stats", got_s, want_s)):
        a, b = keyed(a), keyed(b)
        assert sorted(a) == sorted(b), label
        for k in b:
            assert torch.equal(a[k], b[k]), f"{label} {k}"
    feats = np.random.RandomState(6).randn(5, 65, 512).astype(np.float32)
    want = np.asarray(jax.jit(lambda h, z: jgn.gnn_scores(h, z, gcfg, 15))(
        {"fc": params["fc"], "gnn": params["gnn"]}, feats))
    tcfg = tgn.GnnNetCfg(feat_dim=512, n_way=5, n_support=50, support_compress=2)
    assert tcfg.graph_spec.n_way * (tcfg.eff_support + 1) == 130
    got = tgn.gnn_scores({"fc": got_p["fc"], "gnn": got_p["gnn"]}, torch.from_numpy(feats), tcfg, 15)
    assert tuple(got.shape) == (75, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# the 50-shot drivers end to end on the CPU
# --------------------------------------------------------------------------


COMMON = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "32", "--dtype", "float32"]


def test_train_50_then_finetune_50_on_cpu(tmp_path):
    """``cli.train_50`` (GnnNet, ``--train_aug --use_pallas``) writes a 50-shot
    checkpoint in the ``_5way_50shot`` directory, and ``cli.finetune_50``
    evaluates it: one 5-way 50-shot episode at 32 px, 130-node graphs.  The
    synthetic classes hold 48 images, so a 50-shot episode draws with
    replacement (``data/sampler.py``), as the JAX package's 50-shot tests do."""
    from mft_tpu_torch.cli import finetune_50, train_50
    from mft_tpu_torch.kernels import edge_mlp

    pj = str(tmp_path / "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": str(tmp_path)}, f)
    res = train_50.main(COMMON + ["--method", "gnnnet", "--train_aug", "--use_pallas", "--n_query", "2",
                                  "--episodes_per_epoch", "1", "--stop_epoch", "0", "--paths_json", pj])
    assert res.ckpt_dir.endswith("ResNet10_gnnnet_aug_5way_50shot")
    assert len(res.losses) == 1 and np.isfinite(res.losses[0])
    assert "0.tar" in os.listdir(res.ckpt_dir)  # the stop epoch is saved whatever --save_freq (10 here)
    seen = []
    real = edge_mlp.edge_abs_diff_matmul_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(edge_mlp, "edge_abs_diff_matmul_reference", lambda x, w, b: seen.append(x.shape) or real(x, w, b))
        ev = finetune_50.main(COMMON + ["--method", "gnnnet", "--train_aug", "--save_iter", "0", "--use_pallas",
                                        "--test_dataset", "synthetic", "--n_query", "2", "--gen_examples", "1",
                                        "--fine_tune_epoch", "1", "--inner_param_dtype", "float32", "--iter_num",
                                        "1", "--paths_json", pj])
    assert len(ev.accs) == 1 and 0.0 <= ev.accs[0] <= 100.0
    assert seen and all(tuple(s[:2]) == (2, 130) for s in seen), seen  # one 130-node graph per query slot


def test_fifty_shot_wrappers_pin_their_defaults():
    from unittest import mock

    from mft_tpu_torch.cli import finetune, finetune_50, train, train_50

    with mock.patch.object(finetune, "main", side_effect=lambda argv: argv):
        assert finetune_50.main(["--method", "all"])[-2:] == ["--n_shot", "50"]
        assert finetune_50.main(["--n_shot", "20"]) == ["--n_shot", "20"]
    with mock.patch.object(train, "main", side_effect=lambda argv, **kw: argv):
        assert train_50.main([]) == ["--n_shot", "50", "--save_freq", "10"]
        assert train_50.main(["--save_freq", "1", "--n_shot", "60"]) == ["--save_freq", "1", "--n_shot", "60"]


def test_build_model_fifty_shot_head():
    from mft_tpu_torch.cli import train

    _, gcfg, params, _ = train.build_model(torch.Generator().manual_seed(0), "gnnnet", "ResNet10", 5, 50, 200)
    assert gcfg.support_compress == 2 and gcfg.eff_support == 25
    _, gcfg5, params5, _ = train.build_model(torch.Generator().manual_seed(0), "gnnnet", "ResNet10", 5, 5, 200)
    assert gcfg5.support_compress == 1
    # the head's tensors do not depend on the shot count
    a, b = torch.utils._pytree.tree_flatten(params), torch.utils._pytree.tree_flatten(params5)
    assert a[1] == b[1] and all(x.shape == y.shape for x, y in zip(a[0], b[0]))
