"""The eval's episode mesh under every method and driver flag: two CPU
shards (two worker processes) against one device, the scores equal (rtol
1e-8 as the floor; each shard runs the one-device loop's lane batches, so
they are equal in fact) and the accuracies the same, in episode order.

Cases: ``--method dampnet_full_class`` (the live composition,
``--dampnet_eval nofinetune`` and ``--unsupervised synthetic``), ``--method
protonet`` in both BN modes, ``--method all --bn_mode minibatch`` at
``--eval_batch 2`` (two lanes on each shard), ``cli.finetune_50``,
``--freeze_backbone``, ``--episode_manifest`` and ``--episode_cache``.

32 px, strict f32, 5-way 1-shot 2-query episodes (50-shot for
``cli.finetune_50``, with no inner epoch and no augmented group: its bank,
embedding and 130-node graphs through the mesh), one augmented replica
group and one inner epoch, two
episodes a case (four for the two-lane case), with the seeded baseline and
50-shot checkpoints of ``chip_smoke.write_checkpoints``, seeded 1-shot
GnnNet and ProtoNet ones, and a DampNet checkpoint of tiny recovery heads
(NTN width 8, MLP width 16, the tests/test_torch_dampnet_cli.py widths,
patched into ``methods.dampnet.method_cfg``): the full-size heads hold
159-266 M weights.
"""

import glob

import json
import os
import sys
import unittest.mock as mock

import numpy as np
import pytest
import torch

from mft_tpu_torch import config as cfg_mod
from mft_tpu_torch import convert
from mft_tpu_torch.cli import finetune, finetune_50
from mft_tpu_torch.methods import dampnet as tdn
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.models import backbone as tbb

METHOD_CFG = tdn.method_cfg
SMALL = ["--device", "cpu", "--test_dataset", "synthetic", "--image_size", "32", "--n_query", "2", "--gen_examples",
         "1", "--fine_tune_epoch", "1", "--dtype", "float32", "--inner_param_dtype", "float32"]
ONE_SHOT = ["--n_shot", "1"]
DAMP = ["--method", "dampnet_full_class", "--dataset", "synthetic", "--save_iter", "0", "--sweep_images", "32",
        "--inner_scan", "fused"] + ONE_SHOT
PROTO = ["--method", "protonet", "--save_iter", "400"] + ONE_SHOT
GNN = ["--method", "gnnnet", "--train_aug", "--save_iter", "600", "--use_pallas", "--inner_scan", "fused"]
#: case -> (driver, flags, episodes (None: the manifest's), --eval_batch)
CASES = {
    "dampnet_live": (finetune, DAMP, 2, 1),
    "dampnet_nofinetune": (finetune, DAMP + ["--dampnet_eval", "nofinetune"], 2, 1),
    "dampnet_unsupervised": (finetune, DAMP + ["--unsupervised", "synthetic"], 2, 1),
    "protonet": (finetune, PROTO + ["--inner_scan", "fused"], 2, 1),
    "protonet_minibatch": (finetune, PROTO + ["--bn_mode", "minibatch"], 2, 1),
    "all_minibatch_lanes": (finetune, ["--method", "all", "--use_pallas", "--bn_mode", "minibatch"] + ONE_SHOT, 4, 2),
    # no inner epoch: the plain scan's 150 steps a 50-shot episode take some 12 s on one CPU thread
    "finetune_50": (finetune_50, GNN + ["--gen_examples", "0", "--fine_tune_epoch", "0"], 2, 1),
    "freeze_backbone": (finetune, GNN + ["--freeze_backbone"] + ONE_SHOT, 2, 1),
    "episode_manifest": (finetune, GNN + ONE_SHOT, None, 1),
    "episode_cache": (finetune, GNN + ONE_SHOT, 2, 1),
}


def _tiny_method_cfg(method, feat_dim, n_way, n_support):
    return METHOD_CFG(method, feat_dim, n_way, n_support)._replace(ntn_dim=8, mlp_hidden=16, mlp_hidden2=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_tiny_heads():
    """One intra-op thread (the suite's workers share the host's cores; the
    mesh's workers take the parent's count), and the tiny DampNet heads (the
    program's ``dcfg`` reaches the workers with the program)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with mock.patch.object(tdn, "method_cfg", _tiny_method_cfg):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The seeded checkpoints (baseline@400, the 50-shot GnnNet@600), 1-shot
    GnnNet@600 and ProtoNet@400 ones, a ``dampnet_full_class`` 1-shot
    checkpoint (epoch 0, ``--dataset synthetic``; no prototypes, so the
    driver sweeps them), and a recorded-episode manifest of PNGs."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from PIL import Image

    root = tmp_path_factory.mktemp("mesh_methods")
    pj = chip_smoke.write_checkpoints(torch, str(root))
    paths = cfg_mod.Paths(save_dir=str(root))
    g = torch.Generator().manual_seed(5)
    bcfg = tbb.resnet10()

    def save(dataset, method, epoch, train_aug, **heads):
        p, s = tbb.init_backbone(g, bcfg)
        d = cfg_mod.checkpoint_dir(paths, dataset, "ResNet10", method, train_aug=train_aug, n_way=5, n_shot=1)
        os.makedirs(d)
        convert.save_tar(os.path.join(d, f"{epoch}.tar"), epoch, convert.to_state_dict({"feature": p, **heads}, s))

    save("miniImageNet", "gnnnet", 600, True, **tgn.init_head(g, tgn.GnnNetCfg(n_support=1)))
    save("miniImageNet", "protonet", 400, False)
    dp, _ = tdn.init_dampnet(g, _tiny_method_cfg("dampnet_full_class", bcfg.feat_dim, 5, 1))
    save("synthetic", "dampnet_full_class", 0, False, **dp)
    images = root / "images"
    images.mkdir()
    rs = np.random.RandomState(0)
    for i in range(15):
        Image.fromarray(rs.randint(0, 256, (40, 44, 3), dtype=np.uint8)).save(images / f"{i}.png")
    episodes = [[[f"{(w * 3 + k + 7 * e) % 15}.png" for k in range(3)] for w in range(5)] for e in range(2)]
    manifest = str(root / "episodes.json")
    with open(manifest, "w") as f:
        json.dump({"episodes": episodes}, f)
    return {"pj": pj, "manifest": manifest, "images": str(images), "cache": str(root / "cache")}


def _run(driver, argv, mesh_devices):
    res = driver.main(argv, mesh_devices=mesh_devices, keep_scores=True)
    return res, np.stack([s.double().numpy() for s in res.scores])


@pytest.mark.parametrize("case", list(CASES))
def test_two_shards_equal_one_device(ckpts, case):
    driver, flags, iter_num, eval_batch = CASES[case]
    argv = SMALL + flags + ["--eval_batch", str(eval_batch), "--paths_json", ckpts["pj"]]
    if iter_num is not None:
        argv += ["--iter_num", str(iter_num)]
    if case == "episode_manifest":
        argv += ["--episode_manifest", ckpts["manifest"], "--episode_manifest_root", ckpts["images"]]
    if case == "episode_cache":
        argv += ["--episode_cache", ckpts["cache"]]
    one, s1 = _run(driver, argv, None)
    two, s2 = _run(driver, argv, ["cpu", "cpu"])
    episodes = iter_num or 2
    assert len(one.accs) == episodes and two.accs == one.accs
    assert len(two.batch_seconds) == episodes // (2 * eval_batch) and len(one.batch_seconds) == episodes // eval_batch
    assert two.worker_launches == {"edge_abs_diff_matmul": 0, "fused_inner_scan": 0}  # plain versions on the CPU
    assert s1.shape == (episodes, 10, 5) and np.isfinite(s1).all()
    np.testing.assert_allclose(s2, s1, rtol=1e-8, atol=0)
    if case == "all_minibatch_lanes":  # two lanes a batch: the episodes differ, so no lane copied another
        assert not np.allclose(s1[0], s1[1], atol=1e-6)
    if case == "episode_cache":
        assert len(glob.glob(os.path.join(ckpts["cache"], "**", "*.npy"), recursive=True)) >= episodes
