"""The port's training driver (mft_tpu_torch/cli/train.py) end to end on the
CPU at 32 px, its checkpoints (utils/checkpoint.py), its log
(utils/metrics.py) and its input streams (data/pipeline.py), against the
JAX package's where both exist.

The three stages are chained as the eval finds them: baseline at epoch
400, episodic GnnNet with ``--train_aug --use_pallas`` at 599, then
``--fine_tune`` resumed from 599 to 600 (the eval's ``--method all`` reads
baseline@latest and gnnnet_aug@600).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from mft_tpu import config as jcfg
from mft_tpu.core.episode import EpisodeSpec as JSpec
from mft_tpu.data import manifests as jmf
from mft_tpu.data import pipeline as jpipe
from mft_tpu_torch import config as tcfg
from mft_tpu_torch.convert import load_tar
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.data import manifests as tmf
from mft_tpu_torch.data import pipeline as tpipe
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.utils import checkpoint as ckpt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

COMMON = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "32"]
GNN = COMMON + ["--method", "gnnnet", "--train_aug", "--use_pallas", "--episodes_per_epoch", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores, and
    more threads than cores slow every worker's small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    from mft_tpu_torch.cli import train

    root = str(tmp_path_factory.mktemp("train_save"))
    pj = os.path.join(root, "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": root}, f)
    out = {"root": root, "pj": pj}
    # 480 synthetic images at batch 240: two batches
    out["baseline"] = train.main(COMMON + ["--method", "baseline", "--batch_size", "240", "--start_epoch", "400",
                                           "--stop_epoch", "400", "--paths_json", pj])
    out["episodic"] = train.main(GNN + ["--start_epoch", "599", "--stop_epoch", "599", "--paths_json", pj])
    out["fine_tune"] = train.main(GNN + ["--fine_tune", "--start_epoch", "600", "--stop_epoch", "600",
                                         "--paths_json", pj])
    return out


def test_three_stages_write_what_the_eval_reads(stages):
    base, epi, ft = stages["baseline"], stages["episodic"], stages["fine_tune"]
    for res in (base, epi, ft):
        assert len(res.losses) == 2 and all(np.isfinite(res.losses)) and len(res.seconds) == 2
    assert sorted(os.listdir(base.ckpt_dir)) == ["400.tar", "train_log.jsonl"]
    assert epi.ckpt_dir == ft.ckpt_dir and epi.ckpt_dir.endswith("ResNet10_gnnnet_aug_5way_5shot")
    assert sorted(os.listdir(ft.ckpt_dir)) == ["599.tar", "600.tar", "train_log.jsonl"]
    epoch, sd = load_tar(os.path.join(ft.ckpt_dir, "600.tar"))
    assert epoch == 600 and "gnn.layer_w0.conv2d_1.weight" in sd and "feature.trunk.0.weight" in sd
    epoch, sd = load_tar(os.path.join(base.ckpt_dir, "400.tar"))
    assert epoch == 400 and sd["classifier.weight"].shape == (200, 512)


def test_eval_reads_the_trained_checkpoints(stages):
    """``--method all``'s loader finds baseline@latest (400) and
    gnnnet_aug@600 and maps every tensor (``from_state_dict`` is strict);
    tests/test_torch_cli.py runs the eval on such files."""
    from mft_tpu_torch.cli import finetune

    a = tcfg.parse_finetune_args(["--device", "cpu", "--method", "all", "--dataset", "synthetic",
                                  "--paths_json", stages["pj"]])
    models = finetune.build_models(a, tcfg.Paths.load(stages["pj"]), tbb.resnet10(), torch.device("cpu"))
    assert set(models) == {"baseline", "gnn"}
    feat, stats, head = models["gnn"]
    _, sd = load_tar(os.path.join(stages["fine_tune"].ckpt_dir, "600.tar"))
    assert torch.equal(feat["stem_conv"], sd["feature.trunk.0.weight"])
    assert torch.equal(head["gnn"]["w_last"]["conv_last"]["b"], sd["gnn.w_comp_last.conv2d_last.bias"])
    _, sd = load_tar(os.path.join(stages["baseline"].ckpt_dir, "400.tar"))
    assert torch.equal(models["baseline"][1]["stem_bn"]["var"], sd["feature.trunk.1.running_var"])


def test_resume_carries_adam_state(stages, tmp_path):
    """599.tar holds the Adam state after the episodic stage's two steps;
    the fine-tune stage resumed it (four steps at 600.tar); a resume reads
    back exactly what was saved."""
    from mft_tpu_torch.cli import train

    d = stages["fine_tune"].ckpt_dir
    bcfg, _, params, _ = train.build_model(torch.Generator().manual_seed(0), "gnnnet", "ResNet10", 5, 5, 200)
    template = train.opt.torch_adam(1e-3).init(params)
    e599, p599, s599, o599 = ckpt.load_checkpoint(os.path.join(d, "599.tar"), bcfg, template)
    e600, _, _, o600 = ckpt.load_checkpoint(os.path.join(d, "600.tar"), bcfg, template)
    assert (e599, o599["t"], e600, o600["t"]) == (599, 2, 600, 4)
    assert any(float(v.abs().max()) > 0 for v in ckpt.keyed(o599["mu"]).values())
    path = ckpt.save_checkpoint(str(tmp_path), 7, p599, s599, o599)
    e, p, s, o = ckpt.load_checkpoint(path, bcfg, template)
    assert e == 7 and o["t"] == 2
    for want, got in ((p599, p), (s599, s), (o599["mu"], o["mu"]), (o599["nu"], o["nu"])):
        w, g = ckpt.keyed(want), ckpt.keyed(got)
        assert sorted(w) == sorted(g) and all(torch.equal(w[k], g[k]) for k in w)
    # a file without Adam state (as the reference writes it) resumes with a fresh one
    blob = torch.load(path, weights_only=True)
    del blob["adam"]
    torch.save(blob, path)
    assert ckpt.load_checkpoint(path, bcfg, template)[3] is template
    assert ckpt.get_resume_file(d) == os.path.join(d, "600.tar") == ckpt.get_best_file(d)
    assert ckpt.get_resume_file(str(tmp_path / "none")) is None


def test_log_records_read_by_the_reference_tool(stages):
    """``parse_losses`` of tools/run_reference_train_e2e.py inverts the
    logged running averages back to each step's loss."""
    import run_reference_train_e2e as rte

    for stage, epoch in (("baseline", 400), ("fine_tune", 600)):
        res = stages[stage]
        got = rte.parse_losses(os.path.join(res.ckpt_dir, "train_log.jsonl"), epoch, epoch, 2)
        np.testing.assert_allclose(got, res.losses, rtol=1e-12)


def test_protonet_stages_both_bn_modes(tmp_path):
    from mft_tpu_torch.cli import train

    pj = str(tmp_path / "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": str(tmp_path)}, f)
    proto = COMMON + ["--method", "protonet", "--episodes_per_epoch", "2", "--n_shot", "2", "--n_query", "3",
                      "--paths_json", pj]
    first = train.main(proto + ["--stop_epoch", "0"])
    for mode, epoch in (("episode", "1"), ("minibatch", "2")):
        res = train.main(proto + ["--fine_tune", "--bn_mode", mode, "--start_epoch", epoch, "--stop_epoch", epoch])
        assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert sorted(os.listdir(first.ckpt_dir)) == ["0.tar", "1.tar", "2.tar", "train_log.jsonl"]
    _, sd = load_tar(os.path.join(first.ckpt_dir, "2.tar"))
    assert all(k.startswith("feature.") for k in sd)


def test_refusals(tmp_path):
    from unittest import mock

    from mft_tpu_torch.cli import train
    from mft_tpu_torch.methods import dampnet as tdn

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main(["--dataset", "synthetic"])
    # DampNet trains since it was ported (recovery widths cut to keep the file small)
    pj = str(tmp_path / "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": str(tmp_path)}, f)
    real = tdn.method_cfg
    tiny = lambda *a: real(*a)._replace(ntn_dim=8, mlp_hidden=16)
    with mock.patch.object(tdn, "method_cfg", tiny):
        res = train.main(COMMON + ["--method", "dampnet_full_class", "--n_shot", "2", "--n_query", "2",
                                   "--episodes_per_epoch", "1", "--stop_epoch", "0", "--paths_json", pj])
    assert len(res.losses) == 1 and np.isfinite(res.losses[0])
    with pytest.raises(NotImplementedError, match="item 18"):
        train.main(COMMON + ["--model", "ResNet10_FW"])
    for flag in (["--eval_batch", "2"], ["--trace_dir", "x"], ["--unsupervised", "x"]):  # eval-only flags
        with pytest.raises(SystemExit):
            train.main(COMMON + flag)
    # the JAX training driver reads --episode_cache (mft_tpu/cli/train.py:250,298), and so does the port's
    assert tcfg.parse_train_args(["--episode_cache", "x"]).episode_cache == "x"


def test_train_flag_defaults_match_jax():
    j = vars(jcfg.parse_args("train", []))
    t = vars(tcfg.parse_train_args([]))
    shared = set(j) & set(t)
    assert len(shared) == len(t) - 1 and "device" not in shared
    assert {k: t[k] for k in shared} == {k: j[k] for k in shared}


@pytest.mark.parametrize("batch,n_batches", [(16, 3), (7, 20), (50, 2)])
def test_batch_stream_matches_jax(batch, n_batches):
    """Same Philox permutations, same batches, across passes and on a
    dataset smaller than the batch."""
    jm, tm = jmf.synthetic(n_classes=3, per_class=10, base_size=24), tmf.synthetic(n_classes=3, per_class=10,
                                                                                     base_size=24)
    js = jpipe.BatchStream(jm, batch, n_batches, base_size=24, seed=3, workers=2)
    ts = tpipe.BatchStream(tm, batch, n_batches, base_size=24, seed=3)
    got, want = list(ts), list(js)
    assert len(got) == len(want) == n_batches
    for (tx, ty), (jx, jy) in zip(got, want):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_replay_streams_match_jax(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(0)
    paths = []
    for i in range(12):
        p = f"c{i % 3}/{i}.png"
        os.makedirs(tmp_path / f"c{i % 3}", exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (20, 20, 3), dtype=np.uint8)).save(tmp_path / p)
        paths.append(p)
    labels = {p: i % 3 for i, p in enumerate(paths)}
    batches = [paths[:4], paths[4:8]]
    got = list(tpipe.ReplayBatchStream(batches, labels, base_size=16, root=str(tmp_path)))
    want = list(jpipe.ReplayBatchStream(batches, labels, base_size=16, root=str(tmp_path), workers=2))
    for (tx, ty), (jx, jy) in zip(got, want):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    with pytest.raises(ValueError, match="ragged replay batches"):
        tpipe.ReplayBatchStream([paths[:4], paths[4:7]], labels)
    eps = [[paths[0:3], paths[3:6]], [paths[6:9], paths[9:12]]]
    got = list(tpipe.ReplayEpisodeStream(eps, EpisodeSpec(2, 1, 2), base_size=16, root=str(tmp_path)))
    want = list(jpipe.ReplayEpisodeStream(eps, JSpec(2, 1, 2), base_size=16, root=str(tmp_path), workers=2))
    assert len(got) == 2
    for (ti, _), (ji, _) in zip(got, want):
        assert ti.shape == (2, 3, 16, 16, 3)
        np.testing.assert_array_equal(ti, ji)
    with pytest.raises(ValueError, match="manifest shape"):
        tpipe.ReplayEpisodeStream(eps, EpisodeSpec(2, 2, 2))
