"""The eval's episode mesh (``mft_tpu_torch/parallel/mesh.py``,
``cli/finetune.py`` ``plan_eval_mesh``) on CPU devices:

* the driver on a mesh of two (and three) CPU devices, one worker process a
  shard, gives the scores and accuracies of one device, in episode order
  (rtol 1e-8 on the scores in f64; each shard runs the one-device loop's
  lane batch, so they are in fact equal), and reports its workers' kernel
  launches;
* ``plan_eval_mesh``'s global batch is ``--eval_batch`` times the width, and
  no card means no default mesh (the eval does not fall back to the CPU);
  ``--device cuda`` takes that default, ``cuda:<i>`` and the CPU run alone;
* a batch that would leave a device of the mesh without an episode is
  refused, and the driver never forms one;
* ``ShardPool`` answers in shard order, and a worker's failure or death
  raises in the caller;
* both episode streams load any episodes in any order as full iteration
  gives them (each mesh worker loads its own).
"""

import os
import sys

import numpy as np
import pytest
import torch

from mft_tpu_torch.cli import finetune
from mft_tpu_torch.parallel import mesh as pmesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke.write_checkpoints(torch, str(tmp_path_factory.mktemp("ckpts")))


def _run(pj, mesh_devices, iter_num=5, eval_batch=2):
    """The driver's result and its episodes' scores (f64, episode order)."""
    argv = ["--device", "cpu", "--method", "gnnnet", "--train_aug", "--save_iter", "600", "--use_pallas",
            "--inner_scan", "fused", "--test_dataset", "synthetic", "--image_size", "32", "--n_shot", "5", "--n_query",
            "3", "--gen_examples", "1", "--fine_tune_epoch", "1", "--iter_num", str(iter_num), "--eval_batch",
            str(eval_batch), "--dtype", "float32", "--inner_param_dtype", "float32", "--paths_json", pj]
    res = finetune.main(argv, mesh_devices=mesh_devices, keep_scores=True)
    return res, np.stack([s.double().numpy() for s in res.scores])


def test_mesh_equals_one_device_in_episode_order(ckpts, capsys):
    one, s1 = _run(ckpts, None)
    two, s2 = _run(ckpts, ["cpu", "cpu"])
    three, s3 = _run(ckpts, ["cpu"] * 3)
    # five episodes at two a device: batches of 2, 2, 1 on one device; 4 (two shards), 1 (one) on two;
    # 5 (shards of 2, 2, 1) on three
    assert len(one.batch_seconds) == 3 and len(two.batch_seconds) == 2 and len(three.batch_seconds) == 1
    assert two.accs == one.accs == three.accs and len(one.accs) == 5
    # the CPU runs the kernels' plain versions: the workers report their counts, none launched
    assert one.worker_launches == {} and two.worker_launches == three.worker_launches == {
        "edge_abs_diff_matmul": 0, "fused_inner_scan": 0}
    # each global batch's seconds of each shard in its worker
    assert one.shard_seconds == [] and [len(b) for b in two.shard_seconds] == [2, 1]
    assert [len(b) for b in three.shard_seconds] == [3] and all(t > 0 for b in two.shard_seconds for t in b)
    np.testing.assert_allclose(s2, s1, rtol=1e-8, atol=0)
    np.testing.assert_allclose(s3, s1, rtol=1e-8, atol=0)
    out = capsys.readouterr().out
    printed = [float(line) for line in out.splitlines() if line.replace(".", "", 1).isdigit()]
    assert printed[-5:] == one.accs  # the per-episode lines, in episode order


def test_plan_eval_mesh_global_batch(monkeypatch):
    mesh, batch = finetune.plan_eval_mesh(5, ["cpu", "cpu"])
    assert batch == 10 and mesh == (torch.device("cpu"),) * 2
    mesh, batch = finetune.plan_eval_mesh(3, ["cpu"])
    assert (len(mesh), batch) == (1, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        finetune.plan_eval_mesh(5)
    with pytest.raises(ValueError):
        pmesh.make_mesh([])


def test_default_mesh_spans_every_card_for_plain_cuda(monkeypatch):
    """``--device cuda`` spans every visible card (``make_mesh``'s default),
    ``cuda:<i>`` and the CPU run alone."""
    seen = []

    class Planned(Exception):
        pass

    def plan(eval_batch, devices=None):
        seen.append(devices)
        raise Planned

    monkeypatch.setattr(finetune, "plan_eval_mesh", plan)
    a = finetune.cfg_mod.parse_finetune_args([])
    for dev in (torch.device("cuda"), torch.device("cuda", 1), torch.device("cpu")):
        with pytest.raises(Planned):
            finetune.evaluate(a, {}, None, aug_cfg=None, bcfg=None, gcfg=None, spec=None, device=dev)
    assert seen == [None, [torch.device("cuda", 1)], [torch.device("cpu")]]


def test_empty_shard_is_refused():
    assert pmesh.episode_sharding(2, 10, 5) == [slice(0, 5), slice(5, 10)]
    assert pmesh.episode_sharding(2, 7, 5) == [slice(0, 5), slice(5, 7)]
    for n, per in ((5, 5), (4, 5), (0, 5), (11, 5)):
        with pytest.raises(ValueError, match="empty shard"):
            pmesh.episode_sharding(2, n, per)
    with pytest.raises(ValueError):
        pmesh.episode_sharding(2, 4, 0)


def _scale_init(device, payload):
    """A worker of the pool tests: answers ``(device, payload * x)``; a
    negative ``x`` raises, 99 ends the process."""
    if payload == "boom":
        raise KeyError("set-up failed")

    def step(x):
        if x < 0:
            raise ValueError(f"negative {x}")
        if x == 99:
            os._exit(3)
        return str(device), payload * x

    return step


def test_shard_pool_answers_in_shard_order():
    with pmesh.ShardPool(pmesh.make_mesh(["cpu", "cpu"]), _scale_init, [10, 100]) as pool:
        assert pool.map([(1,), (2,)]) == [("cpu", 10), ("cpu", 200)]  # each worker its own payload
        assert pool.map([(3,)]) == [("cpu", 30)]  # a short batch fills the first workers
        with pytest.raises(ValueError, match="3 messages for 2 workers"):
            pool.map([(1,), (2,), (3,)])
        with pytest.raises(ValueError, match="1 payloads for a mesh of 2"):
            pmesh.ShardPool(pmesh.make_mesh(["cpu", "cpu"]), _scale_init, [1])
        procs = list(pool._procs)
    assert not any(p.is_alive() for p in procs)  # leaving the pool stops its workers


def test_shard_pool_raises_on_failure_and_death():
    with pytest.raises(RuntimeError, match="KeyError: 'set-up failed'"):
        pmesh.ShardPool(pmesh.make_mesh(["cpu"]), _scale_init, ["boom"])
    with pmesh.ShardPool(pmesh.make_mesh(["cpu", "cpu"]), _scale_init, [1, 1]) as pool:
        with pytest.raises(RuntimeError, match="ValueError: negative -1"):
            pool.map([(5,), (-1,)])
        assert pool.map([(4,), (5,)]) == [("cpu", 4), ("cpu", 5)]  # a failed step leaves its worker serving
        with pytest.raises(RuntimeError, match="exited with code 3"):
            pool.map([(99,), (1,)])


def test_streams_load_any_episodes_in_any_order(tmp_path):
    """A mesh worker loads its own episodes: ``iterate(indices)`` gives the
    episodes that full iteration gives at those indices, bit for bit."""
    from PIL import Image

    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.data import registry
    from mft_tpu_torch.data.pipeline import EpisodeStream, ReplayEpisodeStream

    spec = EpisodeSpec(2, 1, 1)
    manifest = registry.build_manifest(registry.get("synthetic"), {"save_dir": str(tmp_path)}, split="novel")
    sampled = EpisodeStream(manifest, spec, 5, base_size=16, seed=3)
    rs = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rs.randint(0, 256, (20, 24, 3), dtype=np.uint8)).save(tmp_path / f"{i}.png")
    recorded = ReplayEpisodeStream([[[f"{e + w}.png", f"{e + w + 4}.png"] for w in range(2)] for e in range(3)],
                                   spec, base_size=16, root=str(tmp_path))
    for stream, picks in ((sampled, [4, 1, 1, 0]), (recorded, [2, 0])):
        full = [images for images, _ in stream]
        got = [images for images, _ in stream.iterate(picks)]
        assert len(got) == len(picks) and all(np.array_equal(g, full[i]) for g, i in zip(got, picks))
