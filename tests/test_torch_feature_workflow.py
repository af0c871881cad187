"""The feature/probe tools of the port (mft_tpu_torch/data/feature_store.py,
cli/save_features.py, cli/test.py) against the JAX package's
(mft_tpu/data/feature_store.py, mft_tpu/cli/{save_features,test}.py).

* The store: the ``.npz`` contract and the per-class dict, exactly; an
  episode stream under one Philox seed, bit for bit.
* ``make_probe_program``: E = 3 episodes as lanes against JAX's program on
  each episode with the same classifier init and minibatch order (JAX's
  draws replaced through its ``init_classifier`` and ``inner_fit``), f64:
  the query logits at rtol 1e-8 (100 epochs of the reference's SGD on a
  linear head), the ProtoNet scores at rtol 1e-12, the accuracies at rtol
  1e-6 (JAX's ``episode_accuracy`` takes the mean in f32).
* The drivers on the CPU at 32 px: ``cli.save_features`` on a checkpoint
  both packages read (the port's ``.tar``, JAX's ``.ckpt`` of the same
  weights) writes JAX's features within 1e-5 of their largest value (f32,
  the same eval-mode ResNet10 in another summation order) and labels
  exactly; ``cli.test`` with and without ``--adaptation`` reads them.
"""

import json
import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mft_tpu.cli.test as jtest
from mft_tpu.core.episode import EpisodeSpec as JSpec
from mft_tpu.data import feature_store as jfs
from mft_tpu.models import backbone as jbb
from mft_tpu.train import inner_loop as jil
from mft_tpu_torch import convert
from mft_tpu_torch.cli import test as ttest
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.data import feature_store as tfs
from mft_tpu_torch.train import inner_loop as til

SPEC = (3, 5, 4)
FEAT = 16
LANES = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_store_round_trip_matches_jax(tmp_path):
    """The port writes what JAX writes and reads either file into the same
    per-class dict."""
    rs = np.random.RandomState(0)
    feats = rs.randn(30, 8).astype(np.float32)
    labels = np.repeat(np.arange(3), 10)[rs.permutation(30)]
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tfs.save_features(ours, feats, labels)
    jfs.save_features(theirs, feats, labels)
    for path in (ours, theirs):
        d, want = tfs.load_features(path), jfs.load_features(path)
        assert sorted(d) == sorted(want) == [0, 1, 2]
        for c in d:
            np.testing.assert_array_equal(d[c], want[c])
            np.testing.assert_array_equal(d[c], feats[labels == c])
    raw = np.load(ours)
    assert int(raw["count"]) == 30 and set(raw.files) == {"all_feats", "all_labels", "count"}


def test_sample_feature_episode_matches_jax():
    """Ten episodes from one Philox stream (a class with too few rows draws
    with replacement): the same episodes and classes, bit for bit."""
    cl = {c: np.random.RandomState(c).randn(6 + c, 4).astype(np.float32) for c in range(6)}
    ours, theirs = np.random.Generator(np.random.Philox(key=3)), np.random.Generator(np.random.Philox(key=3))
    for _ in range(10):
        ep, classes = tfs.sample_feature_episode(cl, 4, 2, 5, ours)
        want, want_classes = jfs.sample_feature_episode(cl, 4, 2, 5, theirs)
        assert ep.shape == (4, 7, 4)
        np.testing.assert_array_equal(ep, want)
        np.testing.assert_array_equal(classes, want_classes)


def _episodes():
    rs = np.random.RandomState(1)
    w, s, q = SPEC
    centers = rs.randn(LANES, w, 1, FEAT)
    return centers + rs.randn(LANES, w, s + q, FEAT) * 0.8


def test_probe_program_without_adaptation_matches_jax():
    feats = _episodes()
    with jax.enable_x64():
        want = np.asarray(jtest.make_probe_program(JSpec(*SPEC), FEAT, False)(jnp.asarray(feats),
                                                                                jax.random.split(jax.random.PRNGKey(0), 3)))
    program = ttest.make_probe_program(EpisodeSpec(*SPEC), FEAT, False)
    got = program(torch.from_numpy(feats), [None] * LANES)
    np.testing.assert_allclose(got, want, rtol=1e-6)  # JAX takes the mean in f32
    # the scores themselves: JAX's episode_accuracy replaced by the identity on its scores
    with jax.enable_x64(), mock.patch.object(jtest, "episode_accuracy", lambda scores, spec: scores):
        scores = np.asarray(jtest.make_probe_program(JSpec(*SPEC), FEAT, False)(
            jnp.asarray(feats), jax.random.split(jax.random.PRNGKey(0), 3)))
    with mock.patch.object(ttest, "lane_accuracies", lambda scores, spec: scores):
        ours = program(torch.from_numpy(feats), [None] * LANES).numpy()
    np.testing.assert_allclose(ours, scores, rtol=1e-12, atol=1e-12)


def test_probe_program_with_adaptation_matches_jax():
    """The linear probe on three lanes against JAX's program on each
    episode with that lane's explicit head and schedule, f64."""
    feats = _episodes()
    spec = EpisodeSpec(*SPEC)
    rs = np.random.RandomState(2)
    icfg = til.InnerLoopCfg(epochs=100, batch_size=4, bank_size=spec.support_size)
    perms = [np.stack([rs.permutation(spec.support_size) for _ in range(100)]) for _ in range(LANES)]
    heads = [{"w": rs.randn(FEAT, 3) * 0.2, "b": rs.randn(3) * 0.1} for _ in range(LANES)]  # JAX layout
    real_fit = jtest.inner_fit
    want_logits, want_accs = [], []
    for i in range(LANES):
        jsched = jil.schedule_from_perms(perms[i], jil.InnerLoopCfg(100, 4, spec.support_size))
        with jax.enable_x64(), \
                mock.patch.object(jtest, "init_classifier", lambda *a, i=i, **k: jax.tree.map(jnp.asarray, heads[i])), \
                mock.patch.object(jtest, "inner_fit", lambda f, p, tx, k, c, s=jsched: real_fit(f, p, tx, k, c,
                                                                                                schedule=s)):
            one = jnp.asarray(feats[i : i + 1])
            keys = jax.random.split(jax.random.PRNGKey(0), 1)
            want_accs.append(float(jtest.make_probe_program(JSpec(*SPEC), FEAT, True)(one, keys)[0]))
            with mock.patch.object(jtest, "episode_accuracy", lambda logits, spec: logits):
                want_logits.append(np.asarray(jtest.make_probe_program(JSpec(*SPEC), FEAT, True)(one, keys)[0]))
    program = ttest.make_probe_program(spec, FEAT, True)
    head0 = {"w": torch.from_numpy(np.stack([h["w"].T for h in heads])),
             "b": torch.from_numpy(np.stack([h["b"] for h in heads]))}
    sched = til.stack_schedules([til.schedule_from_perms(p, icfg) for p in perms])
    accs = program(torch.from_numpy(feats), [None] * LANES, head0=head0, schedule=sched)
    np.testing.assert_allclose(accs, want_accs, rtol=1e-6)  # JAX takes the mean in f32
    with mock.patch.object(ttest, "lane_accuracies", lambda logits, spec: logits):
        logits = program(torch.from_numpy(feats), [None] * LANES, head0=head0, schedule=sched).numpy()
    np.testing.assert_allclose(logits, np.stack(want_logits), rtol=1e-8, atol=1e-10)
    # with generators: each lane draws its head, then its order, as that lane alone would
    gens = lambda: [torch.Generator().manual_seed(7 + i) for i in range(LANES)]
    lanes = program(torch.from_numpy(feats), gens())
    alone = [program(torch.from_numpy(feats[i : i + 1]), gens()[i : i + 1])[0] for i in range(LANES)]
    assert lanes == alone and min(lanes) > 90.0


def test_save_features_then_test_end_to_end(tmp_path, monkeypatch, capsys):
    """One ResNet10 baseline checkpoint in both packages' formats; both
    drivers' ``save_features`` on the synthetic novel split (480 images,
    eight batches of 64, the last zero-padded), then the port's ``test``
    with and without ``--adaptation`` on the port's features."""
    from mft_tpu.cli import save_features as jsf
    from mft_tpu.utils import checkpoint as jckpt
    from mft_tpu_torch.cli import save_features as tsf

    cfg = jbb.resnet10()
    p, s = jax.jit(lambda k: jbb.init_backbone(k, cfg))(jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    perturb = lambda a: np.asarray(a) + (rs.rand(*np.shape(a)).astype(np.float32) * 0.2 if np.ndim(a) == 1 else 0)
    p, s = jax.tree.map(perturb, p), jax.tree.map(perturb, s)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    rel = os.path.join("checkpoints", "synthetic", "ResNet10_baseline")
    jckpt.save_checkpoint(str(jdir / rel), 0, {"epoch": 0, "params": {"feature": p}, "stats": s})
    tp, ts = convert.from_jax(p, s)
    os.makedirs(tdir / rel)
    convert.save_tar(str(tdir / rel / "0.tar"), 0, convert.to_state_dict({"feature": tp}, ts))
    common = ["--dataset", "synthetic", "--model", "ResNet10", "--method", "baseline", "--image_size", "32",
              "--save_iter", "0", "--split", "novel"]
    monkeypatch.setenv("MFT_SAVE_DIR_PATH", str(jdir))
    jsf.main(common)
    monkeypatch.setenv("MFT_SAVE_DIR_PATH", str(tdir))
    res = tsf.main(common + ["--device", "cpu"])
    assert res.n_images == 480 and res.path == str(tdir / "features" / "synthetic" / "ResNet10_baseline" / "novel.npz")
    got, want = np.load(res.path), np.load(jdir / "features" / "synthetic" / "ResNet10_baseline" / "novel.npz")
    assert got["all_feats"].shape == (480, 512) and got["all_feats"].dtype == np.float32
    np.testing.assert_array_equal(got["all_labels"], want["all_labels"])
    scale = float(np.abs(want["all_feats"]).max())
    np.testing.assert_allclose(got["all_feats"], want["all_feats"], rtol=0, atol=1e-5 * scale)
    test_args = ["--device", "cpu", "--dataset", "synthetic", "--method", "baseline", "--n_shot", "2",
                 "--iter_num", "5", "--eval_batch", "2"]
    capsys.readouterr()
    for extra in ([], ["--adaptation"]):
        out = ttest.main(test_args + extra)
        assert len(out.accs) == 5 and all(0.0 <= v <= 100.0 for v in out.accs) and len(out.batch_seconds) == 3
    assert capsys.readouterr().out.count("5 Test Acc = ") == 2
    monkeypatch.delenv("MFT_SAVE_DIR_PATH")
    with open(tmp_path / "paths.json", "w") as f:
        json.dump({"save_dir": str(tmp_path / "nowhere")}, f)
    with pytest.raises(FileNotFoundError):
        tsf.main(common + ["--device", "cpu", "--paths_json", str(tmp_path / "paths.json")])


@pytest.mark.parametrize("script", ["save_features", "test"])
def test_flags_match_jax(script):
    """Every flag of the port's feature drivers but ``--device`` is one of
    the JAX driver's, with its default."""
    from mft_tpu import config as jcfg
    from mft_tpu_torch import config as tcfg

    j = vars(jcfg.parse_args(script, []))
    t = vars(tcfg.parse_features_args(script, []))
    assert set(t) - set(j) == {"device"} and ("adaptation" in t) == (script == "test")
    assert {k: v for k, v in t.items() if k != "device"} == {k: j[k] for k in t if k != "device"}
