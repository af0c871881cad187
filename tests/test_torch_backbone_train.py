"""Training steps on the other backbones (mft_tpu_torch/train/steps.py with
ResNet10_FW and ResNet18) against the JAX package's, f64, on one starting
state carried across (``convert.from_jax``) and the same numpy inputs; and
the training driver on ResNet10_FW (frozen noise strengths, the masked Adam
state through a checkpoint and a resume).

Tolerances, as tests/test_torch_train_steps.py: loss rtol 1e-10; every
gradient, updated parameter and Adam moment rtol 1e-8 (atol 1e-10 of each
tensor's largest); stats rtol 1e-9.  The meta fine-tune (15 inner Adam
steps): loss 1e-8, parameters 1e-6.  The FWT noise of the episodic step is
JAX's own draws, split per episode (steps.py:108) and per block, fed to the
port.  The noise strengths (``fwt_*``) must come out of every step bit for
bit as they went in.

Narrow widths (64, 12, 14, 16), so the first block keeps the stem's 64
channels and has no shortcut, as ResNet10_FW's; ResNet18's stage sizes
(2, 2, 2, 2) at the same widths; 32 px.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.core.episode import EpisodeSpec as JSpec
from mft_tpu.methods import gnnnet as jgn
from mft_tpu.methods.baseline import init_classifier as j_init_classifier
from mft_tpu.models import backbone as jbb
from mft_tpu.train import inner_loop as jil
from mft_tpu.train import optimizers as jopt
from mft_tpu.train import steps as jsteps
from mft_tpu_torch import convert
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.train import inner_loop as til
from mft_tpu_torch.train import optimizers as topt
from mft_tpu_torch.train import steps as tsteps
from mft_tpu_torch.utils.checkpoint import keyed
from tests.test_golden_reference import _assert_tree_close
from tests.test_torch_backbone_zoo import jax_fwt_draws

WIDTHS = (64, 12, 14, 16)
JFW = jbb.ResNetCfg((1, 1, 1, 1), WIDTHS, "fwt", flatten=True)
TFW = tbb.ResNetCfg((1, 1, 1, 1), WIDTHS, block="fwt")
J18 = jbb.ResNetCfg((2, 2, 2, 2), WIDTHS, "simple", flatten=True)
T18 = tbb.ResNetCfg((2, 2, 2, 2), WIDTHS)
GKW = dict(feat_dim=16, n_way=3, n_support=2, proj_dim=16, gnn_nf=8)
SPEC = (3, 2, 3)
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _model(jcfg, head: str, seed: int = 0):
    """JAX trees in f64 numpy, every 1-D leaf perturbed (the FWT strengths
    too, so softplus100 runs off its init point)."""
    kb, kh = jax.random.split(jax.random.PRNGKey(seed))
    p, s = jax.jit(lambda k: jbb.init_backbone(k, jcfg))(kb)
    rs = np.random.RandomState(seed)
    perturb = lambda a: np.asarray(a, np.float64) + (rs.rand(*np.shape(a)) * 0.2 if np.ndim(a) == 1 else 0.0)
    params = {"feature": jax.tree.map(perturb, p)}
    if head == "classifier":
        params["classifier"] = _f64(j_init_classifier(kh, 16, 10))
    else:
        params.update(_f64(jax.jit(lambda k: jgn.init_head(k, jgn.GnnNetCfg(**GKW)))(kh)))
    return params, jax.tree.map(perturb, s)


def _episodes(e: int, seed: int):
    w, s, q = SPEC
    x = np.random.RandomState(seed).rand(e, w, s + q, SIZE, SIZE, 3)
    return x, torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 1, 2, 5, 3, 4))))


def _fwt_leaves(tree) -> dict:
    return {k: v for k, v in keyed(tree).items() if "fwt_" in k}


def _check(got, want, *, loss_rtol=1e-10, rtol=1e-8, stats_rtol=1e-9):
    tp, ts, to, tm = got
    jp, js, jo, jm = want
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=loss_rtol)
    got_p, got_s = convert.to_jax(tp, ts)
    _assert_tree_close(got_p, _np(jp), rtol=rtol, atol_frac=1e-10, label="params")
    _assert_tree_close(got_s, _np(js), rtol=stats_rtol, atol_frac=1e-12, label="stats")
    moments = convert.adam_from_jax(jo)
    assert moments["t"] == to["t"]
    for k in ("mu", "nu"):
        a, b = keyed(to[k]), keyed(moments[k])
        assert set(a) == set(b) and not any("fwt_" in path for path in a)
        _assert_tree_close({p: v.numpy() for p, v in a.items()}, {p: v.numpy() for p, v in b.items()}, rtol=rtol,
                           atol_frac=1e-10, label=k)


def test_fwt_episodic_step_matches_jax():
    """Two episodes, each with its own noise on every block: loss, every
    gradient (the noise strengths' too, which the noise makes nonzero), the
    update through ``freeze_masked``, stats and the masked Adam state."""
    params, stats = _model(JFW, "gnn")
    xj, xt = _episodes(2, 11)
    rng = jax.random.PRNGKey(3)
    jg, tg = jgn.GnnNetCfg(**GKW), tgn.GnnNetCfg(**GKW)
    jspec, tspec = JSpec(*SPEC), EpisodeSpec(*SPEC)
    with jax.enable_x64():
        p, s = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
        tx = jopt.freeze_masked(jopt.torch_adam(1e-3), jbb.fwt_trainable_mask(p))
        rngs = jax.random.split(rng, 2)

        def batch_loss(p):
            return jnp.mean(jnp.stack([jsteps._episode_loss(p, s, jnp.asarray(xj[i]), method="gnnnet", bcfg=JFW,
                                                            gcfg=jg, spec=jspec, rng=rngs[i])[0] for i in range(2)]))

        jgrads = _np(jax.jit(jax.grad(batch_loss))(p))
        want = _np(jsteps.episodic_train_step(p, s, tx.init(p), jnp.asarray(xj), rng, method="gnnnet", bcfg=JFW,
                                              gcfg=jg, spec=jspec, tx=tx))
    noise = [jax_fwt_draws(r, JFW) for r in rngs]
    tp, ts = convert.from_jax(params, stats)
    loss, _, grads = tsteps._value_and_grad(
        lambda q: (torch.stack([tsteps._episode_loss(q, ts, xt[i], method="gnnnet", bcfg=TFW, gcfg=tg, spec=tspec,
                                                     fwt_noise=noise[i])[0] for i in range(2)]).mean(), None), tp)
    _assert_tree_close(convert.to_jax(grads)[0], jgrads, rtol=1e-8, atol_frac=1e-10, label="grads")
    assert all(float(v.abs().max()) > 0 for v in _fwt_leaves(grads).values())
    ttx = topt.freeze_masked(topt.torch_adam(1e-3), tbb.fwt_trainable_mask(tp))
    got = tsteps.episodic_train_step(tp, ts, ttx.init(tp), xt, method="gnnnet", bcfg=TFW, gcfg=tg, spec=tspec, tx=ttx,
                                     fwt_noise=noise)
    _check(got, want)
    before, after = _fwt_leaves(tp), _fwt_leaves(got[0])
    assert len(before) == 14 and all(torch.equal(after[k], v) for k, v in before.items())
    # a generator draws each episode's noise in turn (bb.draw_fwt_noise), one episode after the other
    gen_step = tsteps.episodic_train_step(tp, ts, ttx.init(tp), xt, method="gnnnet", bcfg=TFW, gcfg=tg, spec=tspec,
                                          tx=ttx, fwt_noise=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    drawn = [tbb.draw_fwt_noise(gen, TFW, dtype=torch.float64) for _ in range(2)]
    again = tsteps.episodic_train_step(tp, ts, ttx.init(tp), xt, method="gnnnet", bcfg=TFW, gcfg=tg, spec=tspec,
                                       tx=ttx, fwt_noise=drawn)
    assert float(gen_step[3]["loss"]) == float(again[3]["loss"]) != float(got[3]["loss"])


def test_fwt_meta_finetune_step_matches_jax():
    """The FO-MAML step on ResNet10_FW runs without noise (JAX steps.py:200,
    217 pass no rng): the inner loop adapts a block whose noise strengths the
    loss never reads, which must get zero gradients and stay put."""
    params, stats = _model(JFW, "gnn", 1)
    xj, xt = _episodes(1, 17)
    w, s, _ = SPEC
    rs = np.random.RandomState(4)
    perms = np.stack([rs.permutation(w * s) for _ in range(15)])
    jcfg_ = jil.InnerLoopCfg(epochs=15, batch_size=4, bank_size=w * s)
    tcfg_ = til.InnerLoopCfg(epochs=15, batch_size=4, bank_size=w * s)
    with jax.enable_x64():
        p, st = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
        tx = jopt.freeze_masked(jopt.torch_adam(1e-3), jbb.fwt_trainable_mask(p))
        want = _np(jsteps.meta_finetune_train_step(
            p, st, tx.init(p), jnp.asarray(xj), jax.random.PRNGKey(0), method="gnnnet", bcfg=JFW,
            gcfg=jgn.GnnNetCfg(**GKW), spec=JSpec(*SPEC), mcfg=jsteps.MetaFinetuneCfg(), tx=tx,
            schedule=jil.schedule_from_perms(perms, jcfg_)))
    tp, ts = convert.from_jax(params, stats)
    ttx = topt.freeze_masked(topt.torch_adam(1e-3), tbb.fwt_trainable_mask(tp))
    got = tsteps.meta_finetune_train_step(
        tp, ts, ttx.init(tp), xt, None, method="gnnnet", bcfg=TFW, gcfg=tgn.GnnNetCfg(**GKW), spec=EpisodeSpec(*SPEC),
        mcfg=tsteps.MetaFinetuneCfg(), tx=ttx, schedule=til.schedule_from_perms(perms, tcfg_))
    _check(got, want, loss_rtol=1e-8, rtol=1e-6, stats_rtol=1e-8)
    before, after = _fwt_leaves(tp), _fwt_leaves(got[0])
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_resnet18_baseline_step_matches_jax():
    """One baseline step on ResNet18's eight blocks (identity shortcuts in
    every stage), f64."""
    params, stats = _model(J18, "classifier", 2)
    rs = np.random.RandomState(5)
    x, y = rs.rand(6, SIZE, SIZE, 3), rs.randint(0, 10, 6)
    with jax.enable_x64():
        p, s = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
        tx = jopt.torch_adam(1e-3)
        want = _np(jsteps.baseline_train_step(p, s, tx.init(p), jnp.asarray(x), jnp.asarray(y), bcfg=J18, tx=tx))
    tp, ts = convert.from_jax(params, stats)
    ttx = topt.torch_adam(1e-3)
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    got = tsteps.baseline_train_step(tp, ts, ttx.init(tp), xt, torch.from_numpy(y), bcfg=T18, tx=ttx)
    _check(got, want)
    np.testing.assert_allclose(float(got[3]["top1"]), float(want[3]["top1"]))


def test_fwt_training_driver_freezes_and_resumes(tmp_path):
    """``cli.train --model ResNet10_FW`` (full width, 32 px): the checkpoint
    holds the reference's ``(1, C, 1, 1)`` noise strengths at their init
    values, bit for bit, and an Adam state without them; ``--start_epoch``
    resumes that masked state; the noise draws come from ``--seed``."""
    from mft_tpu_torch.cli import train

    pj = str(tmp_path / "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": str(tmp_path)}, f)
    common = ["--device", "cpu", "--dataset", "synthetic", "--model", "ResNet10_FW", "--image_size", "32",
              "--method", "gnnnet", "--train_aug", "--n_shot", "2", "--n_query", "2", "--episodes_per_epoch", "1",
              "--paths_json", pj]
    first = train.main(common + ["--stop_epoch", "0"])
    blob = torch.load(os.path.join(first.ckpt_dir, "0.tar"), weights_only=True)
    fwt = {k: v for k, v in blob["state"].items() if k.endswith((".gamma", ".beta"))}
    assert len(fwt) == 14 and tuple(fwt["feature.trunk.7.BN2.gamma"].shape) == (1, 512, 1, 1)
    for k, v in fwt.items():
        assert torch.equal(v, torch.full_like(v, 0.3 if k.endswith("gamma") else 0.5)), k
    assert blob["adam"]["t"] == 1 and not any("fwt_" in k for k in blob["adam"]["mu"])
    second = train.main(common + ["--start_epoch", "1", "--stop_epoch", "1"])
    blob = torch.load(os.path.join(second.ckpt_dir, "1.tar"), weights_only=True)
    assert blob["adam"]["t"] == 2 and np.isfinite(second.losses).all()
    assert all(torch.equal(blob["state"][k], v) for k, v in fwt.items())
