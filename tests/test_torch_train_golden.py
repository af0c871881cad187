"""The port's training steps against the reference's own f64 goldens, the
artifacts the JAX package's tests hold it to: the four single-step backward
goldens of tests/fixtures/golden_reference.npz (baseline pretraining, the
episodic GnnNet step, the GnnNet and ProtoNet meta fine-tune with their BN
running-stat trajectories) and the two three-episode train-loop trajectories
of tests/fixtures/golden_trainloop.npz.

The reference's state dicts load straight into the port
(``convert.from_state_dict(..., dtype=torch.float64)``): its f32 weights
widen exactly, and the gradient fixtures map through the same (linear)
layout as the parameters.  Compared in f64 at the JAX tests' own
tolerances (tests/test_golden_reference.py:790-950, 1139-1172;
tests/test_trainloop_golden.py).
"""

import os

import numpy as np
import pytest
import torch

from mft_tpu_torch import convert
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.train import optimizers as topt
from mft_tpu_torch.train import steps
from mft_tpu_torch.train.inner_loop import InnerLoopCfg, schedule_from_perms
from mft_tpu_torch.utils.checkpoint import keyed

HERE = os.path.dirname(__file__)
TINY = tbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, 16))
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores, and
    more threads than cores slow every worker's small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g():
    with np.load(os.path.join(HERE, "fixtures", "golden_reference.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def gl():
    with np.load(os.path.join(HERE, "fixtures", "golden_trainloop.npz")) as z:
        return {k: z[k] for k in z.files}


MODULES = ("feature.", "fc.", "gnn.", "classifier.", "trunk.")


def _sd(g, prefix):
    """The state dict under ``prefix`` (the model's modules only, not the
    fixture's other entries that share the prefix, as ``btrain.grad.*``)."""
    n = len(prefix) + 1
    return {k[n:]: torch.from_numpy(np.asarray(v)) for k, v in g.items()
            if k.startswith(prefix + ".") and k[n:].startswith(MODULES)}


def _trees(g, prefix, *, grads=None, stats_from=None):
    """Port trees from the fixture's ``prefix`` state dict.  ``grads``: the
    prefix of recorded gradients put in the parameters' places (running
    stats kept, as from_state_dict needs them); ``stats_from``: a prefix of
    running stats relative to the feature module put in the stats' places."""
    sd = _sd(g, prefix)
    if grads is not None:
        sd.update(_sd(g, grads))
    if stats_from is not None:
        sd.update({f"feature.{k}": v for k, v in _sd(g, stats_from).items()})
    return convert.from_state_dict(sd, TINY, dtype=F64)


def _close(got, want, rtol, atol_frac, label):
    got, want = keyed(got), keyed(want)
    assert sorted(got) == sorted(want), (label, sorted(set(got) ^ set(want)))
    for k, b in want.items():
        b = b.numpy()
        np.testing.assert_allclose(got[k].detach().numpy(), b, rtol=rtol,
                                   atol=atol_frac * (float(np.abs(b).max()) or 1.0) + 1e-9, err_msg=f"{label}{k}")


def _grads(loss_fn, params):
    loss, aux, grads = steps._value_and_grad(loss_fn, params)
    return float(loss), aux, grads


def test_baseline_train_backward_golden(g):
    params, stats = _trees(g, "btrain")
    x = torch.from_numpy(np.random.RandomState(135).rand(6, 3, 224, 224))
    y = torch.from_numpy(g["btrain.y"])
    loss, _, grads = _grads(lambda p: steps.baseline_loss_fn(p, stats, x, y, bcfg=TINY), params)
    np.testing.assert_allclose(loss, float(g["btrain.loss"]), rtol=1e-9)
    want, _ = _trees(g, "btrain", grads="btrain.grad")
    _close(grads, want, 1e-6, 1e-8, "grad")


def test_episodic_train_backward_golden(g):
    params, stats = _trees(g, "fte2e_gnn")
    spec = EpisodeSpec(2, 2, 16)
    gcfg = tgn.GnnNetCfg(feat_dim=16, n_way=2, n_support=2)
    ep = torch.from_numpy(np.random.RandomState(321).rand(2, 18, 3, 224, 224))
    loss, _, grads = _grads(lambda p: steps._episode_loss(p, stats, ep, method="gnnnet", bcfg=TINY, gcfg=gcfg,
                                                          spec=spec), params)
    np.testing.assert_allclose(loss, float(g["trainstep.loss"]), rtol=1e-9)
    want, _ = _trees(g, "fte2e_gnn", grads="trainstep.grad")
    _close(grads, want, 1e-6, 1e-8, "grad")


@pytest.mark.parametrize("case", ["gnnnet", "protonet"])
def test_meta_finetune_backward_golden(g, case):
    """The FO-MAML stage with the reference's recorded inner permutations:
    15 epochs (GnnNet; 4-image bank) or 5 epochs over a ragged 6-image bank
    (ProtoNet, 4 + 2), BN stats riding every inner minibatch
    (``bn_mode='minibatch'``), separate support/query passes, the outer
    gradients and the running-stat trajectory."""
    if case == "gnnnet":
        prefix, fx, spec, epochs, seed, shape = "fte2e_gnn", "mft", EpisodeSpec(2, 2, 16), 15, 654, (2, 18)
        gcfg = tgn.GnnNetCfg(feat_dim=16, n_way=2, n_support=2)
    else:
        prefix, fx, spec, epochs, seed, shape = "pnft", "pnft", EpisodeSpec(3, 2, 5), 5, 777, (3, 7)
        gcfg = None
    params, stats = _trees(g, prefix)
    if case == "protonet":
        params = {"feature": params["feature"]}
    mcfg = steps.MetaFinetuneCfg(epochs=epochs, batch_size=4, bn_mode="minibatch")
    sched = schedule_from_perms(g[f"{fx}.perms"], InnerLoopCfg(epochs, 4, spec.support_size))
    ep = torch.from_numpy(np.random.RandomState(seed).rand(*shape, 3, 224, 224))
    loss, new_stats, grads = _grads(
        lambda p: steps._meta_finetune_episode_loss(p, stats, ep, None, method=case, bcfg=TINY, gcfg=gcfg, spec=spec,
                                                    mcfg=mcfg, schedule=sched), params)
    np.testing.assert_allclose(loss, float(g[f"{fx}.loss"]), rtol=1e-8)
    _, want_stats = _trees(g, prefix, stats_from=f"{fx}.post_stats")
    _close(new_stats, want_stats, 1e-8, 1e-10, "post_stats")
    want, _ = _trees(g, prefix, grads=f"{fx}.grad")
    if case == "protonet":
        want = {"feature": want["feature"]}
    _close(grads, want, 1e-5, 1e-7, "grad")


def _loop_episodes(queries):
    rs = np.random.RandomState(905)
    return [torch.from_numpy(rs.rand(2, 2 + q, 3, 224, 224)) for q in queries]


def test_train_loop2_trajectory_golden(gl):
    """Three episodic steps (n_query 3, 2, 3) under one carried Adam: the
    losses, the final parameters and the final running stats."""
    params, stats = _trees(gl, "init")
    gcfg = tgn.GnnNetCfg(feat_dim=16, n_way=2, n_support=2)
    tx = topt.torch_adam(1e-3)
    opt_state = tx.init(params)
    losses = []
    for x, q in zip(_loop_episodes((3, 2, 3)), (3, 2, 3)):
        params, stats, opt_state, m = steps.episodic_train_step(params, stats, opt_state, x[None], method="gnnnet",
                                                                bcfg=TINY, gcfg=gcfg, spec=EpisodeSpec(2, 2, q), tx=tx)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, gl["epi.losses"], rtol=1e-8)
    want_p, want_s = _trees(gl, "epi.final")
    _close(params, want_p, 1e-7, 1e-9, "epi.params")
    _close(stats, want_s, 1e-7, 1e-9, "epi.stats")


def test_train_loop_finetune_trajectory_golden(gl):
    """Three meta fine-tune steps with the reference's recorded inner
    permutations: the cross-episode FO-MAML bookkeeping (nothing of an inner
    loop persists but its running stats), the outer Adam trajectory."""
    params, stats = _trees(gl, "init")
    gcfg = tgn.GnnNetCfg(feat_dim=16, n_way=2, n_support=2)
    mcfg = steps.MetaFinetuneCfg(epochs=15, batch_size=4, bn_mode="minibatch")
    icfg = InnerLoopCfg(15, 4, 4)
    perms = gl["mft.perms"]
    tx = topt.torch_adam(1e-3)
    opt_state = tx.init(params)
    losses = []
    for e, x in enumerate(_loop_episodes((16, 16, 16))):
        params, stats, opt_state, m = steps.meta_finetune_train_step(
            params, stats, opt_state, x[None], None, method="gnnnet", bcfg=TINY, gcfg=gcfg, spec=EpisodeSpec(2, 2, 16),
            mcfg=mcfg, tx=tx, schedule=schedule_from_perms(perms[e * 15 : (e + 1) * 15], icfg))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, gl["mft.losses"], rtol=1e-8)
    want_p, want_s = _trees(gl, "mft.final")
    _close(params, want_p, 1e-6, 1e-8, "mft.params")
    _close(stats, want_s, 1e-6, 1e-8, "mft.stats")
