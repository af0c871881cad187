"""The port's training steps (mft_tpu_torch/train/steps.py, inner_loop.py
``inner_fit_carry`` / ``fo_maml_reattach``) against the JAX package's, on
one starting state carried across (``convert.from_jax`` /
``convert.adam_from_jax``) and the same numpy inputs.

Tolerances.  A step ends in an Adam update, ``-lr * m / (sqrt(v) + eps)``,
whose first step is about ``lr * sign(g)``: in f32 a gradient near zero
whose sign the two summation orders disagree on moves its weight by up to
``2 * lr``, so updated parameters are compared in f64 (``jax.enable_x64``
and ``torch.float64``, as tests/test_golden_reference.py does), where that
noise is some 1e-16 of the gradient: loss rtol 1e-10, stats rtol 1e-9,
Adam moments and parameters rtol 1e-8 (atol 1e-10).  The meta fine-tune
(15 inner Adam(0.01) steps whose ``1/(sqrt(v)+eps)`` amplifies roundoff)
gets the JAX golden test's f64 bounds: loss rtol 1e-8, parameters rtol 1e-6.
With ``use_pallas`` the edge op runs in f32 in both packages (JAX casts at
gnn.py:79), so that test runs in f32 with plain SGD as the outer optimizer
(an update linear in the gradient): loss rtol 1e-5, gradients and updated
parameters at rtol 2e-3 / atol 2e-4 of each tensor's largest value (the
default of ``_assert_tree_close``) plus 1e-5 of the whole tree's largest,
since gradients that are zero in exact arithmetic are f32 noise.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils import _pytree as pytree

import mft_tpu.ops.pallas.edge_mlp as jem
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
from tests.test_golden_reference import _assert_tree_close

JCFG = jbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, 16), "simple", flatten=True)
TCFG = tbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, 16))
GKW = dict(feat_dim=16, n_way=3, n_support=2, proj_dim=16, gnn_nf=8)
SPEC = (3, 2, 3)
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores, and
    more threads than cores slow every worker's small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(method: str, seed: int = 0):
    """JAX trees (numpy leaves) with non-trivial BN parameters and stats."""
    kb, kh = jax.random.split(jax.random.PRNGKey(seed))
    p, s = jax.jit(lambda k: jbb.init_backbone(k, JCFG))(kb)
    rs = np.random.RandomState(seed)
    perturb = lambda a: np.asarray(a) + (rs.rand(*np.shape(a)).astype(np.float32) * 0.2 if np.ndim(a) == 1 else 0)
    params = {"feature": jax.tree.map(perturb, p)}
    stats = jax.tree.map(perturb, s)
    if method == "baseline":
        params["classifier"] = _np(j_init_classifier(kh, 16, 10))
    elif method == "gnnnet":
        params.update(_np(jax.jit(lambda k: jgn.init_head(k, jgn.GnnNetCfg(**GKW)))(kh)))
    return params, stats


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _episodes(e: int, seed: int, dtype=np.float64):
    """``e`` episodes NHWC for JAX and NCHW for the port."""
    w, s, q = SPEC
    x = np.random.RandomState(seed).rand(e, w, s + q, SIZE, SIZE, 3).astype(dtype)
    return x, torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 1, 2, 5, 3, 4))))


def _port(params, stats):
    return convert.from_jax(params, stats)


def _close_f32(got, want, label, rtol=2e-3, atol_frac=2e-4):
    """``_assert_tree_close`` with an absolute floor of 1e-5 of the largest
    value in the whole tree: a gradient that is zero in exact arithmetic (a
    bias before a batch-statistics BN) is f32 noise near 1e-8 of that scale
    in both packages, with no sign in common."""
    floor = 1e-5 * max(float(np.abs(np.asarray(a)).max()) for a in jax.tree.leaves(want))
    paths = [jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for path, a, b in zip(paths, jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=atol_frac * float(np.abs(b).max()) + floor,
                                   err_msg=f"{label}{path}")


def _check_adam(port_state, jax_state, rtol=1e-8):
    got = convert.adam_to_jax(port_state)
    adam = jax_state[0]
    assert got["count"] == int(adam.count)
    _assert_tree_close(got["mu"], _np(adam.mu), rtol=rtol, atol_frac=1e-10, label="mu")
    _assert_tree_close(got["nu"], _np(adam.nu), rtol=rtol, atol_frac=1e-10, label="nu")


def _check_step(port_out, jax_out, *, loss_rtol=1e-10, rtol=1e-8, stats_rtol=1e-9):
    tp, ts, to, tm = port_out
    jp, js, jo, jm = jax_out
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=loss_rtol)
    got_p, got_s = convert.to_jax(tp, ts)
    _assert_tree_close(got_p, _np(jp), rtol=rtol, atol_frac=1e-10, label="params")
    _assert_tree_close(got_s, _np(js), rtol=stats_rtol, atol_frac=1e-12, label="stats")
    _check_adam(to, jo, rtol)


def test_baseline_train_step_matches_jax():
    params, stats = _model("baseline")
    rs = np.random.RandomState(5)
    x = rs.rand(6, SIZE, SIZE, 3)
    y = rs.randint(0, 10, 6)
    with jax.enable_x64():
        p, s = _f64(params), _f64(stats)
        tx = jopt.torch_adam(1e-3)
        want = jsteps.baseline_train_step(p, s, tx.init(p), jnp.asarray(x), jnp.asarray(y), bcfg=JCFG, tx=tx)
        want = _np(want)
    tp, ts = _port(_f64(params), _f64(stats))
    ttx = topt.torch_adam(1e-3)
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    got = tsteps.baseline_train_step(tp, ts, ttx.init(tp), xt, torch.from_numpy(y), bcfg=TCFG, tx=ttx)
    _check_step(got, want)
    np.testing.assert_allclose(float(got[3]["top1"]), float(want[3]["top1"]))


def _episodic_pair(method, e, *, seed=0):
    params, stats = _model(method, seed)
    xj, xt = _episodes(e, seed + 11)
    jg = jgn.GnnNetCfg(**GKW) if method == "gnnnet" else None
    tg = tgn.GnnNetCfg(**GKW) if method == "gnnnet" else None
    with jax.enable_x64():
        p, s = _f64(params), _f64(stats)
        tx = jopt.torch_adam(1e-3)
        want = _np(jsteps.episodic_train_step(p, s, tx.init(p), jnp.asarray(xj), jax.random.PRNGKey(0), method=method,
                                              bcfg=JCFG, gcfg=jg, spec=JSpec(*SPEC), tx=tx))
    tp, ts = _port(_f64(params), _f64(stats))
    ttx = topt.torch_adam(1e-3)
    got = tsteps.episodic_train_step(tp, ts, ttx.init(tp), xt, method=method, bcfg=TCFG, gcfg=tg,
                                     spec=EpisodeSpec(*SPEC), tx=ttx)
    return got, want, (tp, ts, xt, tg)


@pytest.mark.parametrize("method", ["gnnnet", "protonet"])
def test_episodic_train_step_matches_jax(method):
    got, want, _ = _episodic_pair(method, 1)
    _check_step(got, want)


def test_episode_batch_averages_losses_and_stats():
    """E = 2 against JAX's vmap over E, and against the port's own two
    one-episode losses and stat updates averaged."""
    got, want, (tp, ts, xt, tg) = _episodic_pair("gnnnet", 2, seed=1)
    _check_step(got, want)
    one = [tsteps._episode_loss(tp, ts, xt[i], method="gnnnet", bcfg=TCFG, gcfg=tg, spec=EpisodeSpec(*SPEC))
           for i in range(2)]
    np.testing.assert_allclose(float(got[3]["loss"]), (float(one[0][0]) + float(one[1][0])) / 2, rtol=1e-12)
    mean_stats = jax.tree.map(lambda a, b: (a + b) / 2, convert.to_jax(tp, one[0][1])[1],
                              convert.to_jax(tp, one[1][1])[1])
    _assert_tree_close(convert.to_jax(tp, got[1])[1], mean_stats, rtol=1e-12, atol_frac=1e-14)


def _interpret(x, w, b, interpret=False):
    return _orig_edge(x, w, b, True)


_orig_edge = jem.edge_abs_diff_matmul


def test_episodic_gnnnet_use_pallas_matches_jax():
    """JAX's Pallas kernel in interpret mode against the port's edge op (on
    the CPU its plain version), f32: loss, every gradient, and one step with
    SGD as the optimizer; then the Adam moments of one Adam step."""
    params, stats = _model("gnnnet", 2)
    xj, xt = _episodes(1, 13, np.float32)
    jg = jgn.GnnNetCfg(**GKW, use_pallas=True)
    tg = tgn.GnnNetCfg(**GKW, use_pallas=True)
    jspec, tspec = JSpec(*SPEC), EpisodeSpec(*SPEC)
    with mock.patch.object(jem, "edge_abs_diff_matmul", _interpret):
        loss_fn = lambda p: jsteps._episode_loss(p, stats, jnp.asarray(xj[0]), method="gnnnet", bcfg=JCFG, gcfg=jg,
                                                 spec=jspec)
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        sgd = optax.sgd(0.1)
        want = _np(jsteps.episodic_train_step(params, stats, sgd.init(params), jnp.asarray(xj), jax.random.PRNGKey(0),
                                              method="gnnnet", bcfg=JCFG, gcfg=jg, spec=jspec, tx=sgd))
        adam = jopt.torch_adam(1e-3)
        want_adam = _np(jsteps.episodic_train_step(params, stats, adam.init(params), jnp.asarray(xj),
                                                   jax.random.PRNGKey(0), method="gnnnet", bcfg=JCFG, gcfg=jg,
                                                   spec=jspec, tx=adam))
    tp, ts = _port(params, stats)
    loss, _, grads = tsteps._value_and_grad(
        lambda p: tsteps._episode_loss(p, ts, xt[0], method="gnnnet", bcfg=TCFG, gcfg=tg, spec=tspec), tp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close_f32(convert.to_jax(grads)[0], _np(jgrads), "grads")
    tsgd = topt.torch_sgd(0.1)
    got = tsteps.episodic_train_step(tp, ts, tsgd.init(tp), xt, method="gnnnet", bcfg=TCFG, gcfg=tg, spec=tspec,
                                     tx=tsgd)
    np.testing.assert_allclose(float(got[3]["loss"]), float(want[3]["loss"]), rtol=1e-5)
    got_p, got_s = convert.to_jax(got[0], got[1])
    _close_f32(got_p, want[0], "sgd params")
    _close_f32(got_s, want[1], "stats", rtol=1e-4, atol_frac=1e-6)
    tadam = topt.torch_adam(1e-3)
    got_adam = tsteps.episodic_train_step(tp, ts, tadam.init(tp), xt, method="gnnnet", bcfg=TCFG, gcfg=tg,
                                          spec=tspec, tx=tadam)
    moments = convert.adam_to_jax(got_adam[2])
    _close_f32(moments["mu"], want_adam[2][0].mu, "mu")
    _close_f32(moments["nu"], want_adam[2][0].nu, "nu", rtol=4e-3, atol_frac=4e-4)


def _schedule(epochs, bank, batch, seed):
    rs = np.random.RandomState(seed)
    return np.stack([rs.permutation(bank) for _ in range(epochs)])


@pytest.mark.parametrize("bn_mode", ["episode", "minibatch"])
def test_meta_finetune_train_step_matches_jax(bn_mode):
    """FO-MAML over an explicit inner schedule (15 epochs x batch 4 over a
    6-image support bank, ragged 4 + 2), both BN modes, f64."""
    params, stats = _model("gnnnet", 3)
    xj, xt = _episodes(1, 17)
    w, s, _ = SPEC
    perms = _schedule(15, w * s, 4, 4)
    jcfg_ = jil.InnerLoopCfg(epochs=15, batch_size=4, bank_size=w * s)
    tcfg_ = til.InnerLoopCfg(epochs=15, batch_size=4, bank_size=w * s)
    mcfg = jsteps.MetaFinetuneCfg(bn_mode=bn_mode)
    with jax.enable_x64():
        p, st = _f64(params), _f64(stats)
        tx = jopt.torch_adam(1e-3)
        want = _np(jsteps.meta_finetune_train_step(
            p, st, tx.init(p), jnp.asarray(xj), jax.random.PRNGKey(0), method="gnnnet", bcfg=JCFG,
            gcfg=jgn.GnnNetCfg(**GKW), spec=JSpec(*SPEC), mcfg=mcfg, tx=tx,
            schedule=jil.schedule_from_perms(perms, jcfg_)))
    tp, ts = _port(_f64(params), _f64(stats))
    ttx = topt.torch_adam(1e-3)
    got = tsteps.meta_finetune_train_step(
        tp, ts, ttx.init(tp), xt, None, method="gnnnet", bcfg=TCFG, gcfg=tgn.GnnNetCfg(**GKW),
        spec=EpisodeSpec(*SPEC), mcfg=tsteps.MetaFinetuneCfg(bn_mode=bn_mode), tx=ttx,
        schedule=til.schedule_from_perms(perms, tcfg_))
    _check_step(got, want, loss_rtol=1e-8, rtol=1e-6, stats_rtol=1e-8)


def test_inner_fit_carry_matches_jax():
    """A carry that every step replaces (a running mean of the rows seen),
    threaded through 3 epochs of Adam(0.01) on a linear model, f64."""
    rs = np.random.RandomState(7)
    bank, yv = rs.randn(6, 5), rs.randn(6)
    w0 = {"w": rs.randn(5), "b": np.zeros(())}
    perms = _schedule(3, 6, 4, 8)

    def jloss(p, c, idx, wt):
        pred = bank_j[idx] @ p["w"] + p["b"]
        return jnp.sum(wt * (pred - y_j[idx]) ** 2), {"m": 0.9 * c["m"] + 0.1 * jnp.mean(bank_j[idx], axis=0)}

    def tloss(p, c, idx, wt):
        pred = bank_t[idx] @ p["w"] + p["b"]
        return (wt * (pred - y_t[idx]) ** 2).sum(), {"m": 0.9 * c["m"] + 0.1 * bank_t[idx].mean(dim=0)}

    with jax.enable_x64():
        bank_j, y_j = jnp.asarray(bank), jnp.asarray(yv)
        cfg = jil.InnerLoopCfg(epochs=3, batch_size=4, bank_size=6)
        jp, jc = jil.inner_fit_carry(jloss, jax.tree.map(jnp.asarray, w0), {"m": jnp.zeros(5)}, jopt.torch_adam(0.01),
                                     None, cfg, schedule=jil.schedule_from_perms(perms, cfg))
        jp, jc = _np(jp), _np(jc)
    bank_t, y_t = torch.from_numpy(bank), torch.from_numpy(yv)
    tcfg_ = til.InnerLoopCfg(epochs=3, batch_size=4, bank_size=6)
    tp, tc = til.inner_fit_carry(tloss, {k: torch.from_numpy(np.asarray(v)) for k, v in w0.items()},
                                 {"m": torch.zeros(5, dtype=torch.float64)}, topt.torch_adam(0.01), None, tcfg_,
                                 schedule=til.schedule_from_perms(perms, tcfg_))
    for k in w0:
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tc["m"].numpy(), jc["m"], rtol=1e-12)
    assert tc["m"].grad_fn is None and not tp["w"].requires_grad


def test_fo_maml_reattach_gradient():
    """The reattached tree has the adapted values and passes the outer
    gradient to the meta values with an identity Jacobian; nothing reaches
    the adapted tree."""
    rs = np.random.RandomState(9)
    meta = {"a": torch.from_numpy(rs.randn(4)).requires_grad_(True)}
    adapted = {"a": torch.from_numpy(rs.randn(4)).requires_grad_(True)}
    out = til.fo_maml_reattach(meta, adapted)
    np.testing.assert_allclose(out["a"].detach().numpy(), adapted["a"].detach().numpy(), rtol=1e-15)
    loss = (out["a"] ** 3).sum()
    g_meta, = torch.autograd.grad(loss, meta["a"], retain_graph=True)
    np.testing.assert_allclose(g_meta.numpy(), 3 * adapted["a"].detach().numpy() ** 2, rtol=1e-12)
    assert torch.autograd.grad(loss, adapted["a"], allow_unused=True)[0] is None
    with jax.enable_x64():
        m, a = jnp.asarray(meta["a"].detach().numpy()), jnp.asarray(adapted["a"].detach().numpy())
        jg = jax.grad(lambda m: jnp.sum(jil.fo_maml_reattach({"a": m}, {"a": a})["a"] ** 3))(m)
    np.testing.assert_allclose(g_meta.numpy(), np.asarray(jg), rtol=1e-12)


def test_running_stats_carry_no_graph():
    """A training step's new running stats and parameters are leaves: no
    graph of the step lives on in them (ops/norm.py builds the running
    update without one)."""
    params, stats = _model("gnnnet", 4)
    _, xt = _episodes(1, 19, np.float32)
    tp, ts = _port(params, stats)
    tx = topt.torch_adam(1e-3)
    p, s, o, m = tsteps.episodic_train_step(tp, ts, tx.init(tp), xt, method="gnnnet", bcfg=TCFG,
                                            gcfg=tgn.GnnNetCfg(**GKW), spec=EpisodeSpec(*SPEC), tx=tx)
    for leaf in pytree.tree_leaves((p, s, o["mu"], o["nu"], m)):
        assert leaf.grad_fn is None and not leaf.requires_grad


def test_torch_adam_whole_tree_matches_jax():
    """``torch_adam(1e-3)`` over the whole GnnNet parameter tree against JAX
    ``opt.torch_adam(1e-3)``, three steps of seeded gradients, f64, and the
    state carried across both ways (``adam_from_jax`` / ``adam_to_jax``)."""
    params, _ = _model("gnnnet", 5)
    rs = np.random.RandomState(6)
    grads = [jax.tree.map(lambda a: rs.randn(*np.shape(a)) * 10.0 ** rs.randint(-6, 0), _f64(params))
             for _ in range(3)]
    with jax.enable_x64():
        tx = jopt.torch_adam(1e-3)
        p = _f64(params)
        state = tx.init(p)
        for g in grads:
            u, state = tx.update(g, state, p)
            p = optax.apply_updates(p, u)
        want_p, want_state = _np(p), _np(state)
    tp, _ = _port(_f64(params), None)
    ttx = topt.torch_adam(1e-3)
    tstate = ttx.init(tp)
    for g in grads:
        tg, _ = convert.from_jax(g)
        u, tstate = ttx.update(tg, tstate, tp)
        tp = pytree.tree_map(lambda a, b: a + b, tp, u)
    _assert_tree_close(convert.to_jax(tp)[0], want_p, rtol=1e-12, atol_frac=1e-14, label="params")
    _check_adam(tstate, want_state, rtol=1e-12)
    back = convert.adam_from_jax(want_state)
    _check_adam(back, want_state, rtol=0)


def test_bf16_training_feeds_the_edge_op_f32():
    """Under ``--dtype bfloat16`` the backbone's features are bf16, and what
    reaches the edge op in a training step is f32 and contiguous, as the
    kernel requires (JAX casts at gnn.py:79); the step's loss is finite."""
    from mft_tpu_torch.kernels import edge_mlp as tem

    params, stats = _model("gnnnet", 6)
    _, xt = _episodes(1, 21, np.float32)
    tp, ts = _port(params, stats)
    seen = []
    orig = tem.edge_abs_diff_matmul

    def spy(x, w, b):
        seen.append(tuple((t.dtype, t.is_contiguous()) for t in (x, w, b)))
        return orig(x, w, b)

    tx = topt.torch_adam(1e-3)
    with mock.patch.object(tem, "edge_abs_diff_matmul", spy):
        out = tsteps.episodic_train_step(tp, ts, tx.init(tp), xt.to(torch.bfloat16), method="gnnnet",
                                         bcfg=TCFG._replace(compute_dtype="bfloat16"),
                                         gcfg=tgn.GnnNetCfg(**GKW, use_pallas=True), spec=EpisodeSpec(*SPEC), tx=tx)
    assert len(seen) == 3
    assert all(s == ((torch.float32, True),) * 3 for s in seen), seen
    assert np.isfinite(float(out[3]["loss"]))
