"""The port's DampNet (mft_tpu_torch/methods/dampnet.py, its train step and
its eval member) against the JAX package's on shared numpy inputs.

Weights are drawn by the JAX package, widened to f64 and carried into the
port with ``convert.from_jax``; both sides then run f64 (``jax.enable_x64``
and ``torch.float64``), where summation order costs some 1e-16: scores,
losses, gradients and running stats at rtol 1e-8 (losses 1e-10).  The
corruption cannot be drawn alike (JAX's PRNG is not torch's), so the
corrupt mode is fed ``corrupt_x``, and ``apply_corruption`` is held against
JAX's ``sample_corruption`` with the draws recreated from JAX's own key
splits (mft_tpu/methods/dampnet.py:260-285); the port's sampler is checked
for its structure.  The eval member's episode BN mode casts its image bank
to f32 in both packages, so it compares in f32 at the slice test's atol
1e-4 (tests/test_torch_slice.py); the minibatch mode in f64.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mft_tpu.core import episode as jep
from mft_tpu.methods import dampnet as jdn
from mft_tpu.models import backbone as jbb
from mft_tpu.ops import augment as jaug
from mft_tpu.train import eval_engine as jee
from mft_tpu.train import inner_loop as jil
from mft_tpu.train import steps as jsteps
from mft_tpu_torch import convert
from mft_tpu_torch.core import episode as tep
from mft_tpu_torch.methods import dampnet as tdn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops import augment as taug
from mft_tpu_torch.train import eval_engine as tee
from mft_tpu_torch.train import inner_loop as til
from mft_tpu_torch.train import optimizers as topt
from mft_tpu_torch.train import steps as tsteps

F = 16
SMALL = dict(feat_dim=F, n_way=3, n_support=2, gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16)
CFGS = {
    "full_class": (jdn.DampNetCfg(**SMALL, stat="class"), tdn.DampNetCfg(**SMALL, stat="class")),
    "full": (jdn.DampNetCfg(**SMALL, stat="support"), tdn.DampNetCfg(**SMALL, stat="support")),
    "prototype": (jdn.prototype_cfg(F, 3, 2)._replace(gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16, mlp_hidden2=12,
                                                       store_len=4),
                  tdn.prototype_cfg(F, 3, 2)._replace(gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16, mlp_hidden2=12,
                                                       store_len=4)),
}
JCFG = jbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, F), "simple", flatten=True)
TCFG = tbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, F))
N_QUERY = 2
MODES = ("plain", "corrupt", "recover", "domain_shift", "unsup")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a), tree)


def _close(got_port, want_jax, rtol=1e-8, atol_frac=1e-12, label=""):
    """A port tree against a JAX tree (numpy leaves), leaf by leaf in the
    JAX layout; atol as a share of each leaf's largest value, plus 1e-13 of
    the tree's (a gradient that is zero in exact arithmetic, a bias before a
    batch-statistics BN, is f64 noise of no common sign)."""
    got, _ = convert.to_jax(got_port)
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want_jax)[0]
    assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl], label
    tree_max = max(float(np.abs(np.asarray(b, np.float64)).max()) for _, b in wl if np.size(b))
    for (path, a), (_, b) in zip(gl, wl):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=rtol,
                                   atol=atol_frac * (float(np.abs(b).max()) if b.size else 0.0) + 1e-13 * tree_max,
                                   err_msg=f"{label}{jax.tree_util.keystr(path)}")


@pytest.fixture(scope="module")
def models():
    """Per variant: JAX params (f64 numpy), a filled state (prototypes from a
    random bank; the prototype variant's store rotated twice, wrapping), the
    port's copies, and an episode of features."""
    out = {}
    rs = np.random.RandomState(0)
    for i, (name, (jc, tc)) in enumerate(CFGS.items()):
        params, state = jax.jit(lambda k, c=jc: jdn.init_dampnet(k, c))(jax.random.PRNGKey(i))
        params = _f64(params)
        with jax.enable_x64():
            state = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                                 else jnp.asarray(a), state)
            if jc.variant == "prototype":
                state = jdn.update_prototype_store(state, jnp.asarray(rs.randn(3, 6, F)))
                state = jdn.update_prototype_store(state, jnp.asarray(rs.randn(3, 6, F)))
            state = jdn.update_prototypes(state, jnp.asarray(rs.randn(40, F)))
            state = jax.tree.map(np.asarray, state)
        tp, ts = convert.from_jax(params, state)
        feats = rs.randn(3, 2 + N_QUERY, F)
        out[name] = dict(jc=jc, tc=tc, jp=params, js=state, tp=tp, ts=ts, feats=feats,
                         corrupt_x=rs.randn(3 * (2 + N_QUERY), F), unsup=(rs.randn(F), np.abs(rs.randn(F))))
    return out


# --------------------------------------------------------------------------
# the building blocks
# --------------------------------------------------------------------------


def test_bilinear_and_stats_match_jax():
    rs = np.random.RandomState(1)
    w, a, b = rs.randn(4, 5, 5), rs.randn(5), rs.randn(5)
    feats = rs.randn(3, 6, F)
    bank = rs.randn(50, F)
    with jax.enable_x64():
        want_bil = np.asarray(jdn.bilinear(jnp.asarray(w), jnp.asarray(a), jnp.asarray(b)))
        want_stats = {s: [np.asarray(t) for t in jdn.episode_stats(jnp.asarray(feats), CFGS["full"][0]._replace(stat=s))]
                      for s in ("class", "support")}
        want_proto = jdn.update_prototypes({"initialized": jnp.zeros((), bool)}, jnp.asarray(bank))
        want_z = np.asarray(jdn.znorm_projection(jnp.asarray(feats), 2))
    got = tdn.bilinear(torch.from_numpy(w), torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want_bil, rtol=1e-12)
    for s, want in want_stats.items():
        got = tdn.episode_stats(torch.from_numpy(feats), CFGS["full"][1]._replace(stat=s))
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-12, err_msg=s)
    got = tdn.update_prototypes(tdn.fresh_state(CFGS["full"][1], dtype=torch.float64), torch.from_numpy(bank))
    np.testing.assert_allclose(got["proto_mean"].numpy(), np.asarray(want_proto["proto_mean"]), rtol=1e-12)
    np.testing.assert_allclose(got["proto_std"].numpy(), np.asarray(want_proto["proto_std"]), rtol=1e-12)
    assert bool(got["initialized"])
    np.testing.assert_allclose(tdn.znorm_projection(torch.from_numpy(feats), 2).numpy(), want_z, rtol=1e-12)


@pytest.mark.parametrize("variant", list(CFGS))
def test_recovery_matches_jax(models, variant):
    m = models[variant]
    rs = np.random.RandomState(2)
    xm, xs = rs.randn(F), np.abs(rs.randn(F))
    with jax.enable_x64():
        want = [np.asarray(t) for t in jdn.recovery(m["jp"], jax.tree.map(jnp.asarray, m["js"]), jnp.asarray(xm),
                                                    jnp.asarray(xs))]
    got = tdn.recovery(m["tp"], m["ts"], torch.from_numpy(xm), torch.from_numpy(xs))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-10, atol=1e-13)


def test_store_rotation_wraps_like_jax():
    """store_len 4, count 150: an E=3 batch writes slots 2, 3, 0; the next
    E=3 batch 1, 2, 3, overwriting two of the first batch's slots."""
    jc, tc = CFGS["prototype"]
    rs = np.random.RandomState(3)
    b1, b2 = rs.randn(3, 6, F), rs.randn(3, 6, F)
    with jax.enable_x64():
        js = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a,
                          jdn.init_dampnet(jax.random.PRNGKey(0), jc)[1])
        js = jdn.update_prototype_store(jdn.update_prototype_store(js, jnp.asarray(b1)), jnp.asarray(b2))
        want_pm, want_ps = (np.asarray(t) for t in jdn.store_prototypes(js))
    ts = tdn.fresh_state(tc, dtype=torch.float64)
    assert int(ts["count"]) == 150 and ts["count"].dtype == torch.int32
    ts = tdn.update_prototype_store(tdn.update_prototype_store(ts, torch.from_numpy(b1)), torch.from_numpy(b2))
    assert int(ts["count"]) == int(js["count"]) == 156
    np.testing.assert_array_equal(ts["store_std"].numpy(), np.asarray(js["store_std"]))
    np.testing.assert_allclose(ts["store_mean"].numpy(), np.asarray(js["store_mean"]), rtol=1e-14)
    np.testing.assert_array_equal(ts["store_std"][0].numpy(), b1[2])  # slot 0 <- count 152
    np.testing.assert_array_equal(ts["store_std"][2].numpy(), b2[1])  # slot 2 overwritten by count 154
    pm, ps = tdn.store_prototypes(ts)
    np.testing.assert_allclose(pm.numpy(), want_pm, rtol=1e-12)
    np.testing.assert_allclose(ps.numpy(), want_ps, rtol=1e-12)


@pytest.mark.parametrize("e_batch", [1, 2, 3, 4])
def test_schedules_match_jax(e_batch):
    for count in range(150, 150 + 12 * e_batch, e_batch):
        assert tdn.prototype_training_mode(count, e_batch) == jdn.prototype_training_mode(count, e_batch), count
    modes = [tdn.prototype_training_mode(150 + e_batch * i, e_batch) for i in range(5)]
    assert modes == ["plain", "corrupt", "recover", "corrupt", "recover"]
    for step in range(0, 12 * e_batch, e_batch):
        for init in (False, True):
            assert tdn.training_mode(step, init) == jdn.training_mode(step, init), (step, init)


# --------------------------------------------------------------------------
# scores and gradients in every mode
# --------------------------------------------------------------------------


def _jax_loss(m, mode):
    jc = m["jc"]

    def loss(p):
        st = jax.tree.map(jnp.asarray, m["js"])
        s = jdn.dampnet_scores(p, st, jnp.asarray(m["feats"]), jc, N_QUERY, mode=mode,
                               corrupt_x=jnp.asarray(m["corrupt_x"]) if mode == "corrupt" else None,
                               unsup_stats=tuple(map(jnp.asarray, m["unsup"])) if mode == "unsup" else None)
        return jdn.dampnet_loss(s, 3, N_QUERY), s

    return loss


def _port_loss(m, mode):
    def loss(p):
        s = tdn.dampnet_scores(p, m["ts"], torch.from_numpy(m["feats"]), m["tc"], N_QUERY, mode=mode,
                               corrupt_x=torch.from_numpy(m["corrupt_x"]) if mode == "corrupt" else None,
                               unsup_stats=tuple(map(torch.from_numpy, m["unsup"])) if mode == "unsup" else None)
        return tdn.dampnet_loss(s, 3, N_QUERY), s

    return loss


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", ["full_class", "prototype"])
def test_scores_and_gradients_match_jax(models, variant, mode):
    m = models[variant]
    with jax.enable_x64():
        (want_loss, want_s), want_g = jax.jit(jax.value_and_grad(_jax_loss(m, mode), has_aux=True))(
            jax.tree.map(jnp.asarray, m["jp"]))
        want_g = jax.tree.map(np.asarray, want_g)
    loss, scores, grads = tsteps._value_and_grad(_port_loss(m, mode), m["tp"])
    assert scores.shape == (3 * N_QUERY, 3) and scores.dtype == torch.float64
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want_s), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-10)
    _close(grads, want_g, label=f"{variant}/{mode} grad ")
    if mode == "corrupt":
        lin = grads["fc"]["linear"]
        live = max(float(v.abs().max()) for v in lin.values())
        # the full family pins fc[0] on corrupt steps; the prototype variant pins nothing
        assert (live == 0.0) == (variant == "full_class"), live
        assert float(grads["layer1"]["w"].abs().max()) > 0.0 and float(grads["fc"]["bn"]["scale"].abs().max()) > 0.0


@pytest.mark.parametrize("variant", list(CFGS))
def test_recovered_projection_matches_jax(models, variant):
    m = models[variant]
    with jax.enable_x64():
        want = np.asarray(jdn.recovered_projection(jax.tree.map(jnp.asarray, m["jp"]), jax.tree.map(jnp.asarray, m["js"]),
                                                   jnp.asarray(m["feats"]), m["jc"]))
    got = tdn.recovered_projection(m["tp"], m["ts"], torch.from_numpy(m["feats"]), m["tc"])
    assert tuple(got.shape) == (3, 2 + N_QUERY, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------


def _identity_jax():
    return optax.GradientTransformation(lambda p: optax.EmptyState(), lambda g, s, p=None: (g, s))


IDENTITY = topt.Optimizer(lambda p: None, lambda g, s, p: (g, s))


@pytest.fixture(scope="module")
def backbone():
    p, s = jax.jit(lambda k: jbb.init_backbone(k, JCFG))(jax.random.PRNGKey(5))
    rs = np.random.RandomState(6)
    perturb = lambda a: np.asarray(a, np.float64) + (rs.rand(*np.shape(a)) * 0.2 if np.ndim(a) == 1 else 0)
    return jax.tree.map(perturb, p), jax.tree.map(perturb, s)


@pytest.mark.parametrize("mode", ["plain", "corrupt", "recover"])
@pytest.mark.parametrize("variant", ["full_class", "prototype"])
def test_train_step_matches_jax(models, backbone, variant, mode):
    """Two episodes a step: the loss, every gradient (the identity
    optimizer's update), the running stats averaged over the batch and the
    support banks; corrupt steps replay JAX's own corruption of each
    episode (its key split, its features) through ``corrupt_x``."""
    m = models[variant]
    jc, tc = m["jc"], m["tc"]
    spec_j, spec_t = jep.EpisodeSpec(3, 2, N_QUERY), tep.EpisodeSpec(3, 2, N_QUERY)
    fp, fs = backbone
    eps = np.random.RandomState(7).rand(2, 3, 2 + N_QUERY, 32, 32, 3)
    rng = jax.random.PRNGKey(8)
    with jax.enable_x64():
        jparams = jax.tree.map(jnp.asarray, {"feature": fp, **m["jp"]})
        jstats, jstate, jeps = jax.tree.map(jnp.asarray, fs), jax.tree.map(jnp.asarray, m["js"]), jnp.asarray(eps)
        corrupt_x = None
        if mode == "corrupt":  # before the step, which donates its weights
            keys = jax.random.split(rng, 2)
            corrupt_x = np.stack([
                np.asarray(jdn.sample_corruption(
                    k, jbb.apply_backbone(jparams["feature"], jstats, jep.flatten_episode(ep), cfg=JCFG, train=True,
                                          update_stats=True)[0], F, prototype=jc.variant == "prototype"))
                for ep, k in zip(jeps, keys)])
        tx = _identity_jax()
        new_p, new_s, _, met = jsteps.dampnet_train_step(jparams, jstats, tx.init(jparams), jstate, jeps, rng,
                                                         mode=mode, bcfg=JCFG, dcfg=jc, spec=spec_j, tx=tx)
        want_grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new_p,
                                  jax.tree.map(jnp.asarray, {"feature": fp, **m["jp"]}))
        want = (float(met["loss"]), jax.tree.map(np.asarray, new_s), np.asarray(met["support_bank"]))
    tp, ts = convert.from_jax({"feature": fp, **m["jp"]}, fs)
    teps = torch.from_numpy(np.ascontiguousarray(np.transpose(eps, (0, 1, 2, 5, 3, 4))))
    new_tp, new_ts, _, tmet = tsteps.dampnet_train_step(
        tp, ts, None, m["ts"], teps, None, mode=mode, bcfg=TCFG, dcfg=tc, spec=spec_t, tx=IDENTITY,
        corrupt_x=None if corrupt_x is None else torch.from_numpy(corrupt_x))
    np.testing.assert_allclose(float(tmet["loss"]), want[0], rtol=1e-10)
    grads = {k: (jax.tree.map(lambda a, b: a - b, new_tp[k], tp[k])) for k in tp}
    _close(grads, want_grads, rtol=1e-7, atol_frac=1e-10, label=f"{variant}/{mode} grad ")
    _close(new_ts, want[1], label="stats ")
    assert tuple(tmet["support_bank"].shape) == (2, 6, F) and not tmet["support_bank"].requires_grad
    np.testing.assert_allclose(tmet["support_bank"].numpy(), want[2], rtol=1e-10, atol=1e-13)
    if mode == "corrupt" and variant == "full_class":
        assert all(float(v.abs().max()) == 0.0 for v in grads["fc"]["linear"].values())


def test_train_step_adam_update_matches_jax(models, backbone):
    """One recover step with the drivers' Adam(1e-3): the updated weights."""
    from mft_tpu.train import optimizers as jopt

    m = models["full_class"]
    fp, fs = backbone
    eps = np.random.RandomState(9).rand(1, 3, 2 + N_QUERY, 32, 32, 3)
    with jax.enable_x64():
        jparams = jax.tree.map(jnp.asarray, {"feature": fp, **m["jp"]})
        tx = jopt.torch_adam(1e-3)
        new_p, _, _, _ = jsteps.dampnet_train_step(jparams, jax.tree.map(jnp.asarray, fs), tx.init(jparams),
                                                   jax.tree.map(jnp.asarray, m["js"]), jnp.asarray(eps),
                                                   jax.random.PRNGKey(0), mode="recover", bcfg=JCFG, dcfg=m["jc"],
                                                   spec=jep.EpisodeSpec(3, 2, N_QUERY), tx=tx)
        new_p = jax.tree.map(np.asarray, new_p)
    tp, ts = convert.from_jax({"feature": fp, **m["jp"]}, fs)
    tx = topt.torch_adam(1e-3)
    got, _, opt_state, _ = tsteps.dampnet_train_step(
        tp, ts, tx.init(tp), m["ts"], torch.from_numpy(np.ascontiguousarray(np.transpose(eps, (0, 1, 2, 5, 3, 4)))),
        None, mode="recover", bcfg=TCFG, dcfg=m["tc"], spec=tep.EpisodeSpec(3, 2, N_QUERY), tx=tx)
    assert opt_state["t"] == 1
    _close(got, new_p, rtol=1e-9, atol_frac=1e-9, label="adam ")


# --------------------------------------------------------------------------
# the eval member
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bn_mode", ["episode", "minibatch"])
def test_member_finetune_composition_matches_jax(models, backbone, bn_mode):
    """The live composition: the final block adapted with an explicit
    schedule (2 epochs, a ragged last minibatch), then domain-shift scores.
    Episode BN mode: ``gen_examples=0`` (no augment draws), the feature bank
    f32 in both packages, so f32 at atol 1e-4; minibatch mode: an explicit
    replica bank, f64."""
    m = models["full_class"]
    fp, fs = backbone
    spec_j, spec_t = jep.EpisodeSpec(3, 2, N_QUERY), tep.EpisodeSpec(3, 2, N_QUERY)
    rs = np.random.RandomState(10)
    size = 64 if bn_mode == "episode" else 32
    gen_examples = 0 if bn_mode == "episode" else 1
    rows = (gen_examples + 3) * 6
    perms = np.stack([rs.permutation(rows) for _ in range(2)])
    icfg_j, icfg_t = jil.InnerLoopCfg(2, 5, rows), til.InnerLoopCfg(2, 5, rows)
    if bn_mode == "episode":
        base = rs.randint(0, 256, (3, 2 + N_QUERY, int(size * 1.15), int(size * 1.15), 3)).astype(np.uint8)
        dt = np.float32
    else:
        episode = rs.rand(3, 2 + N_QUERY, size, size, 3)
        bank = np.concatenate([np.stack([episode[:, :2]] * 3), rs.rand(1, 3, 2, size, size, 3)])
        dt = np.float64
    cast = lambda t: jax.tree.map(lambda a: np.asarray(a, dt) if np.issubdtype(np.asarray(a).dtype, np.floating)
                                  else np.asarray(a), t)
    fp_, fs_, dp_, ds_ = cast(fp), cast(fs), cast(m["jp"]), cast(m["js"])
    jt = jee.TransferCfg(fine_tune_epochs=2, bn_mode=bn_mode, opt_state_dtype="float32")
    kw = dict(bcfg=JCFG, dcfg=m["jc"], spec=spec_j, tcfg=jt, aug_cfg=jaug.AugmentCfg(image_size=size),
              gen_examples=gen_examples, inner_schedule=jil.schedule_from_perms(perms, icfg_j))
    k = jax.random.PRNGKey(0)
    with jax.enable_x64(dt == np.float64):
        args = jax.tree.map(jnp.asarray, (fp_, fs_, dp_, ds_))
        if bn_mode == "episode":
            ep_j, bank_j = jaug.center_batch(jnp.asarray(base), size), jnp.asarray(base[:, :2])
        else:
            ep_j, bank_j = jnp.asarray(episode), jnp.asarray(bank)
        want = np.asarray(jax.jit(lambda a, e, b: jee.dampnet_member_scores(*a, e, b, k, k, **kw))(args, ep_j, bank_j))
    tfp, tfs = convert.from_jax(fp_, fs_)
    tdp, tds = convert.from_jax(dp_, ds_)
    if bn_mode == "episode":
        tbase = torch.from_numpy(base).permute(0, 1, 4, 2, 3)
        ep_t, bank_t = taug.center_batch(tbase, size), tbase[:, :2]
    else:
        nchw = lambda x: torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))
        ep_t, bank_t = nchw(episode), nchw(bank)
    tt = tee.TransferCfg(fine_tune_epochs=2, bn_mode=bn_mode, opt_state_dtype="float32")
    got = tee.dampnet_member_scores(tfp, tfs, tdp, tds, ep_t, bank_t, None, bcfg=TCFG, dcfg=m["tc"], spec=spec_t,
                                    tcfg=tt, aug_cfg=taug.AugmentCfg(image_size=size), gen_examples=gen_examples,
                                    inner_schedule=til.schedule_from_perms(perms, icfg_t)).numpy()
    assert got.shape == (3 * N_QUERY, 3)
    if bn_mode == "episode":
        np.testing.assert_allclose(got, want, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("variant", ["full_class", "prototype"])
def test_member_nofinetune_without_fusion_matches_jax(models, backbone, variant):
    m = models[variant]
    fp, fs = backbone
    episode = np.random.RandomState(11).rand(3, 2 + N_QUERY, 32, 32, 3)
    kw = dict(bcfg=JCFG, dcfg=m["jc"], spec=jep.EpisodeSpec(3, 2, N_QUERY), tcfg=jee.TransferCfg(),
              eval_mode="nofinetune", with_linear_fusion=False)
    with jax.enable_x64():
        a = jax.tree.map(jnp.asarray, (fp, fs, m["jp"], m["js"]))
        k = jax.random.PRNGKey(0)
        want = np.asarray(jee.dampnet_member_scores(*a, jnp.asarray(episode), None, k, k, **kw))
    tfp, tfs = convert.from_jax(fp, fs)
    got = tee.dampnet_member_scores(tfp, tfs, m["tp"], m["ts"], torch.from_numpy(np.moveaxis(episode, -1, -3).copy()),
                                    None, None, bcfg=TCFG, dcfg=m["tc"], spec=tep.EpisodeSpec(3, 2, N_QUERY),
                                    tcfg=tee.TransferCfg(), aug_cfg=None, eval_mode="nofinetune",
                                    with_linear_fusion=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_member_compositions_on_the_program():
    """Through ``make_eval_program``: nofinetune with the probe (row sums
    1.5), unsup, and the live composition with the eager inner loop and
    with the fused scan's plain version (row sums 1)."""
    spec, tc = tep.EpisodeSpec(3, 2, 2), CFGS["full_class"][1]
    gen = torch.Generator().manual_seed(0)
    fp, fs = tbb.init_backbone(gen, TCFG)
    dp, ds = tdn.init_dampnet(gen, tc)
    ds = tdn.update_prototypes(ds, torch.randn(30, F, generator=gen))
    base = torch.randint(0, 256, (3, 4, 3, 36, 36), dtype=torch.uint8, generator=gen)
    unsup = {"unsup_stats": (torch.zeros(F), torch.ones(F))}
    for eval_mode, extra, inner_scan, total in (("nofinetune", {}, "eager", 1.5), ("finetune", unsup, "eager", 1.0),
                                                ("finetune", {}, "eager", 1.0), ("finetune", {}, "fused", 1.0)):
        tcfg = tee.TransferCfg(fine_tune_epochs=1, inner_scan=inner_scan)
        program = tee.make_eval_program(method="dampnet_full_class", bcfg=TCFG, gcfg=None, spec=spec, tcfg=tcfg,
                                        aug_cfg=taug.AugmentCfg(image_size=32), gen_examples=1, dcfg=tc,
                                        dampnet_eval=eval_mode)
        scores, accs = program({"dampnet": (fp, fs, dp, ds), **extra}, base[None], [torch.Generator().manual_seed(1)])
        assert tuple(scores.shape) == (1, 6, 3) and torch.isfinite(scores).all() and 0.0 <= accs[0] <= 100.0
        np.testing.assert_allclose(scores[0].sum(1).numpy(), np.full(6, total), rtol=1e-5)


# --------------------------------------------------------------------------
# the corruption
# --------------------------------------------------------------------------


def _jax_draws(key, f, prototype):
    """The draws of JAX's ``sample_corruption(key, ...)``, from its key splits."""
    ks = jax.random.split(key, 9)
    if prototype:
        perc, perc_zeros, m_fac = 0.6, 0.3, 1.5
    else:
        perc = float(jax.random.uniform(ks[0], (), minval=0.1, maxval=0.9))
        perc_zeros = float(jax.random.uniform(ks[1], (), minval=0.1, maxval=0.9))
        m_fac = float(jax.random.uniform(ks[2], (), minval=1.5, maxval=5.0))
    n_sel = int(np.floor(np.float32(f) * np.float32(perc)))
    ri2 = np.asarray(jax.random.randint(ks[5], (f,), 0, f))
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    return {"perc": perc, "perc_zeros": perc_zeros, "m_fac": m_fac, "order": t(jax.random.permutation(ks[3], f)),
            "ri": t(jax.random.randint(ks[4], (f,), 0, f)), "ri2": t(ri2),
            "rand_col": int(ri2[int(jax.random.randint(ks[6], (), 0, max(n_sel, 1)))]),
            "t_sample": torch.from_numpy(np.asarray(jax.random.t(ks[7], 5.0, (f, f)))),
            "sign_perm": t(jax.random.permutation(ks[8], f)),
            "t_bias": torch.from_numpy(np.asarray(jax.random.t(jax.random.fold_in(key, 99), 5.0, (f,))))}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("prototype", [False, True])
def test_apply_corruption_matches_jax_sample_corruption(prototype, seed):
    f = 64
    key = jax.random.PRNGKey(seed)
    x = np.random.RandomState(seed).randn(12, f).astype(np.float32)
    want = np.asarray(jdn.sample_corruption(key, jnp.asarray(x), f, prototype=prototype))
    got = tdn.apply_corruption(torch.from_numpy(x), _jax_draws(key, f, prototype), scale_bias=not prototype).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_corruption_structure():
    """The port's own sampler: with no selected lane the matrix is the 0/1
    diagonal with floor(f * perc_zeros) zeros and the bias is 0; the full
    family scales the bias by m_fac, the prototype variant does not; only
    the selected lanes write the bias (tests/test_dampnet.py:181), though
    unselected lanes collide with selected ones."""
    f = 64
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        d = tdn.draw_corruption(gen, f, prototype=False)
        assert 0.1 <= d["perc"] <= 0.9 and 0.1 <= d["perc_zeros"] <= 0.9 and 1.5 <= d["m_fac"] <= 5.0
        matrix, bias, _ = tdn.corruption_terms({**d, "perc": 0.0}, f)
        assert torch.equal(matrix, torch.diag(torch.diagonal(matrix)))
        assert int((torch.diagonal(matrix) == 0).sum()) == math.floor(f * d["perc_zeros"])
        assert not bias.any()
    zeros = torch.zeros(3, f)
    for prototype in (False, True):
        d = tdn.draw_corruption(gen, f, prototype=prototype)
        scaled = tdn.apply_corruption(zeros, d, scale_bias=True)
        unscaled = tdn.apply_corruption(zeros, d, scale_bias=False)
        assert float(unscaled.abs().max()) > 0
        torch.testing.assert_close(scaled, d["m_fac"] * unscaled, rtol=1e-6, atol=0)
        # sample_corruption: one draw, the variant's bias rule
        d5 = tdn.draw_corruption(torch.Generator().manual_seed(5), f, prototype=prototype)
        torch.testing.assert_close(tdn.sample_corruption(torch.Generator().manual_seed(5), zeros, prototype=prototype),
                                   tdn.apply_corruption(zeros, d5, scale_bias=not prototype))
    d = tdn.draw_corruption(torch.Generator().manual_seed(7), f, prototype=True)
    n_sel = math.floor(0.6 * f)
    selected = set(d["ri2"][:n_sel].tolist())
    assert selected & set(d["ri2"][n_sel:].tolist())
    out = tdn.apply_corruption(torch.zeros(1, f), d, scale_bias=False)[0]
    assert set(torch.nonzero(out).flatten().tolist()) == selected


def test_student_t5_variance():
    """t(5) has variance 5 / 3; 1e6 draws put the sample variance within
    0.3 % (one standard error) of it, so 2 % is some seven standard errors."""
    x = tdn.student_t5(torch.Generator().manual_seed(0), (1_000_000,)).double()
    assert abs(float(x.mean())) < 0.01
    assert float(x.var()) == pytest.approx(5.0 / 3.0, rel=0.02)
