"""The eval engine's knobs in the port (``TransferCfg``), each against its
counterpart of the JAX identity tests in tests/test_eval_engine.py, on
episode lanes in f64 (narrow widths, 32 px; the weights and episodes of
tests/test_torch_eval_lanes.py):

* ``ensemble_fuse='lane'`` equals ``'seq'`` (:92) with unequal member
  epochs, rtol 1e-10; and equals JAX ``_fused_ensemble_scores`` given the
  same explicit draws (classifier init and schedules patched into both
  packages), rtol 1e-8;
* ``fanout_group_pass`` (:116, :159): the grouped fan-out equals one group
  a pass (the bank rtol 1e-12, the scores 1e-8); groups past 128 images
  take the one-group path bit for bit, and that sub-chunked bank equals
  JAX's, rtol 1e-10;
* ``inner_gather='epoch'`` equals ``'step'`` (:266), rtol 1e-10;
* ``inner_carry='flat'`` equals ``'tree'`` (:349), rtol 1e-10;
* ``freeze_backbone`` (:285): each member's frozen path against JAX, f64
  rtol 1e-8.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.core import episode as jep
from mft_tpu.methods import gnnnet as jgn
from mft_tpu.methods import protonet as jpn
from mft_tpu.models import backbone as jbb
from mft_tpu.ops import augment as jaug
from mft_tpu.train import eval_engine as jee
from mft_tpu.train import inner_loop as jil
from mft_tpu_torch.core import episode as tep
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops import augment as taug
from mft_tpu_torch.train import eval_engine as tee
from mft_tpu_torch.train import inner_loop as til
from tests.test_torch_eval_lanes import (  # noqa: F401  (setup, _one_torch_thread: fixtures)
    GKW, JCFG, SIZE, SPEC, TCFG, _one_torch_thread, _port_inputs, _port_member, setup)

LANES = 2
RTOL = 1e-10


def _ensemble(s, tcfg, gen_examples=1, seed=40):
    t = s["t"]
    episodes, supports = _port_inputs(s["base"][:LANES])
    gens = [torch.Generator().manual_seed(seed + i) for i in range(LANES)]
    return tee.ensemble_lanes(*t["baseline"], *t["gnn"], t["head"], episodes, supports, gens, bcfg=TCFG,
                              gcfg=tgn.GnnNetCfg(**GKW), spec=tep.EpisodeSpec(*SPEC), tcfg=tcfg,
                              aug_cfg=taug.AugmentCfg(image_size=SIZE), gen_examples=gen_examples)


def _nhwc(t):
    return np.ascontiguousarray(np.moveaxis(t.numpy(), -3, -1))


def _jax_call(fn):
    """``fn`` jitted once, run in x64 on the port's clean views
    (``center_batch`` passes its input through; see
    tests/test_torch_eval_lanes.py ``_jax_member``)."""
    jitted = jax.jit(fn)

    def call(*args):
        with jax.enable_x64(), mock.patch.object(jaug, "center_batch", lambda images, *a, **k: images):
            return np.asarray(jitted(*jax.tree.map(jnp.asarray, args)))

    return call


# --------------------------------------------------------------------------
# ensemble_fuse
# --------------------------------------------------------------------------


def test_ensemble_fuse_lane_matches_seq(setup):
    """Unequal member epochs, so both the shared steps and the GNN
    member's tail run; the same draws as the sequential members."""
    tcfg = tee.TransferCfg(fine_tune_epochs=3, linear_epochs=2, opt_state_dtype="float32")
    seq = _ensemble(setup, tcfg)
    with mock.patch.object(tee, "inner_fit_pair", wraps=tee.inner_fit_pair) as spy:
        lane = _ensemble(setup, tcfg._replace(ensemble_fuse="lane"))
    assert spy.call_count == 1 and seq.shape == (LANES, 6, 3)
    np.testing.assert_allclose(lane.numpy(), seq.numpy(), rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(seq.sum(-1).numpy(), 2.0, rtol=1e-12)
    # where the JAX package falls back to 'seq', so does the port (and under the fused scan)
    for knob in (dict(inner_gather="epoch"), dict(inner_carry="flat"), dict(freeze_backbone=True)):
        with mock.patch.object(tee, "inner_fit_pair", side_effect=AssertionError("must fall back to 'seq'")):
            _ensemble(setup, tcfg._replace(ensemble_fuse="lane", fine_tune_epochs=1, linear_epochs=1, **knob))


def test_ensemble_fuse_lane_matches_jax(setup):
    """Port ``ensemble_fuse='lane'`` on two lanes against JAX
    ``_fused_ensemble_scores`` on each episode: the classifier init and
    both members' schedules patched into both packages (no augment draws)."""
    rs = np.random.RandomState(8)
    spec = tep.EpisodeSpec(*SPEC)
    icfgs = {spec.support_size: til.InnerLoopCfg(2, 5, spec.support_size),
             3 * spec.support_size: til.InnerLoopCfg(3, 5, 3 * spec.support_size)}
    perms = [{n: np.stack([rs.permutation(n) for _ in range(c.epochs)]) for n, c in icfgs.items()}
             for _ in range(LANES)]
    heads = [{"w": rs.randn(GKW["feat_dim"], 3) * 0.2, "b": rs.randn(3) * 0.1} for _ in range(LANES)]
    lane_sched = lambda gens, cfg, dev: til.stack_schedules(
        [til.schedule_from_perms(p[cfg.bank_size], cfg) for p in perms])
    lane_heads = {"w": torch.from_numpy(np.stack([h["w"].T for h in heads])),
                  "b": torch.from_numpy(np.stack([h["b"] for h in heads]))}
    tcfg = tee.TransferCfg(fine_tune_epochs=3, linear_epochs=2, opt_state_dtype="float32", ensemble_fuse="lane")
    with mock.patch.object(tee, "lane_schedule", lane_sched), \
            mock.patch.object(tee, "_draw_heads", lambda *a: lane_heads):
        got = _ensemble(setup, tcfg, gen_examples=0)
    j, jspec = setup["j"], jep.EpisodeSpec(*SPEC)
    jtcfg = jee.TransferCfg(fine_tune_epochs=3, linear_epochs=2, opt_state_dtype="float32", ensemble_fuse="lane")

    def run(ep, sup, p_lin, p_gnn, head0):
        k = jax.random.PRNGKey(0)
        sched = {p_lin.shape[1]: p_lin, p_gnn.shape[1]: p_gnn}
        cfgs = {n: jil.InnerLoopCfg(c.epochs, 5, n) for n, c in icfgs.items()}
        with mock.patch.object(jil, "minibatch_schedule", lambda key, cfg: jil.schedule_from_perms(
                sched[cfg.bank_size], cfgs[cfg.bank_size])), \
                mock.patch.object(jee, "init_classifier", lambda *a, **k: head0):
            return jee.ensemble_episode_scores(*j["baseline"], *j["gnn"], j["head"], ep, sup, k, k, bcfg=JCFG,
                                               gcfg=jgn.GnnNetCfg(**GKW), spec=jspec, tcfg=jtcfg,
                                               aug_cfg=jaug.AugmentCfg(image_size=SIZE), gen_examples=0)

    episodes, supports = _port_inputs(setup["base"][:LANES])
    views = taug.center_batch(supports, SIZE)
    call = _jax_call(run)
    for i in range(LANES):
        want = call(_nhwc(episodes[i]), _nhwc(views[i]), perms[i][spec.support_size],
                    perms[i][3 * spec.support_size], heads[i])
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-8, atol=1e-12)


# --------------------------------------------------------------------------
# fanout_group_pass
# --------------------------------------------------------------------------


def test_fanout_group_pass_matches(setup):
    """``gen_examples=3`` (four replica groups): two and four groups a pass
    equal one group a pass, the same augment draws from each lane's
    generator; the GNN member's scores follow."""
    p, s = setup["t"]["gnn"]
    trunk = [tbb.adapt_split(t)[0] for t in (p, s)]
    _, supports = _port_inputs(setup["base"][:LANES])

    def fmap(gp):
        gens = [torch.Generator().manual_seed(50 + i) for i in range(LANES)]
        return tee._bank_fmap(*trunk, supports, gens, bcfg=TCFG, aug_cfg=taug.AugmentCfg(image_size=SIZE),
                              gen_examples=3, group_pass=gp)

    base = fmap(1)
    assert base.shape[:2] == (LANES, 6 * 6)
    for gp in (2, 4):
        np.testing.assert_allclose(fmap(gp).numpy(), base.numpy(), rtol=1e-12, atol=1e-14)
    episodes, supports = _port_inputs(setup["base"][:LANES])
    tcfg = tee.TransferCfg(fine_tune_epochs=1, opt_state_dtype="float32")
    scores = {gp: _port_member(setup, "gnn", episodes, supports, [torch.Generator().manual_seed(60 + i)
                                                                   for i in range(LANES)],
                               tcfg._replace(fanout_group_pass=gp), gen_examples=3) for gp in (1, 4)}
    np.testing.assert_allclose(scores[4].numpy(), scores[1].numpy(), rtol=1e-8, atol=1e-12)


def test_fanout_group_pass_large_groups_fall_back_and_match_jax(setup):
    """130-image groups (past the 128-image BN sub-chunk): ``group_pass=2``
    takes the one-group path bit for bit; the sub-chunked clean bank (two
    65-image BN chunks a group) equals JAX's."""
    p, s = setup["t"]["gnn"]
    trunk = [tbb.adapt_split(t)[0] for t in (p, s)]
    support = torch.from_numpy(np.random.RandomState(9).randint(0, 256, (1, 5, 26, 3, 20, 20)).astype(np.uint8))
    aug = taug.AugmentCfg(image_size=16)

    def fmap(gp, gen_examples=1):
        return tee._bank_fmap(*trunk, support, [torch.Generator().manual_seed(3)], bcfg=TCFG, aug_cfg=aug,
                              gen_examples=gen_examples, group_pass=gp)

    assert torch.equal(fmap(2), fmap(1))
    got = fmap(1, gen_examples=0)[0]
    jp, js = setup["j"]["gnn"]
    jtrunk = [jbb.adapt_split(t)[0] for t in (jp, js)]
    call = _jax_call(lambda sup: jee._bank_fmap(*jtrunk, sup, None, bcfg=JCFG, aug_cfg=jaug.AugmentCfg(image_size=16),
                                                gen_examples=0, bn_train=True))
    want = call(_nhwc(taug.center_batch(support[0], 16)))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=1e-10, atol=1e-12)


# --------------------------------------------------------------------------
# inner_gather, inner_carry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("knob", [dict(inner_gather="epoch"), dict(inner_carry="flat")])
def test_inner_gather_and_carry_equal_the_default(setup, knob):
    """The epoch-wise gather and the flat carry on the ensemble's two
    members (with and without a head, ragged last minibatches): the same
    numbers as the per-step gather on the tree carry."""
    tcfg = tee.TransferCfg(fine_tune_epochs=2, linear_epochs=3, opt_state_dtype="float32")
    want = _ensemble(setup, tcfg)
    got = _ensemble(setup, tcfg._replace(**knob))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=1e-13)


def test_inner_gather_epoch_replays_an_explicit_schedule(setup):
    """With an explicit schedule the epoch-wise gather takes its
    permutations from it: the GNN member equals the per-step gather."""
    rs = np.random.RandomState(10)
    spec = tep.EpisodeSpec(*SPEC)
    icfg = til.InnerLoopCfg(2, 5, 3 * spec.support_size)
    sched = til.stack_schedules([til.schedule_from_perms(np.stack([rs.permutation(icfg.bank_size)
                                                                   for _ in range(2)]), icfg) for _ in range(LANES)])
    episodes, supports = _port_inputs(setup["base"][:LANES])
    tcfg = tee.TransferCfg(fine_tune_epochs=2, opt_state_dtype="float32")
    out = {g: _port_member(setup, "gnn", episodes, supports, [None] * LANES, tcfg._replace(inner_gather=g),
                           gen_examples=0, inner_schedule=sched) for g in ("step", "epoch")}
    np.testing.assert_allclose(out["epoch"].numpy(), out["step"].numpy(), rtol=RTOL, atol=1e-13)


# --------------------------------------------------------------------------
# freeze_backbone
# --------------------------------------------------------------------------


@pytest.mark.parametrize("member", ["gnn", "linear", "protonet", "dampnet"])
def test_freeze_backbone_matches_jax(setup, member):
    """``--freeze_backbone``: the GNN, ProtoNet and DampNet members adapt
    nothing and embed with running statistics (no draws); the linear member
    trains its head alone on the running-statistics block (explicit schedule
    and init).  Each lane against the JAX member, f64 rtol 1e-8."""
    rs = np.random.RandomState(11)
    spec, jspec = tep.EpisodeSpec(*SPEC), jep.EpisodeSpec(*SPEC)
    icfg = til.InnerLoopCfg(2, 5, spec.support_size)
    perms = [np.stack([rs.permutation(spec.support_size) for _ in range(2)]) for _ in range(LANES)]
    heads = [{"w": rs.randn(GKW["feat_dim"], 3) * 0.2, "b": rs.randn(3) * 0.1} for _ in range(LANES)]
    kw = {}
    if member == "linear":
        kw = dict(inner_schedule=til.stack_schedules([til.schedule_from_perms(p, icfg) for p in perms]),
                  head0={"w": torch.from_numpy(np.stack([h["w"].T for h in heads])),
                         "b": torch.from_numpy(np.stack([h["b"] for h in heads]))})
    tcfg = tee.TransferCfg(fine_tune_epochs=2, linear_epochs=2, opt_state_dtype="float32", freeze_backbone=True)
    episodes, supports = _port_inputs(setup["base"][:LANES])
    got = _port_member(setup, member, episodes, supports, [None] * LANES, tcfg, gen_examples=0, **kw)
    j = setup["j"]
    jtcfg = jee.TransferCfg(fine_tune_epochs=2, linear_epochs=2, opt_state_dtype="float32", freeze_backbone=True)
    jkw = dict(bcfg=JCFG, spec=jspec, tcfg=jtcfg, aug_cfg=jaug.AugmentCfg(image_size=SIZE), gen_examples=0)

    def run(ep, sup, perm, head0):
        k = jax.random.PRNGKey(0)
        if member == "linear":
            return jee.linear_member_scores(*j["baseline"], ep, sup, k, k, head0=head0,
                                            inner_schedule=jil.schedule_from_perms(perm, jil.InnerLoopCfg(2, 5, 6)),
                                            **jkw)
        if member == "gnn":
            return jee.gnn_member_scores(*j["gnn"], j["head"], ep, sup, k, k, gcfg=jgn.GnnNetCfg(**GKW), **jkw)
        if member == "protonet":
            return jee.proto_member_scores(*j["gnn"], ep, sup, k, k, **jkw)
        return jee.dampnet_member_scores(*j["gnn"], *j["damp"], ep, sup, k, k, dcfg=setup["jc"], **jkw)

    call = _jax_call(run)
    views = taug.center_batch(supports, SIZE)
    for i in range(LANES):
        want = call(_nhwc(episodes[i]), _nhwc(views[i]), perms[i], heads[i])
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-8, atol=1e-12)
    if member != "linear":  # nothing adapts: no draws, the same scores from any generator
        again = _port_member(setup, member, episodes, supports, [torch.Generator().manual_seed(i) for i in (1, 2)],
                             tcfg, gen_examples=1)
        np.testing.assert_array_equal(again.numpy(), got.numpy())
