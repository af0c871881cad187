"""Episode lanes of DampNet's eval scoring and probe: E episodes in one
call of the recovery network and the GNN, and one lane-stacked probe loop.

* ``dampnet_scores`` (modes 'domain_shift' and 'unsup') and
  ``recovered_projection`` on ``[E, n_way, slots, f]`` equal each lane
  alone, f64 rtol 1e-10, and ``jax.vmap`` of the JAX functions, f64 rtol
  1e-8, on the three variants (class statistic, support statistic, the
  prototype variant's normalized projection).
* ``dampnet_probe_lanes`` at explicit schedules and heads equals
  ``dampnet_probe`` lane by lane (rtol 1e-10): one loop for the batch
  (700 steps at 5-way 5-shot).
* ``dampnet_member_lanes`` in its four compositions (live, frozen
  ``finetune``, ``nofinetune`` with the probe, ``--unsupervised``) on E = 3
  episodes drawn from their own generators equals each episode alone, and
  leaves each generator where the episode alone leaves it; one
  ``dampnet_scores`` call and one probe loop a batch.
* A planted fault, one probe head init shared by all lanes, fails the
  lanes-against-alone check.

Tiny heads (NTN width 8, MLP width 16) on widths (8, 12, 14, 16) at 32 px.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.methods import dampnet as jdn
from mft_tpu.models import backbone as jbb
from mft_tpu_torch import convert
from mft_tpu_torch.core import episode as tep
from mft_tpu_torch.methods import dampnet as tdn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops import augment as taug
from mft_tpu_torch.train import eval_engine as tee
from mft_tpu_torch.train import inner_loop as til

F = 16
SMALL = dict(feat_dim=F, n_way=3, n_support=2, gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16)
VARIANTS = {
    "full_class": (jdn.DampNetCfg(**SMALL, stat="class"), tdn.DampNetCfg(**SMALL, stat="class")),
    "full": (jdn.DampNetCfg(**SMALL, stat="support"), tdn.DampNetCfg(**SMALL, stat="support")),
    "prototype": (jdn.prototype_cfg(F, 3, 2)._replace(gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16, mlp_hidden2=12,
                                                       store_len=4),
                  tdn.prototype_cfg(F, 3, 2)._replace(gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16, mlp_hidden2=12,
                                                       store_len=4)),
}
TCFG = tbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, F), compute_dtype="float64")
SPEC = (3, 2, 2)  # n_way, n_support, n_query
LANES = 3
SIZE = 32
BASE = int(SIZE * 1.15)
COMPOSITIONS = ("live", "frozen", "nofinetune", "unsup")


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


@pytest.fixture(scope="module")
def models():
    """Per variant: JAX params and a filled state (f64 numpy), the port's
    copies, LANES episodes of features and unlabeled statistics."""
    out = {}
    rs = np.random.RandomState(0)
    for i, (name, (jc, tc)) in enumerate(VARIANTS.items()):
        params, state = jax.jit(lambda k, c=jc: jdn.init_dampnet(k, c))(jax.random.PRNGKey(i))
        params = _f64(params)
        with jax.enable_x64():
            state = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                                 else jnp.asarray(a), state)
            state = jax.tree.map(np.asarray, jdn.update_prototypes(state, jnp.asarray(rs.randn(40, F))))
        tp, ts = convert.from_jax(params, state)
        feats = rs.randn(LANES, SPEC[0], SPEC[1] + SPEC[2], F) * (1.0 + np.arange(LANES))[:, None, None, None]
        out[name] = dict(jc=jc, tc=tc, jp=params, js=state, tp=tp, ts=ts, feats=feats,
                         unsup=(rs.randn(F), np.abs(rs.randn(F))))
    return out


def _scores(m, feats, mode):
    kw = {"unsup_stats": tuple(torch.from_numpy(v) for v in m["unsup"])} if mode == "unsup" else {}
    return tdn.dampnet_scores(m["tp"], m["ts"], feats, m["tc"], SPEC[2], mode=mode, **kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", ["domain_shift", "unsup"])
def test_dampnet_scores_lanes_equal_each_lane_and_jax_vmap(models, variant, mode):
    m = models[variant]
    feats = torch.from_numpy(m["feats"])
    got = _scores(m, feats, mode)
    assert got.shape == (LANES, SPEC[0] * SPEC[2], SPEC[0]) and got.dtype == torch.float64
    for i in range(LANES):
        np.testing.assert_allclose(got[i].numpy(), _scores(m, feats[i], mode).numpy(), rtol=1e-10, atol=1e-13)
    assert not np.allclose(got[0].numpy(), got[1].numpy(), atol=1e-6)
    with jax.enable_x64():
        p, st = jax.tree.map(jnp.asarray, m["jp"]), jax.tree.map(jnp.asarray, m["js"])
        kw = {"unsup_stats": tuple(jnp.asarray(v) for v in m["unsup"])} if mode == "unsup" else {}
        want = np.asarray(jax.jit(jax.vmap(lambda f: jdn.dampnet_scores(p, st, f, m["jc"], SPEC[2], mode=mode, **kw)))(
            jnp.asarray(m["feats"])))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_recovered_projection_lanes_equal_each_lane_and_jax_vmap(models, variant):
    m = models[variant]
    feats = torch.from_numpy(m["feats"])
    got = tdn.recovered_projection(m["tp"], m["ts"], feats, m["tc"])
    assert got.shape == (LANES, SPEC[0], SPEC[1] + SPEC[2], 16)
    for i in range(LANES):
        one = tdn.recovered_projection(m["tp"], m["ts"], feats[i], m["tc"])
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=1e-10, atol=1e-13)
    with jax.enable_x64():
        p, st = jax.tree.map(jnp.asarray, m["jp"]), jax.tree.map(jnp.asarray, m["js"])
        want = np.asarray(jax.vmap(lambda f: jdn.recovered_projection(p, st, f, m["jc"]))(jnp.asarray(m["feats"])))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)


def test_corrupt_mode_refuses_a_lane_batch(models):
    m = models["full_class"]
    with pytest.raises(ValueError, match="one episode"):
        tdn.dampnet_scores(m["tp"], m["ts"], torch.from_numpy(m["feats"]), m["tc"], SPEC[2], mode="corrupt",
                           gen=torch.Generator().manual_seed(0))


def test_probe_lanes_equal_the_probe_lane_by_lane(models):
    """Explicit schedules (6 support rows in minibatches of 4: a ragged
    second step each epoch) and heads: the lane-stacked probe equals
    ``dampnet_probe`` on each lane, its 200 steps (700 at 5-way 5-shot) one
    loop for the batch."""
    m = models["full_class"]
    spec = tep.EpisodeSpec(*SPEC)
    rs = np.random.RandomState(4)
    icfg = til.InnerLoopCfg(100, 4, spec.support_size)
    scheds = [til.schedule_from_perms(np.stack([rs.permutation(spec.support_size) for _ in range(100)]), icfg)
              for _ in range(LANES)]
    heads = [{"w": torch.from_numpy(rs.randn(3, 16) * 0.2), "b": torch.from_numpy(rs.randn(3) * 0.1)}
             for _ in range(LANES)]
    feats = torch.from_numpy(m["feats"])
    steps = []
    real_step = til._step
    with mock.patch.object(til, "_step", lambda *a: (steps.append(1), real_step(*a))):
        head, z_query = tee.dampnet_probe_lanes(m["tp"], m["ts"], feats, [None] * LANES, dcfg=m["tc"], spec=spec,
                                                schedule=til.stack_schedules(scheds),
                                                head0={k: torch.stack([h[k] for h in heads]) for k in ("w", "b")})
    assert len(steps) == icfg.n_steps == 200 and z_query.shape == (LANES, spec.query_size, 16)
    for i in range(LANES):
        h1, z1 = tee.dampnet_probe(m["tp"], m["ts"], feats[i], None, dcfg=m["tc"], spec=spec, schedule=scheds[i],
                                   head0=heads[i])
        np.testing.assert_allclose(z_query[i].numpy(), z1.numpy(), rtol=1e-10, atol=1e-13)
        for k in ("w", "b"):
            np.testing.assert_allclose(head[k][i].numpy(), h1[k].numpy(), rtol=1e-10, atol=1e-13)


# --------------------------------------------------------------------------
# the member: four compositions, lanes against each episode alone
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def member_inputs(models):
    """A tiny f64 backbone (JAX init, BN parameters and stats perturbed),
    LANES episodes of uint8 images, the full_class heads."""
    rs = np.random.RandomState(5)
    perturb = lambda a: np.asarray(a, np.float64) + (rs.rand(*np.shape(a)) * 0.2 if np.ndim(a) == 1 else 0)
    jcfg = jbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, F), "simple", flatten=True)
    p, s = jax.jit(lambda k: jbb.init_backbone(k, jcfg))(jax.random.PRNGKey(7))
    bp, bs = convert.from_jax(jax.tree.map(perturb, p), jax.tree.map(perturb, s))
    base = rs.randint(0, 256, (LANES, SPEC[0], SPEC[1] + SPEC[2], BASE, BASE, 3)).astype(np.uint8)
    tb = torch.from_numpy(base).permute(0, 1, 2, 5, 3, 4)
    m = models["full_class"]
    return dict(backbone=(bp, bs), damp=(m["tp"], m["ts"]), dcfg=m["tc"], episodes=taug.center_batch(tb, SIZE),
                supports=tb[:, :, : SPEC[1]], unsup=tuple(torch.from_numpy(v) for v in m["unsup"]))


def _member(inp, composition, lanes: slice, seeds):
    tcfg = tee.TransferCfg(fine_tune_epochs=1, opt_state_dtype="float32",
                           freeze_backbone=composition == "frozen")
    kw = dict(bcfg=TCFG, dcfg=inp["dcfg"], spec=tep.EpisodeSpec(*SPEC), tcfg=tcfg,
              aug_cfg=taug.AugmentCfg(image_size=SIZE), gen_examples=1,
              eval_mode="nofinetune" if composition == "nofinetune" else "finetune",
              unsup_stats=inp["unsup"] if composition == "unsup" else None)
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    out = tee.dampnet_member_lanes(*inp["backbone"], *inp["damp"], inp["episodes"][lanes], inp["supports"][lanes],
                                   gens, **kw)
    return out, [torch.rand(1, generator=g).item() for g in gens]


@pytest.mark.parametrize("composition", COMPOSITIONS)
def test_member_lanes_equal_each_episode_alone(member_inputs, composition):
    seeds = [50 + i for i in range(LANES)]
    calls = []
    real = tee.dampnet_scores
    with mock.patch.object(tee, "dampnet_scores", lambda *a, **k: (calls.append(1), real(*a, **k))[1]):
        got, after = _member(member_inputs, composition, slice(None), seeds)
    assert len(calls) == 1 and got.shape == (LANES, SPEC[0] * SPEC[2], SPEC[0]) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.5 if composition == "nofinetune" else 1.0, rtol=1e-12)
    for i in range(LANES):
        one, after_one = _member(member_inputs, composition, slice(i, i + 1), seeds[i : i + 1])
        np.testing.assert_allclose(got[i].numpy(), one[0].numpy(), rtol=1e-10, atol=1e-13)
        assert after_one[0] == after[i]
    assert not np.allclose(got[0].numpy(), got[1].numpy(), atol=1e-6)


def test_nofinetune_runs_one_probe_loop_a_batch(member_inputs):
    """One probe loop for the batch: 100 epochs of the 6 support rows in
    minibatches of 4 (700 steps at 5-way 5-shot), not one loop a lane."""
    fits = []
    real = tee.inner_fit
    with mock.patch.object(tee, "inner_fit", lambda *a, **k: (fits.append(a[4].n_steps), real(*a, **k))[1]):
        _member(member_inputs, "nofinetune", slice(None), [50 + i for i in range(LANES)])
    assert fits == [200]


def test_shared_probe_head_fails_the_lane_check(member_inputs):
    """The planted fault: every lane's probe starts from lane 0's head."""
    seeds = [50 + i for i in range(LANES)]
    sound, _ = _member(member_inputs, "nofinetune", slice(None), seeds)
    real = tee._draw_heads

    def shared_head(*a, **k):
        heads = real(*a, **k)
        return {key: v[:1].expand_as(v).clone() for key, v in heads.items()}

    with mock.patch.object(tee, "_draw_heads", shared_head):
        planted, _ = _member(member_inputs, "nofinetune", slice(None), seeds)
    np.testing.assert_allclose(planted[0].numpy(), sound[0].numpy(), rtol=1e-10, atol=1e-13)
    diff = float((planted[1:] - sound[1:]).abs().max())
    assert diff > 1e-6, f"the shared-head fault moved the other lanes' scores by only {diff:.3e}"
