"""Episode lanes of the faithful eval (``TransferCfg.bn_mode='minibatch'``):
E episodes as one device batch, every inner step running the trunk once on
the lanes' ``E * B`` images with per-lane BN statistics masked by the step's
weights, then the lanes' final blocks as one grouped pass.

* Grouped masked BN (``ops/norm.py``: ``groups`` with a ``sample_mask``
  shared by the groups) equals per-group masked calls and JAX's masked
  ``batch_norm`` on each group, f64 rtol 1e-12, ragged masks included; the
  trunk with ``bn_groups`` and a mask equals per-lane calls on ResNet10,
  ResNet18 (identity shortcuts) and ResNet10_FW at tiny widths.
* Each member (GNN, linear, ProtoNet, the ``--method all`` ensemble, the
  DampNet live composition) on E = 3 lanes with explicit replica banks,
  schedules (a ragged last minibatch in both members) and classifier inits:
  every lane equals that episode alone, f64 rtol 1e-10, and equals
  ``jax.vmap`` of the JAX member over the same inputs, f64 rtol 1e-8 (the
  bound of tests/test_torch_eval_minibatch.py).  JAX's
  ``ensemble_episode_scores`` and ``proto_member_scores`` take no explicit
  draws, so the ensemble is held against the vmapped sum of its two members
  and ProtoNet against the vmapped ``_finetune_features`` + prototype
  scores, their bodies.  Both packages compute in f64
  (``compute_dtype='float64'``).
* A planted fault, the trunk's BN statistics pooled over all lanes, fails
  the lanes-against-alone check; one batch runs one inner loop per member
  and as many trunk passes as one episode does.

Small sizes: widths (8, 12, 14, 16), 32 px, 3-way 2-shot 3-query, one
augmented replica group (24 bank rows: four steps of 5 and a ragged one of
4), 2 inner epochs.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.core import episode as jep
from mft_tpu.methods import dampnet as jdn
from mft_tpu.methods import gnnnet as jgn
from mft_tpu.methods import protonet as jpn
from mft_tpu.models import backbone as jbb
from mft_tpu.ops import norm as jnorm
from mft_tpu.train import eval_engine as jee
from mft_tpu.train import inner_loop as jil
from mft_tpu_torch import convert
from mft_tpu_torch.core import episode as tep
from mft_tpu_torch.methods import dampnet as tdn
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops import augment as taug
from mft_tpu_torch.ops.norm import batch_norm
from mft_tpu_torch.train import eval_engine as tee
from mft_tpu_torch.train import inner_loop as til

F = 16
WIDTHS = (8, 12, 14, F)
JCFG = jbb.ResNetCfg((1, 1, 1, 1), WIDTHS, "simple", flatten=True, compute_dtype="float64")
TCFG = tbb.ResNetCfg((1, 1, 1, 1), WIDTHS, compute_dtype="float64")
GKW = dict(feat_dim=F, n_way=3, n_support=2, proj_dim=16, gnn_nf=8)
DKW = dict(feat_dim=F, n_way=3, n_support=2, gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16, stat="class")
SPEC = (3, 2, 3)  # n_way, n_support, n_query
GEN_EXAMPLES = 1  # replicas: clean x3 + one augmented group
ROWS = (GEN_EXAMPLES + 3) * SPEC[0] * SPEC[1]  # 24
EPOCHS = 2
SIZE = 32
LANES = 3
MEMBERS = ("gnn", "linear", "protonet", "all", "dampnet")


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


def _nchw(x: np.ndarray) -> torch.Tensor:
    """``[..., H, W, 3]`` -> ``[..., 3, H, W]``."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


@pytest.fixture(scope="module")
def shared():
    """Weights (JAX init, BN parameters and stats perturbed; tiny DampNet
    heads with prototypes from a random bank), LANES centred episodes, their
    replica banks (each lane's clean support three times, then a distinct
    random group), each lane's permutations and classifier init, as numpy
    f64 (NHWC) and as the port's tensors."""
    n_way, n_s, n_q = SPEC
    rs = np.random.RandomState(0)
    perturb = lambda a: np.asarray(a, np.float64) + (rs.rand(*np.shape(a)) * 0.2 if np.ndim(a) == 1 else 0)
    init = jax.jit(lambda k: jbb.init_backbone(k, JCFG._replace(compute_dtype="float32")))
    j = {}
    for name, seed in (("baseline", 0), ("gnn", 1)):
        p, s = init(jax.random.PRNGKey(seed))
        j[name] = (jax.tree.map(perturb, p), jax.tree.map(perturb, s))
    j["head"] = _f64(jax.jit(lambda k: jgn.init_head(k, jgn.GnnNetCfg(**GKW)))(jax.random.PRNGKey(2)))
    jc = jdn.DampNetCfg(**DKW)
    dp, ds = jax.jit(lambda k: jdn.init_dampnet(k, jc))(jax.random.PRNGKey(3))
    with jax.enable_x64():
        ds = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
                          else jnp.asarray(a), ds)
        ds = jax.tree.map(np.asarray, jdn.update_prototypes(ds, jnp.asarray(rs.randn(40, F))))
    j["damp"] = (_f64(dp), ds)
    t = {name: convert.from_jax(*j[name]) for name in ("baseline", "gnn")}
    t["head"], _ = convert.from_jax(j["head"])
    t["damp"] = convert.from_jax(*j["damp"])
    episodes = rs.rand(LANES, n_way, n_s + n_q, SIZE, SIZE, 3)
    banks = np.stack([np.concatenate([np.stack([e[:, :n_s]] * 3), rs.rand(GEN_EXAMPLES, n_way, n_s, SIZE, SIZE, 3)])
                      for e in episodes])
    perms = {"gnn": [np.stack([rs.permutation(ROWS) for _ in range(EPOCHS)]) for _ in range(LANES)],
             "linear": [np.stack([rs.permutation(n_way * n_s) for _ in range(EPOCHS)]) for _ in range(LANES)]}
    heads = [{"w": rs.randn(F, n_way) * 0.2, "b": rs.randn(n_way) * 0.1} for _ in range(LANES)]  # JAX layout
    return dict(j=j, t=t, jc=jc, tc=tdn.DampNetCfg(**DKW), episodes=episodes, banks=banks, perms=perms, heads=heads)


def _tcfg(**kw):
    return tee.TransferCfg(fine_tune_epochs=EPOCHS, linear_epochs=EPOCHS, bn_mode="minibatch",
                           opt_state_dtype="float32", **kw)


def _port(s, member: str, lanes: slice) -> torch.Tensor:
    """The port's member on the episodes ``lanes`` as one lane batch, with
    their explicit banks, schedules and classifier inits."""
    spec = tep.EpisodeSpec(*SPEC)
    t = s["t"]
    picked = range(*lanes.indices(LANES))
    sched = lambda name, rows: til.stack_schedules([til.schedule_from_perms(s["perms"][name][i],
                                                                            til.InnerLoopCfg(EPOCHS, 5, rows))
                                                    for i in picked])
    s_gnn, s_lin = sched("gnn", ROWS), sched("linear", spec.support_size)
    head0 = {"w": torch.from_numpy(np.stack([s["heads"][i]["w"].T for i in picked])),
             "b": torch.from_numpy(np.stack([s["heads"][i]["b"] for i in picked]))}
    episodes, banks, gens = _nchw(s["episodes"][lanes]), _nchw(s["banks"][lanes]), [None] * len(picked)
    kw = dict(bcfg=TCFG, spec=spec, tcfg=_tcfg(), aug_cfg=taug.AugmentCfg(image_size=SIZE), gen_examples=GEN_EXAMPLES)
    gcfg = tgn.GnnNetCfg(**GKW)
    if member == "gnn":
        return tee.gnn_member_lanes(*t["gnn"], t["head"], episodes, banks, gens, gcfg=gcfg, inner_schedule=s_gnn, **kw)
    if member == "linear":
        return tee.linear_member_lanes(*t["baseline"], episodes, banks, gens, inner_schedule=s_lin, head0=head0, **kw)
    if member == "protonet":
        return tee.proto_member_lanes(*t["gnn"], episodes, banks, gens, inner_schedule=s_gnn, **kw)
    if member == "all":
        return tee.ensemble_lanes(*t["baseline"], *t["gnn"], t["head"], episodes, banks, gens, gcfg=gcfg,
                                  inner_schedule=(s_lin, s_gnn), head0=head0, **kw)
    return tee.dampnet_member_lanes(*t["gnn"], *t["damp"], episodes, banks, gens, dcfg=s["tc"], inner_schedule=s_gnn,
                                    **kw)


@pytest.fixture(scope="module")
def lanes(shared):
    """Each member's scores on the three lanes as one batch."""
    return {m: _port(shared, m, slice(None)) for m in MEMBERS}


@pytest.fixture(scope="module")
def jax_lanes(shared):
    """``jax.vmap`` of the JAX members over the three lanes (episode, replica
    bank, schedule indices and classifier init per lane; the schedule's
    weights shared), one jitted program."""
    s, j = shared, shared["j"]
    spec = jep.EpisodeSpec(*SPEC)
    tcfg = jee.TransferCfg(fine_tune_epochs=EPOCHS, linear_epochs=EPOCHS, bn_mode="minibatch",
                           opt_state_dtype="float32")
    k = jax.random.PRNGKey(0)
    kw = dict(bcfg=JCFG, spec=spec, tcfg=tcfg, gen_examples=GEN_EXAMPLES)

    def one(ep, bank, gi, li, head0, gw, lw):
        g_sched, l_sched = (gi, gw), (li, lw)
        lin = jee.linear_member_scores(*j["baseline"], ep, bank, k, k, inner_schedule=l_sched, head0=head0, **kw)
        gnn = jee.gnn_member_scores(*j["gnn"], j["head"], ep, bank, k, k, gcfg=jgn.GnnNetCfg(**GKW),
                                    inner_schedule=g_sched, **kw)
        feats = jee._finetune_features(*j["gnn"], ep, bank, k, k, inner_schedule=g_sched, **kw)
        proto = jax.nn.softmax(jpn.proto_scores(feats[:, : spec.n_support], feats[:, spec.n_support :], spec), axis=1)
        damp = jee.dampnet_member_scores(*j["gnn"], *j["damp"], ep, bank, k, k, dcfg=s["jc"],
                                         inner_schedule=g_sched, **kw)
        return {"gnn": gnn, "linear": lin, "protonet": proto, "all": lin + gnn, "dampnet": damp}

    g = [jil.schedule_from_perms(p, jil.InnerLoopCfg(EPOCHS, 5, ROWS)) for p in s["perms"]["gnn"]]
    lsch = [jil.schedule_from_perms(p, jil.InnerLoopCfg(EPOCHS, 5, spec.support_size)) for p in s["perms"]["linear"]]
    with jax.enable_x64():
        fn = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, None, None)))
        heads = {k_: jnp.asarray(np.stack([h[k_] for h in s["heads"]])) for k_ in ("w", "b")}
        out = fn(jnp.asarray(s["episodes"]), jnp.asarray(s["banks"]), jnp.stack([i for i, _ in g]),
                 jnp.stack([i for i, _ in lsch]), heads, g[0][1], lsch[0][1])
        return {m: np.asarray(v) for m, v in out.items()}


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("channel_dim", [1, -1])
@pytest.mark.parametrize("mask", [(1, 1, 1, 0), (0, 1, 1, 1), (1, 0, 1, 0)])
def test_grouped_masked_batch_norm_matches_per_group_and_jax(channel_dim, mask):
    """``batch_norm(groups=3, sample_mask=w)`` with one ``[N/3]`` mask for
    every group == three masked calls == JAX's masked ``batch_norm`` on each
    group, f64 rtol 1e-12: each group counts its own unmasked rows (a row
    masked out in every group leaves each group the count of a lane alone)."""
    rs = np.random.RandomState(1)
    x = rs.randn(12, 4, 3, 5) if channel_dim == 1 else rs.randn(12, 5, 5, 4)
    p = {"scale": rs.rand(4) + 0.5, "bias": rs.randn(4) * 0.2}
    w = np.asarray(mask, np.float64)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got, _ = batch_norm(tx, tp, None, use_batch_stats=True, channel_dim=channel_dim, groups=3, sample_mask=tw)
    per = torch.cat([batch_norm(tx[i * 4 : (i + 1) * 4], tp, None, use_batch_stats=True, channel_dim=channel_dim,
                                sample_mask=tw)[0] for i in range(3)])
    np.testing.assert_allclose(got.numpy(), per.numpy(), rtol=1e-12, atol=1e-14)
    xl = np.moveaxis(x, 1, -1) if channel_dim == 1 else x
    with jax.enable_x64():
        want = np.concatenate([np.asarray(jnorm.batch_norm(jnp.asarray(xl[i * 4 : (i + 1) * 4]),
                                                           jax.tree.map(jnp.asarray, p), None, use_batch_stats=True,
                                                           sample_mask=jnp.asarray(w))[0]) for i in range(3)])
    want = np.moveaxis(want, -1, 1) if channel_dim == 1 else want
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    # the mask matters: unmasked grouped statistics differ
    plain, _ = batch_norm(tx, tp, None, use_batch_stats=True, channel_dim=channel_dim, groups=3)
    assert not np.allclose(plain.numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("model", ["ResNet10", "ResNet18", "ResNet10_FW"])
def test_trunk_bn_groups_with_mask_equal_per_lane_calls(model):
    """``apply_trunk(bn_groups=3, sample_mask=w)`` == three per-lane masked
    calls (the stem's BN, the shortcut BNs of ResNet10, ResNet18's identity
    shortcuts, ResNet10_FW without noise as the eval runs it), f64 rtol
    1e-12."""
    cfg = {"ResNet10": TCFG, "ResNet18": TCFG._replace(stage_sizes=(2, 2, 2, 2)),
           "ResNet10_FW": TCFG._replace(block="fwt")}[model]
    rs = np.random.RandomState(2)
    p, s = tbb.init_backbone(torch.Generator().manual_seed(0), cfg, dtype=torch.float64)
    s = torch.utils._pytree.tree_map(lambda v: v + torch.from_numpy(rs.rand(*v.shape)) * 0.2, s)
    trunk_p, _ = tbb.adapt_split(p)
    trunk_s, _ = tbb.adapt_split(s)
    x = torch.from_numpy(rs.rand(LANES * 5, 3, SIZE, SIZE))
    w = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.0], dtype=torch.float64)
    got = tbb.apply_trunk(trunk_p, trunk_s, x, cfg=cfg, train=True, sample_mask=w, bn_groups=LANES)
    per = torch.cat([tbb.apply_trunk(trunk_p, trunk_s, x[i * 5 : (i + 1) * 5], cfg=cfg, train=True, sample_mask=w)
                     for i in range(LANES)])
    np.testing.assert_allclose(got.numpy(), per.numpy(), rtol=1e-12, atol=1e-14)


# --------------------------------------------------------------------------
# the members: lanes against each episode alone, and against JAX's vmap
# --------------------------------------------------------------------------


@pytest.mark.parametrize("member", MEMBERS)
def test_minibatch_lanes_equal_each_episode_alone(shared, lanes, member):
    got = lanes[member]
    assert got.dtype == torch.float64 and got.shape == (LANES, SPEC[0] * SPEC[2], SPEC[0])
    for i in range(LANES):
        one = _port(shared, member, slice(i, i + 1))
        np.testing.assert_allclose(got[i].numpy(), one[0].numpy(), rtol=1e-10, atol=1e-13)
    # the lanes differ: no lane's statistics leaked into another
    assert not np.allclose(got[0].numpy(), got[1].numpy(), atol=1e-6)


@pytest.mark.parametrize("member", MEMBERS)
def test_minibatch_lanes_match_jax_vmap(lanes, jax_lanes, member):
    np.testing.assert_allclose(lanes[member].numpy(), jax_lanes[member], rtol=1e-8, atol=1e-12)


def _pooled_trunk(real):
    """The planted fault: the trunk's BN statistics over all lanes together
    (``bn_groups=1``, the step's mask repeated over the lanes' rows)."""
    def apply_trunk(p, s, x, *, sample_mask=None, bn_groups=1, **kw):
        if sample_mask is not None and bn_groups > 1:
            sample_mask = sample_mask.repeat(bn_groups)
        return real(p, s, x, sample_mask=sample_mask, bn_groups=1, **kw)

    return apply_trunk


@pytest.mark.parametrize("member", ["gnn", "linear"])
def test_pooled_lane_statistics_fail_the_lane_check(shared, lanes, member):
    with mock.patch.object(tbb, "apply_trunk", _pooled_trunk(tbb.apply_trunk)):
        planted = _port(shared, member, slice(None))
    diff = float((planted - lanes[member]).abs().max())
    assert diff > 1e-6, f"the pooled-statistics fault moved the scores by only {diff:.3e}"


def test_one_inner_loop_and_one_episodes_trunk_passes_per_batch(shared):
    """``make_eval_program`` in the minibatch mode runs each member's inner
    loop once for the whole batch: the trunk passes of three lanes are those
    of one episode (each member's steps plus its embedding), not three
    times as many, and every lane of the program equals that episode alone."""
    spec = tep.EpisodeSpec(*SPEC)
    t = shared["t"]
    models = {"baseline": t["baseline"], "gnn": (*t["gnn"], t["head"])}
    program = tee.make_eval_program(method="all", bcfg=TCFG, gcfg=tgn.GnnNetCfg(**GKW), spec=spec,
                                    tcfg=_tcfg()._replace(fine_tune_epochs=1, linear_epochs=1),
                                    aug_cfg=taug.AugmentCfg(image_size=SIZE), gen_examples=GEN_EXAMPLES)
    base = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (LANES, 3, 5, 3, 37, 37), dtype=np.uint8))
    gens = lambda picked: [torch.Generator().manual_seed(40 + i) for i in picked]
    real_trunk, real_fit = tbb.apply_trunk, tee.inner_fit
    calls = {"trunk": 0, "fit": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    runs = {}
    for n in (LANES, 1):
        calls.update(trunk=0, fit=0)
        with mock.patch.object(tbb, "apply_trunk", count("trunk", real_trunk)), \
                mock.patch.object(tee, "inner_fit", count("fit", real_fit)):
            runs[n] = program(models, base[:n], gens(range(n)))
        runs[n] += (dict(calls),)
    steps = (1 * 2) + (1 * 5)  # the linear member's 6 rows, the GNN member's 24, in minibatches of 5
    assert runs[LANES][2] == runs[1][2] == {"trunk": steps + 2, "fit": 2}
    for i in range(LANES):
        one, accs = program(models, base[i : i + 1], gens([i]))
        np.testing.assert_allclose(runs[LANES][0][i].numpy(), one[0].numpy(), rtol=1e-10, atol=1e-13)
        assert runs[LANES][1][i] == accs[0]
