"""Episode lanes of the port's eval (``--eval_batch``): E episodes as one
device batch against each episode alone and against the JAX eval engine.

* Grouped BN (``ops/norm.py`` ``groups``), the trunk with ``bn_groups``,
  the lane final block and the lane-stacked ``inner_fit`` each equal their
  per-group / per-lane counterparts (f64: rtol 1e-12 for one layer, 1e-10
  for the inner loop).
* Each member (linear, GNN on the plain edge op, ProtoNet, the DampNet live
  composition) on E = 3 episodes with different draws: every lane equals the
  port's one-episode member on that episode with the same generator
  (``gen_examples=1``, so augment draws, classifier init and permutations
  all come from the lane's generator), f64 rtol 1e-8; and equals the JAX
  member on that episode given the same explicit draws (schedules,
  ``head0``; ``gen_examples=0`` as the whole-eval tests), f64 rtol 1e-8.  The
  backbone computes in f64 (``compute_dtype='float64'``) in both packages
  after the shared f32 rounding of the uint8 images.
* The fused scan's lanes: ``fused_inner_scan_lanes``' plain version on
  three lanes equals three single-lane calls, and the GNN member under
  ``inner_scan='fused'`` gives each lane what it gives alone.

Small sizes: narrow widths (8, 12, 14, 16), 32 px, 1-2 inner epochs.
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
from mft_tpu.ops import augment as jaug
from mft_tpu.ops import norm as jnorm
from mft_tpu.train import eval_engine as jee
from mft_tpu.train import inner_loop as jil
from mft_tpu_torch import convert
from mft_tpu_torch.core import episode as tep
from mft_tpu_torch.kernels import fused_inner_scan as tfis
from mft_tpu_torch.methods import dampnet as tdn
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.methods.baseline import ce_loss
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops import augment as taug
from mft_tpu_torch.ops.norm import batch_norm
from mft_tpu_torch.train import eval_engine as tee
from mft_tpu_torch.train import inner_loop as til
from mft_tpu_torch.train import optimizers as topt

F = 16
WIDTHS = (8, 12, 14, F)
JCFG = jbb.ResNetCfg((1, 1, 1, 1), WIDTHS, "simple", flatten=True, compute_dtype="float64")
TCFG = tbb.ResNetCfg((1, 1, 1, 1), WIDTHS, compute_dtype="float64")
GKW = dict(feat_dim=F, n_way=3, n_support=2, proj_dim=16, gnn_nf=8)
DKW = dict(feat_dim=F, n_way=3, n_support=2, gnn_dim=16, gnn_nf=8, ntn_dim=8, mlp_hidden=16, stat="class")
SPEC = (3, 2, 2)  # n_way, n_support, n_query
LANES = 3
SIZE = 32
BASE = int(SIZE * 1.15)  # the host's decode size: the clean view is a crop, no resample
MEMBERS = ("linear", "gnn", "protonet", "dampnet")
RTOL, ATOL = 1e-8, 1e-12


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
def setup():
    """JAX-initialized weights (BN parameters and stats perturbed) in f64
    numpy and the port's copies, and three episodes of uint8 images."""
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
    n_way, n_s, n_q = SPEC
    base = rs.randint(0, 256, (LANES, n_way, n_s + n_q, BASE, BASE, 3)).astype(np.uint8)
    return dict(j=j, t=t, base=base, jc=jc, tc=tdn.DampNetCfg(**DKW), rs=rs)


def _port_inputs(base):
    tb = torch.from_numpy(base).permute(0, 1, 2, 5, 3, 4)  # NHWC -> NCHW
    return taug.center_batch(tb, SIZE), tb[:, :, : SPEC[1]]


def _port_member(s, member, episodes, supports, gens, tcfg, **kw):
    t, spec = s["t"], tep.EpisodeSpec(*SPEC)
    common = dict(bcfg=TCFG, spec=spec, tcfg=tcfg, aug_cfg=taug.AugmentCfg(image_size=SIZE), **kw)
    if member == "linear":
        return tee.linear_member_lanes(*t["baseline"], episodes, supports, gens, **common)
    if member == "gnn":
        return tee.gnn_member_lanes(*t["gnn"], t["head"], episodes, supports, gens, gcfg=tgn.GnnNetCfg(**GKW), **common)
    if member == "protonet":
        return tee.proto_member_lanes(*t["gnn"], episodes, supports, gens, **common)
    return tee.dampnet_member_lanes(*t["gnn"], *t["damp"], episodes, supports, gens, dcfg=s["tc"], **common)


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("channel_dim", [1, -1])
def test_grouped_batch_norm_matches_per_group_and_jax(channel_dim):
    """``batch_norm(groups=3)`` == three separate batch-stats calls == JAX's
    ``batch_norm(groups=3)`` (channels-last in JAX), f64 rtol 1e-12; NCHW
    and the GNN's channels-last edge tensor."""
    rs = np.random.RandomState(1)
    x = rs.randn(12, 4, 3, 5) if channel_dim == 1 else rs.randn(6, 5, 5, 4)
    p = {"scale": rs.rand(4) + 0.5, "bias": rs.randn(4) * 0.2}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    got, _ = batch_norm(tx, tp, None, use_batch_stats=True, channel_dim=channel_dim, groups=3)
    n = x.shape[0] // 3
    per = torch.cat([batch_norm(tx[i * n : (i + 1) * n], tp, None, use_batch_stats=True, channel_dim=channel_dim)[0]
                     for i in range(3)])
    np.testing.assert_allclose(got.numpy(), per.numpy(), rtol=1e-12, atol=1e-14)
    xl = np.moveaxis(x, 1, -1) if channel_dim == 1 else x
    with jax.enable_x64():
        want = np.asarray(jnorm.batch_norm(jnp.asarray(xl), jax.tree.map(jnp.asarray, p), None, use_batch_stats=True,
                                           groups=3)[0])
    want = np.moveaxis(want, -1, 1) if channel_dim == 1 else want
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    stats = {"mean": torch.zeros(4, dtype=torch.float64), "var": torch.ones(4, dtype=torch.float64)}
    with pytest.raises(ValueError, match="batch statistics only"):  # grouped BN updates no running statistics
        batch_norm(tx, tp, stats, use_batch_stats=True, update_stats=True, channel_dim=channel_dim, groups=3)


def test_trunk_and_backbone_bn_groups_equal_per_group_passes(setup):
    p, s = setup["t"]["gnn"]
    x = torch.from_numpy(setup["rs"].rand(3 * 4, 3, SIZE, SIZE))
    trunk_p, _ = tbb.adapt_split(p)
    trunk_s, _ = tbb.adapt_split(s)
    got = tbb.apply_trunk(trunk_p, trunk_s, x, cfg=TCFG, train=True, bn_groups=3)
    per = torch.cat([tbb.apply_trunk(trunk_p, trunk_s, x[i * 4 : (i + 1) * 4], cfg=TCFG, train=True) for i in range(3)])
    np.testing.assert_allclose(got.numpy(), per.numpy(), rtol=1e-12, atol=1e-14)
    got, _ = tbb.apply_backbone(p, s, x, cfg=TCFG, train=True, bn_groups=3)
    per = torch.cat([tbb.apply_backbone(p, s, x[i * 4 : (i + 1) * 4], cfg=TCFG, train=True)[0] for i in range(3)])
    np.testing.assert_allclose(got.numpy(), per.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("train", [True, False])
def test_final_block_lanes_equal_each_lane(setup, train):
    """Per-lane block weights on ``[L, B, C, H, W]`` with a shared ragged
    mask: each lane equals ``apply_final_block`` on that lane alone."""
    rs = setup["rs"]
    p, s = setup["t"]["gnn"]
    _, block = tbb.adapt_split(p)
    _, block_s = tbb.adapt_split(s)
    lanes = {k: (torch.stack([v + 0.05 * i for i in range(LANES)]) if not isinstance(v, dict) else
                 {kk: torch.stack([vv * (1 + 0.1 * i) for i in range(LANES)]) for kk, vv in v.items()})
             for k, v in block.items()}
    fmap = torch.from_numpy(rs.randn(LANES, 5, 14, 4, 4))
    w = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0], dtype=torch.float64)
    got = tbb.apply_final_block_lanes(lanes, block_s, fmap, cfg=TCFG, train=train, sample_mask=w if train else None)
    assert got.shape == (LANES, 5, F)
    for i in range(LANES):
        one = tbb.apply_final_block(tee._lane(lanes, i), block_s, fmap[i], cfg=TCFG, train=train,
                                    sample_mask=w if train else None)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=1e-12, atol=1e-14)


def test_inner_fit_lanes_equal_separate_fits(setup):
    """Lane-stacked ``inner_fit`` (final block and head, grouped Adam, a
    ragged last minibatch) == three separate ``inner_fit`` calls, f64 rtol
    1e-10; the lanes' losses are summed, not averaged."""
    rs = setup["rs"]
    p, s = setup["t"]["baseline"]
    _, block = tbb.adapt_split(p)
    _, block_s = tbb.adapt_split(s)
    bank = torch.from_numpy(rs.randn(LANES, 7, 14, 4, 4))
    y = torch.from_numpy(rs.randint(0, 3, 7))
    heads = {"w": torch.from_numpy(rs.randn(LANES, 3, F) * 0.2), "b": torch.from_numpy(rs.randn(LANES, 3) * 0.1)}
    tx = topt.grouped({"adapt": topt.torch_adam(0.01), "head": topt.torch_adam(0.01, 0.001)},
                      {"adapt": "adapt", "head": "head"})
    cfg = til.InnerLoopCfg(2, 5, 7)
    lanes = torch.arange(LANES)[:, None]

    def loss_lanes(q, idx, w):
        feats = tbb.apply_final_block_lanes(q["adapt"], block_s, bank[lanes, idx], cfg=TCFG, train=True, sample_mask=w)
        return ce_loss(torch.bmm(feats, q["head"]["w"].transpose(1, 2)) + q["head"]["b"][:, None], y[idx], w)

    p0 = {"adapt": tee._expand(block, LANES), "head": heads}
    got = til.inner_fit(loss_lanes, p0, tx, [torch.Generator().manual_seed(i) for i in range(LANES)], cfg)
    for i in range(LANES):
        def loss_one(q, idx, w, i=i):
            feats = tbb.apply_final_block(q["adapt"], block_s, bank[i][idx], cfg=TCFG, train=True, sample_mask=w)
            return ce_loss(feats @ q["head"]["w"].t() + q["head"]["b"], y[idx], w)

        one = til.inner_fit(loss_one, {"adapt": block, "head": tee._lane(heads, i)}, tx,
                            torch.Generator().manual_seed(i), cfg)
        for a, b in zip(torch.utils._pytree.tree_leaves(tee._lane(got, i)), torch.utils._pytree.tree_leaves(one)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-13)


# --------------------------------------------------------------------------
# the members: lanes against each episode alone, and against JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("member", MEMBERS)
def test_member_lanes_equal_each_episode_alone(setup, member):
    """E = 3 episodes, each with its own generator: every lane's scores
    equal the one-episode member's with the same generator seed, and every
    generator is left where the one-episode run leaves it."""
    tcfg = tee.TransferCfg(fine_tune_epochs=1, linear_epochs=2, opt_state_dtype="float32")
    episodes, supports = _port_inputs(setup["base"])
    gens = [torch.Generator().manual_seed(20 + i) for i in range(LANES)]
    got = _port_member(setup, member, episodes, supports, gens, tcfg, gen_examples=1)
    assert got.shape == (LANES, 6, 3) and torch.isfinite(got).all()
    after = [torch.rand(1, generator=g).item() for g in gens]
    for i in range(LANES):
        gen = torch.Generator().manual_seed(20 + i)
        one = _port_member(setup, member, episodes[i : i + 1], supports[i : i + 1], [gen], tcfg, gen_examples=1)
        np.testing.assert_allclose(got[i].numpy(), one[0].numpy(), rtol=RTOL, atol=ATOL)
        assert torch.rand(1, generator=gen).item() == after[i]
    # the lanes differ: the statistics of one episode did not leak into another
    assert not np.allclose(got[0].numpy(), got[1].numpy(), atol=1e-6)


def _jax_member(s, member):
    """The JAX member on one episode as ``fn(episode, support, idx, w,
    head0)``, jitted once.  It takes the port's clean views (the episode's,
    and the support's, which ``center_batch`` passes through): the two
    packages' f32 image pipelines part by an ulp (held against each other in
    tests/test_torch_augment.py), which f64 members would carry."""
    j, spec = s["j"], jep.EpisodeSpec(*SPEC)
    tcfg = jee.TransferCfg(fine_tune_epochs=2, linear_epochs=2, opt_state_dtype="float32")
    k = jax.random.PRNGKey(0)
    kw = dict(bcfg=JCFG, spec=spec, tcfg=tcfg, aug_cfg=jaug.AugmentCfg(image_size=SIZE), gen_examples=0)

    def run(ep, sup, idx, w, head0):
        sched = (idx, w)
        if member == "linear":
            return jee.linear_member_scores(*j["baseline"], ep, sup, k, k, inner_schedule=sched, head0=head0, **kw)
        if member == "gnn":
            return jee.gnn_member_scores(*j["gnn"], j["head"], ep, sup, k, k, gcfg=jgn.GnnNetCfg(**GKW),
                                         inner_schedule=sched, **kw)
        if member == "protonet":  # JAX's proto member: _finetune_features, then prototype scores
            feats = jee._finetune_features(*j["gnn"], ep, sup, k, k, inner_schedule=sched, **kw)
            return jax.nn.softmax(jpn.proto_scores(feats[:, : spec.n_support], feats[:, spec.n_support :], spec),
                                  axis=1)
        return jee.dampnet_member_scores(*j["gnn"], *j["damp"], ep, sup, k, k, dcfg=s["jc"], inner_schedule=sched,
                                         **kw)

    fn = jax.jit(run)

    def call(*args):
        with jax.enable_x64(), mock.patch.object(jaug, "center_batch", lambda images, *a, **k: images):
            return np.asarray(fn(*jax.tree.map(jnp.asarray, args)))

    return call


@pytest.mark.parametrize("member", MEMBERS)
def test_member_lanes_match_jax(setup, member):
    """Each lane of an E = 3 batch against the JAX member on that episode,
    with the same explicit schedules and classifier init (no augment
    draws), f64 rtol 1e-8."""
    rs = np.random.RandomState(5)
    spec = tep.EpisodeSpec(*SPEC)
    rows = spec.support_size if member == "linear" else 3 * spec.support_size
    perms = [np.stack([rs.permutation(rows) for _ in range(2)]) for _ in range(LANES)]
    head0 = [{"w": rs.randn(F, 3) * 0.2, "b": rs.randn(3) * 0.1} for _ in range(LANES)]  # JAX layout
    icfg = til.InnerLoopCfg(2, 5, rows)
    sched = til.stack_schedules([til.schedule_from_perms(p, icfg) for p in perms])
    kw = {"inner_schedule": sched}
    if member == "linear":
        kw["head0"] = {"w": torch.from_numpy(np.stack([h["w"].T for h in head0])),
                       "b": torch.from_numpy(np.stack([h["b"] for h in head0]))}
    tcfg = tee.TransferCfg(fine_tune_epochs=2, linear_epochs=2, opt_state_dtype="float32")
    episodes, supports = _port_inputs(setup["base"])
    got = _port_member(setup, member, episodes, supports, [None] * LANES, tcfg, gen_examples=0, **kw)
    views = taug.center_batch(supports, SIZE)
    nhwc = lambda t: np.ascontiguousarray(np.moveaxis(t.numpy(), -3, -1))
    jax_member = _jax_member(setup, member)
    for i in range(LANES):
        idx, w = jil.schedule_from_perms(perms[i], jil.InnerLoopCfg(2, 5, rows))
        want = jax_member(nhwc(episodes[i]), nhwc(views[i]), idx, w, head0[i])
        np.testing.assert_allclose(got[i].numpy(), want, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# the fused scan's lanes
# --------------------------------------------------------------------------


def test_fused_scan_lanes_equal_single_lane_calls():
    """``fused_inner_scan_lanes``' plain version on three lanes (own banks
    and schedules, shared labels and weights) == three single-lane calls;
    the GNN member under ``inner_scan='fused'`` gives each lane of a batch
    what it gives alone."""
    geom = tfis.BlockGeom(h_in=4, c_in=16, c_out=32, stride=2, batch=5)
    gen = torch.Generator().manual_seed(0)
    shapes = tfis.param_shapes(geom)
    p0 = {k: (torch.randn((LANES,) + v, generator=gen) * 0.1).to(torch.bfloat16) for k, v in shapes.items()}
    banks = torch.randn(LANES, 12, 4, 4, 16, generator=gen).to(torch.bfloat16)
    y = torch.randint(0, 3, (12,), generator=gen)
    idx, w = til.lane_schedule([torch.Generator().manual_seed(i) for i in range(LANES)], til.InnerLoopCfg(1, 5, 12))
    got = tfis.fused_inner_scan_lanes(p0, banks, y, idx, w, geom=geom, lr=0.01)
    for i in range(LANES):
        one = tfis.fused_inner_scan({k: v[i] for k, v in p0.items()}, banks[i], y, idx[i], w, geom=geom, lr=0.01)
        for k in tfis.PKEYS:
            assert torch.equal(got[k][i], one[k]), k


def test_gnn_member_fused_lanes_equal_each_episode_alone(setup):
    tcfg = tee.TransferCfg(fine_tune_epochs=1, inner_scan="fused")
    episodes, supports = _port_inputs(setup["base"])
    gens = [torch.Generator().manual_seed(30 + i) for i in range(LANES)]
    got = _port_member(setup, "gnn", episodes, supports, gens, tcfg, gen_examples=1)
    for i in range(LANES):
        one = _port_member(setup, "gnn", episodes[i : i + 1], supports[i : i + 1],
                           [torch.Generator().manual_seed(30 + i)], tcfg, gen_examples=1)
        np.testing.assert_allclose(got[i].numpy(), one[0].numpy(), rtol=RTOL, atol=ATOL)
