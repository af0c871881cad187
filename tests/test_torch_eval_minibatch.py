"""The port's faithful eval (``TransferCfg.bn_mode='minibatch'``: the whole
backbone on every inner minibatch, batch statistics masked in every BN
layer) and its ProtoNet member, against the JAX eval engine and against the
reference's own ``finetune()``.

* Members against JAX ``eval_engine`` on shared inputs: the same replica
  bank, explicit inner schedules (ragged last minibatches included), the
  same classifier init, a tiny backbone.  Both packages run f64
  (``jax.enable_x64`` and ``torch.float64``, as tests/test_torch_train_steps.py
  does), where summation order costs some 1e-16: scores at rtol 1e-8.
* The reference's own ``finetune()`` / ``finetune_linear()`` goldens of
  tests/fixtures/golden_reference.npz (``fte2e.*``, ``ft50e2e.*``) through
  the port, in f32, at the JAX golden tests' tolerances
  (tests/test_golden_reference.py:545-690): GNN and linear scores rtol/atol
  2e-3, their sum atol 4e-3.  The banks are the JAX tests' own
  (``_e2e_tensors``, ``_e2e50_tensors``), transposed to NCHW; the 5-shot GNN
  bank has 16 rows, so its last minibatch is one row, masked in every BN
  layer.  The inner Adam keeps f32 moments, the reference's own
  (``opt_state_dtype='float32'``; the JAX tests run the bf16-moment
  default).  Why: at step 8 of the linear member's 20, one pre-activation of
  the adapted block's channel 7 lies within f32 rounding of 0, and the
  port's f32 sums put it on the other side of its ReLU from the reference's
  and JAX's (its bn1 bias gradient parts by 9 % from the same step in f64,
  all other tensors by 2e-6).  With f32 moments that leaves the linear
  scores 1.05e-3 from the reference; with bf16 moments on top, 2.86e-3,
  just over the 2.8e-3 the tolerance allows there.  The port in f64 lies
  2e-6 from the reference (checked below).
* ``make_eval_replicas`` against JAX, and the refusal of the fused scan in
  the minibatch mode.
"""

import os

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
from mft_tpu_torch import convert
from mft_tpu_torch.core import episode as tep
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops import augment as taug
from mft_tpu_torch.train import eval_engine as tee
from mft_tpu_torch.train import inner_loop as til
from tests.test_golden_reference import _e2e50_tensors, _e2e_tensors

HERE = os.path.dirname(__file__)
JCFG = jbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, 16), "simple", flatten=True)
TCFG = tbb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, 16))
GKW = dict(feat_dim=16, n_way=3, n_support=2, proj_dim=16, gnn_nf=8)
SPEC = (3, 2, 3)  # n_way, n_support, n_query
GEN_EXAMPLES = 1  # replicas: clean x3 + one augmented group
EPOCHS = 2
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x: np.ndarray) -> torch.Tensor:
    """``[..., H, W, 3]`` -> ``[..., 3, H, W]``."""
    nd = x.ndim
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, tuple(range(nd - 3)) + (nd - 1, nd - 3, nd - 2))))


# --------------------------------------------------------------------------
# members against the JAX eval engine, f64
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared():
    """Weights (JAX init, BN parameters and stats perturbed), a centered
    episode, a replica bank with distinct augmented rows, the schedules and
    the classifier init, as numpy f64."""
    n_way, n_s, n_q = SPEC
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    rs = np.random.RandomState(0)
    perturb = lambda a: np.asarray(a) + (rs.rand(*np.shape(a)) * 0.2 if np.ndim(a) == 1 else 0)
    init = jax.jit(lambda k: jbb.init_backbone(k, JCFG))
    models = {}
    for name, seed in (("baseline", 0), ("gnn", 1)):
        p, s = init(jax.random.PRNGKey(seed))
        models[name] = (f64(jax.tree.map(perturb, p)), f64(jax.tree.map(perturb, s)))
    head = f64(jax.jit(lambda k: jgn.init_head(k, jgn.GnnNetCfg(**GKW)))(jax.random.PRNGKey(2)))
    episode = rs.randn(n_way, n_s + n_q, SIZE, SIZE, 3)
    bank = np.concatenate([np.stack([episode[:, :n_s]] * 3), rs.randn(GEN_EXAMPLES, n_way, n_s, SIZE, SIZE, 3)])
    rows = (GEN_EXAMPLES + 3) * n_way * n_s  # 24: four steps of 5 and a ragged one of 4
    perms = {"gnn": np.stack([rs.permutation(rows) for _ in range(EPOCHS)]),
             "linear": np.stack([rs.permutation(n_way * n_s) for _ in range(EPOCHS)])}
    head0 = {"w": rs.randn(16, n_way) * 0.2, "b": rs.randn(n_way) * 0.1}
    return dict(models=models, head=head, episode=episode, bank=bank, perms=perms, head0=head0, rows=rows)


def _jax_scores(s):
    spec = jep.EpisodeSpec(*SPEC)
    tcfg = jee.TransferCfg(fine_tune_epochs=EPOCHS, linear_epochs=EPOCHS, bn_mode="minibatch",
                           opt_state_dtype="float32")
    g_sched = jil.schedule_from_perms(s["perms"]["gnn"], jil.InnerLoopCfg(EPOCHS, 5, s["rows"]))
    l_sched = jil.schedule_from_perms(s["perms"]["linear"], jil.InnerLoopCfg(EPOCHS, 5, spec.support_size))
    k = jax.random.PRNGKey(0)
    kw = dict(bcfg=JCFG, spec=spec, tcfg=tcfg, gen_examples=GEN_EXAMPLES)
    with jax.enable_x64():
        ep, bank = jnp.asarray(s["episode"]), jnp.asarray(s["bank"])
        (bp, bs), (gp, gs) = s["models"]["baseline"], s["models"]["gnn"]
        lin = jee.linear_member_scores(bp, bs, ep, bank, k, k, inner_schedule=l_sched,
                                       head0=jax.tree.map(jnp.asarray, s["head0"]), **kw)
        gnn = jee.gnn_member_scores(gp, gs, s["head"], ep, bank, k, k, gcfg=jgn.GnnNetCfg(**GKW),
                                    inner_schedule=g_sched, **kw)
        # proto_member_scores takes no schedule; its body is these two calls
        feats = jee._finetune_features(gp, gs, ep, bank, k, k, inner_schedule=g_sched, **kw)
        proto = jax.nn.softmax(jpn.proto_scores(feats[:, : spec.n_support], feats[:, spec.n_support :], spec), axis=1)
        return {"linear": np.asarray(lin), "gnn": np.asarray(gnn), "protonet": np.asarray(proto)}


def _port_scores(s):
    spec = tep.EpisodeSpec(*SPEC)
    tcfg = tee.TransferCfg(fine_tune_epochs=EPOCHS, linear_epochs=EPOCHS, bn_mode="minibatch",
                           opt_state_dtype="float32")
    g_sched = til.schedule_from_perms(s["perms"]["gnn"], til.InnerLoopCfg(EPOCHS, 5, s["rows"]))
    l_sched = til.schedule_from_perms(s["perms"]["linear"], til.InnerLoopCfg(EPOCHS, 5, spec.support_size))
    kw = dict(bcfg=TCFG, spec=spec, tcfg=tcfg, aug_cfg=taug.AugmentCfg(image_size=SIZE), gen_examples=GEN_EXAMPLES)
    ep, bank = _nchw(s["episode"]), _nchw(s["bank"])
    bp, bs = convert.from_jax(*s["models"]["baseline"])
    gp, gs = convert.from_jax(*s["models"]["gnn"])
    head, _ = convert.from_jax(s["head"])
    head0, _ = convert.from_jax(s["head0"])
    return {
        "linear": tee.linear_member_scores(bp, bs, ep, bank, None, inner_schedule=l_sched, head0=head0, **kw).numpy(),
        "gnn": tee.gnn_member_scores(gp, gs, head, ep, bank, None, gcfg=tgn.GnnNetCfg(**GKW), inner_schedule=g_sched,
                                     **kw).numpy(),
        "protonet": tee.proto_member_scores(gp, gs, ep, bank, None, inner_schedule=g_sched, **kw).numpy(),
    }


@pytest.fixture(scope="module")
def both(shared):
    return _jax_scores(shared), _port_scores(shared)


@pytest.mark.parametrize("member", ["gnn", "linear", "protonet"])
def test_minibatch_member_matches_jax_f64(both, member):
    want, got = both[0][member], both[1][member]
    assert got.dtype == np.float64 and got.shape == (SPEC[0] * SPEC[2], SPEC[0])
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_minibatch_ensemble_matches_jax_f64(both):
    want, got = both[0]["linear"] + both[0]["gnn"], both[1]["linear"] + both[1]["gnn"]
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)
    spec_j, spec_t = jep.EpisodeSpec(*SPEC), tep.EpisodeSpec(*SPEC)
    assert tee.episode_accuracy(torch.from_numpy(got), spec_t) == pytest.approx(
        float(jee.episode_accuracy(jnp.asarray(want), spec_j)))


def test_minibatch_mode_masks_every_bn_layer(shared):
    """A ragged minibatch, padded with row 0 at weight 0, gives the same loss
    and block gradients as the minibatch of its real rows alone: the pad row
    counts in no BN layer's statistics, the trunk's included (a layer that
    missed the mask would take the pad row's moments)."""
    s = shared
    spec = tep.EpisodeSpec(*SPEC)
    gp, gs = convert.from_jax(*s["models"]["gnn"])
    tcfg = tee.TransferCfg(bn_mode="minibatch", opt_state_dtype="float32")
    bank_x = tee._bank_images(_nchw(s["bank"]))[None]  # one lane
    bank_y = tee.bank_labels(spec, GEN_EXAMPLES + 3)
    p0, loss_fn, _, _, _ = tee._prepare_adapt(gp, gs, bank_y, bcfg=TCFG, tcfg=tcfg, epochs=1, head=None,
                                              bank_x=bank_x)
    real = torch.tensor([7, 19, 3, 11])

    def loss_and_grads(idx, w):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items() if not isinstance(v, dict)}
        p = {k: (leaves[k] if k in leaves else v) for k, v in p0.items()}
        loss = loss_fn(p, idx[None], w)  # the lane's [1, B] rows
        return float(loss.detach()), torch.autograd.grad(loss, [leaves["conv1"], leaves["conv2"]])

    padded = loss_and_grads(torch.cat([real, torch.tensor([0])]), torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0],
                                                                               dtype=torch.float64))
    alone = loss_and_grads(real, torch.ones(4, dtype=torch.float64))
    assert padded[0] == pytest.approx(alone[0], rel=1e-12)
    for a, b in zip(padded[1], alone[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-14)
    # and the mask matters: the pad row at weight 1 moves the loss
    assert loss_and_grads(torch.cat([real, torch.tensor([0])]), torch.ones(5, dtype=torch.float64))[0] != \
        pytest.approx(alone[0], rel=1e-6)


# --------------------------------------------------------------------------
# the reference's own finetune() through the port (f32 goldens)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def g():
    with np.load(os.path.join(HERE, "fixtures", "golden_reference.npz")) as z:
        return {k: z[k] for k in z.files if k.startswith(("fte2e", "ft50e2e"))}


def _sd(g, prefix, rename=""):
    n = len(prefix) + 1
    return {rename + k[n:]: torch.from_numpy(np.asarray(v)) for k, v in g.items() if k.startswith(prefix + ".")}


def _golden_models(g, prefix):
    """``(feature, stats, head)`` of a reference GnnNet state dict in the fixture."""
    p, s = convert.from_state_dict(_sd(g, prefix), TCFG)
    return p["feature"], s, {"fc": p["fc"], "gnn": p["gnn"]}


def _golden_kw(n_support, gen_examples=1):
    spec = tep.EpisodeSpec(2, n_support, 15)
    return spec, dict(bcfg=TCFG, spec=spec, aug_cfg=taug.AugmentCfg(image_size=224), gen_examples=gen_examples)


def _tensors(fn):
    ep, bank = fn()
    return _nchw(np.asarray(ep)), _nchw(np.asarray(bank))


def test_finetune_e2e_transfer_golden_through_the_port(g):
    """tests/test_golden_reference.py::test_finetune_e2e_transfer_golden with
    the port's members: the reference's recorded permutations and classifier
    init, ``bn_mode='minibatch'``."""
    ep, bank = _tensors(_e2e_tensors)
    spec, kw = _golden_kw(2)
    tcfg = tee.TransferCfg(fine_tune_epochs=1, linear_epochs=20, bn_mode="minibatch", opt_state_dtype="float32")
    feat, stats, head = _golden_models(g, "fte2e_gnn")
    sched = til.schedule_from_perms(g["fte2e.perms_gnn"], til.InnerLoopCfg(epochs=1, batch_size=5, bank_size=16))
    s_gnn = tee.gnn_member_scores(feat, stats, head, ep, bank, None, gcfg=tgn.GnnNetCfg(feat_dim=16, n_way=2,
                                                                                       n_support=2),
                                  tcfg=tcfg, inner_schedule=sched, **kw).numpy()
    np.testing.assert_allclose(s_gnn, g["fte2e.scores_gnn"], rtol=2e-3, atol=2e-3)

    bp, bs = convert.from_state_dict(_sd(g, "fte2e_base", rename="feature."), TCFG)
    head0 = {"w": torch.from_numpy(g["fte2e.clf_linear.weight"]), "b": torch.from_numpy(g["fte2e.clf_linear.bias"])}
    sched = til.schedule_from_perms(g["fte2e.perms_linear"], til.InnerLoopCfg(epochs=20, batch_size=5, bank_size=4))
    s_lin = tee.linear_member_scores(bp["feature"], bs, ep, bank, None, tcfg=tcfg, inner_schedule=sched,
                                     head0=head0, **kw).numpy()
    np.testing.assert_allclose(s_lin, g["fte2e.scores_linear"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(s_lin + s_gnn, g["fte2e.scores_all"], rtol=2e-3, atol=4e-3)


def test_finetune_e2e_linear_golden_in_f64(g):
    """The linear member of the golden above with the port in f64 (the
    fixture's f32 weights and pixels widened exactly): the reference's f32
    run is then the only rounding left, some 1e-6 in the scores."""
    ep, bank = _tensors(_e2e_tensors)
    _, kw = _golden_kw(2)
    tcfg = tee.TransferCfg(linear_epochs=20, bn_mode="minibatch", opt_state_dtype="float32")
    bp, bs = convert.from_state_dict(_sd(g, "fte2e_base", rename="feature."), TCFG, dtype=torch.float64)
    head0 = {"w": torch.from_numpy(g["fte2e.clf_linear.weight"]).double(),
             "b": torch.from_numpy(g["fte2e.clf_linear.bias"]).double()}
    sched = til.schedule_from_perms(g["fte2e.perms_linear"], til.InnerLoopCfg(epochs=20, batch_size=5, bank_size=4))
    s_lin = tee.linear_member_scores(bp["feature"], bs, ep.double(), bank.double(), None, tcfg=tcfg,
                                     inner_schedule=sched, head0=head0, **kw).numpy()
    np.testing.assert_allclose(s_lin, g["fte2e.scores_linear"], rtol=0, atol=2e-5)


def test_finetune50_e2e_transfer_golden_through_the_port(g):
    """tests/test_golden_reference.py::test_finetune50_e2e_transfer_golden:
    the 50-shot driver's GNN member, the compressed head on the adapted
    features."""
    ep, bank = _tensors(_e2e50_tensors)
    spec, kw = _golden_kw(4)
    tcfg = tee.TransferCfg(fine_tune_epochs=1, bn_mode="minibatch", opt_state_dtype="float32")
    feat, stats, head = _golden_models(g, "ft50e2e_gnn")
    sched = til.schedule_from_perms(g["ft50e2e.perms"], til.InnerLoopCfg(epochs=1, batch_size=5, bank_size=32))
    scores = tee.gnn_member_scores(feat, stats, head, ep, bank, None,
                                   gcfg=tgn.GnnNetCfg(feat_dim=16, n_way=2, n_support=4, support_compress=2),
                                   tcfg=tcfg, inner_schedule=sched, **kw).numpy()
    np.testing.assert_allclose(scores, g["ft50e2e.scores_gnn"], rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------
# the replica bank, the eval program, the refusal
# --------------------------------------------------------------------------


def test_make_eval_replicas_clean_triplet_matches_jax():
    base = np.random.RandomState(3).randint(0, 256, (3, 2, 37, 37, 3), dtype=np.uint8)
    cfg = jaug.AugmentCfg(image_size=SIZE)
    want = np.asarray(jax.jit(lambda x: jaug.make_eval_replicas(jax.random.PRNGKey(0), x, cfg, 2))(base))
    got = taug.make_eval_replicas(torch.Generator().manual_seed(0), _nchw(base), taug.AugmentCfg(image_size=SIZE), 2)
    assert want.shape == (5, 3, 2, SIZE, SIZE, 3)
    assert tuple(got.shape) == (5, 3, 2, 3, SIZE, SIZE) and got.dtype == torch.float32
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    np.testing.assert_allclose(got[:3].numpy(), np.transpose(want[:3], (0, 1, 2, 5, 3, 4)), rtol=1e-5, atol=1e-5)
    # the augmented replicas are fresh draws, one group each
    assert not torch.equal(got[3], got[0]) and not torch.equal(got[3], got[4])
    assert tuple(taug.make_eval_replicas(None, _nchw(base), taug.AugmentCfg(image_size=SIZE), 0).shape) == (
        3, 3, 2, 3, SIZE, SIZE)


@pytest.mark.parametrize("method", ["all", "protonet", "gnnnet_maml"])
def test_eval_program_minibatch_mode_runs(method):
    """The program builds the replica bank once per episode and its members
    train on it; finite softmax scores (sums of two for ``all``)."""
    spec = tep.EpisodeSpec(3, 2, 2)
    gcfg = tgn.GnnNetCfg(**GKW)
    gen = torch.Generator().manual_seed(0)
    bp, bs = tbb.init_backbone(gen, TCFG)
    gp, gs = tbb.init_backbone(gen, TCFG)
    models = {"baseline": (bp, bs), "gnn": (gp, gs, tgn.init_head(gen, gcfg)), "protonet": (gp, gs)}
    tcfg = tee.TransferCfg(fine_tune_epochs=1, linear_epochs=1, bn_mode="minibatch")
    program = tee.make_eval_program(method=method, bcfg=TCFG, gcfg=gcfg, spec=spec, tcfg=tcfg,
                                    aug_cfg=taug.AugmentCfg(image_size=16), gen_examples=1)
    base = torch.randint(0, 256, (3, 4, 3, 18, 18), dtype=torch.uint8, generator=gen)
    scores, accs = program(models, base[None], [torch.Generator().manual_seed(1)])
    assert tuple(scores.shape) == (1, 6, 3) and torch.isfinite(scores).all() and 0.0 <= accs[0] <= 100.0
    np.testing.assert_allclose(scores[0].sum(1).numpy(), np.full(6, 2.0 if method == "all" else 1.0), rtol=1e-5)


def test_fused_scan_refused_in_minibatch_mode():
    spec = tep.EpisodeSpec(3, 2, 2)
    tcfg = tee.TransferCfg(bn_mode="minibatch", inner_scan="fused")
    with pytest.raises(ValueError, match="inner_scan='fused'.*bn_mode='minibatch'"):
        tee.make_eval_program(method="all", bcfg=TCFG, gcfg=tgn.GnnNetCfg(**GKW), spec=spec, tcfg=tcfg,
                              aug_cfg=taug.AugmentCfg(image_size=16), gen_examples=1)
    with pytest.raises(ValueError, match="bn_mode"):
        tee.make_eval_program(method="all", bcfg=TCFG, gcfg=None, spec=spec, tcfg=tee.TransferCfg(bn_mode="batch"),
                              aug_cfg=taug.AugmentCfg(image_size=16), gen_examples=1)
    # the member alone refuses too: a replica bank has no feature bank to scan
    gen = torch.Generator().manual_seed(0)
    gp, gs = tbb.init_backbone(gen, TCFG)
    bank = torch.zeros(4, 3, 2, 3, 16, 16)
    with pytest.raises(ValueError, match="inner_scan='fused'"):
        tee.gnn_member_scores(gp, gs, tgn.init_head(gen, tgn.GnnNetCfg(**GKW)), torch.zeros(3, 4, 3, 16, 16), bank,
                              gen, bcfg=TCFG, gcfg=tgn.GnnNetCfg(**GKW), spec=spec, tcfg=tcfg,
                              aug_cfg=taug.AugmentCfg(image_size=16), gen_examples=1)
