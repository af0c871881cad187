"""The port's ``--method all`` slice (mft_tpu_torch/train/eval_engine.py)
against the JAX eval engine on one shared episode: same weights (converted
with ``convert.from_jax``), explicit inner schedules and classifier init,
``gen_examples=0`` (no augment draws), strict f32 (f32 Adam moments, f32
carried parameters), edge op on.

Tolerance: member and ensemble scores at atol 1e-4 with identical argmax
(measured 2.7e-5) after two epochs of each member.  The images are 64 px:
at 32 px the final block sees 1x1 maps, its batch-stats BN normalizes each
channel over 5 values, and a few Adam steps then amplify rounding into
~5e-3 score differences although the first-step gradients agree to 1e-5.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mft_tpu.ops.pallas.edge_mlp as jem
from mft_tpu.core import episode as jep
from mft_tpu.methods import gnnnet as jgn
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

SPEC = (3, 2, 2)  # n_way, n_support, n_query
EPOCHS = 2
SIZE = 64


def _plain_edge(x, w, b, interpret=False):
    """JAX's edge op through its plain-XLA reference (the Pallas kernel in
    interpret mode is held against the port in tests/test_torch_gnn.py)."""
    return jem.edge_abs_diff_matmul_reference(x, w, b)


@pytest.fixture(scope="module")
def setup():
    jspec, tspec = jep.EpisodeSpec(*SPEC), tep.EpisodeSpec(*SPEC)
    jb, jg = jbb.resnet10(), jgn.GnnNetCfg(feat_dim=512, n_way=3, n_support=2, use_pallas=True)
    # weights drawn by the port and handed to JAX in its layout
    gen = torch.Generator().manual_seed(0)
    bp, bs = convert.to_jax(*tbb.init_backbone(gen, tbb.resnet10()))
    gp, gs = convert.to_jax(*tbb.init_backbone(gen, tbb.resnet10()))
    head, _ = convert.to_jax(tgn.init_head(gen, tgn.GnnNetCfg(feat_dim=512, n_way=3, n_support=2)))
    rs = np.random.RandomState(0)
    base = rs.randint(0, 256, (3, 4, int(SIZE * 1.15), int(SIZE * 1.15), 3)).astype(np.uint8)
    gnn_perms = np.stack([rs.permutation(3 * jspec.support_size) for _ in range(EPOCHS)])
    lin_perms = np.stack([rs.permutation(jspec.support_size) for _ in range(EPOCHS)])
    head0 = {"w": (rs.randn(512, 3) * 0.04).astype(np.float32), "b": (rs.randn(3) * 0.04).astype(np.float32)}
    return dict(jspec=jspec, tspec=tspec, jb=jb, jg=jg, bp=bp, bs=bs, gp=gp, gs=gs, head=head, base=base,
                gnn_perms=gnn_perms, lin_perms=lin_perms, head0=head0)


def _jax_members(s):
    jtcfg = jee.TransferCfg(fine_tune_epochs=EPOCHS, linear_epochs=EPOCHS, opt_state_dtype="float32")
    aug = jaug.AugmentCfg(image_size=SIZE)
    spec = s["jspec"]
    g_cfg = jil.InnerLoopCfg(EPOCHS, 5, 3 * spec.support_size)
    l_cfg = jil.InnerLoopCfg(EPOCHS, 5, spec.support_size)

    def run(bp, bs, gp, gs, head, base, head0):
        episode = jaug.center_batch(base, SIZE)
        support = base[:, : spec.n_support]
        k = jax.random.PRNGKey(1)
        kw = dict(bcfg=s["jb"], spec=spec, tcfg=jtcfg, aug_cfg=aug, gen_examples=0)
        s_lin = jee.linear_member_scores(bp, bs, episode, support, k, k, head0=head0,
                                         inner_schedule=jil.schedule_from_perms(s["lin_perms"], l_cfg), **kw)
        s_gnn = jee.gnn_member_scores(gp, gs, head, episode, support, k, k, gcfg=s["jg"],
                                      inner_schedule=jil.schedule_from_perms(s["gnn_perms"], g_cfg), **kw)
        return s_lin, s_gnn

    with mock.patch.object(jem, "edge_abs_diff_matmul", _plain_edge):
        out = jax.jit(run)(s["bp"], s["bs"], s["gp"], s["gs"], s["head"], s["base"], s["head0"])
    return [np.asarray(o) for o in out]


def _torch_members(s):
    spec = s["tspec"]
    tcfg = tee.TransferCfg(fine_tune_epochs=EPOCHS, linear_epochs=EPOCHS, opt_state_dtype="float32")
    aug = taug.AugmentCfg(image_size=SIZE)
    bp, bs = convert.from_jax(s["bp"], s["bs"])
    gp, gs = convert.from_jax(s["gp"], s["gs"])
    head, _ = convert.from_jax(s["head"])
    head0, _ = convert.from_jax(s["head0"])
    base = torch.from_numpy(s["base"]).permute(0, 1, 4, 2, 3)
    episode = taug.center_batch(base, SIZE)
    support = base[:, : spec.n_support]
    kw = dict(bcfg=tbb.resnet10(), spec=spec, tcfg=tcfg, aug_cfg=aug, gen_examples=0)
    s_lin = tee.linear_member_scores(
        bp, bs, episode, support, None, head0=head0,
        inner_schedule=til.schedule_from_perms(s["lin_perms"], til.InnerLoopCfg(EPOCHS, 5, spec.support_size)), **kw)
    s_gnn = tee.gnn_member_scores(
        gp, gs, head, episode, support, None, gcfg=tgn.GnnNetCfg(feat_dim=512, n_way=3, n_support=2, use_pallas=True),
        inner_schedule=til.schedule_from_perms(s["gnn_perms"], til.InnerLoopCfg(EPOCHS, 5, 3 * spec.support_size)),
        **kw)
    return s_lin.numpy(), s_gnn.numpy()


def test_members_and_ensemble_match_jax(setup):
    j_lin, j_gnn = _jax_members(setup)
    t_lin, t_gnn = _torch_members(setup)
    assert t_lin.shape == t_gnn.shape == (6, 3)
    np.testing.assert_allclose(t_lin, j_lin, atol=1e-4)
    np.testing.assert_allclose(t_gnn, j_gnn, atol=1e-4)
    np.testing.assert_allclose(t_lin + t_gnn, j_lin + j_gnn, atol=1e-4)
    np.testing.assert_array_equal((t_lin + t_gnn).argmax(1), (j_lin + j_gnn).argmax(1))
    want_acc = float(jee.episode_accuracy(jnp.asarray(j_lin + j_gnn), setup["jspec"]))
    assert tee.episode_accuracy(torch.from_numpy(t_lin + t_gnn), setup["tspec"]) == pytest.approx(want_acc)


def test_bank_fmap_clean_triplet_matches(setup):
    s = setup
    jtrunk, _ = jbb.adapt_split(s["gp"])
    jtrunk_s, _ = jbb.adapt_split(s["gs"])
    support = s["base"][:, :2]
    want = jax.jit(lambda p, st, x: jee._bank_fmap(p, st, x, None, bcfg=s["jb"], aug_cfg=jaug.AugmentCfg(image_size=SIZE),
                                                   gen_examples=0, bn_train=True))(jtrunk, jtrunk_s, support)
    gp, gs = convert.from_jax(s["gp"], s["gs"])
    ttrunk, _ = tbb.adapt_split(gp)
    ttrunk_s, _ = tbb.adapt_split(gs)
    got = tee._bank_fmap(ttrunk, ttrunk_s, torch.from_numpy(support).permute(0, 1, 4, 2, 3)[None], [None],
                         bcfg=tbb.resnet10(), aug_cfg=taug.AugmentCfg(image_size=SIZE), gen_examples=0)[0]
    assert got.shape == (18, 256, SIZE // 16, SIZE // 16)
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_bank_fmap_with_augment_groups_shape():
    p, s = tbb.init_backbone(torch.Generator().manual_seed(0), tbb.resnet10())
    trunk, _ = tbb.adapt_split(p)
    trunk_s, _ = tbb.adapt_split(s)
    support = torch.randint(0, 256, (2, 3, 3, 18, 18), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    fmap = tee._bank_fmap(trunk, trunk_s, support[None], [torch.Generator().manual_seed(2)], bcfg=tbb.resnet10(),
                          aug_cfg=taug.AugmentCfg(image_size=16), gen_examples=2)[0]
    assert fmap.shape == (5 * 6, 256, 1, 1)
    assert torch.equal(fmap[:6], fmap[6:12]) and torch.equal(fmap[:6], fmap[12:18])
    assert not torch.equal(fmap[:6], fmap[18:24])


def test_episode_helpers_match():
    for spec in (jep.EpisodeSpec(5, 5, 15), jep.EpisodeSpec(3, 2, 4)):
        t = tep.EpisodeSpec(*spec)
        np.testing.assert_array_equal(tep.support_labels(t).numpy(), np.asarray(jep.support_labels(spec)))
        np.testing.assert_array_equal(tep.query_labels(t).numpy(), np.asarray(jep.query_labels(spec)))
        np.testing.assert_array_equal(tep.support_onehot_with_query_slot(t).numpy(),
                                      np.asarray(jep.support_onehot_with_query_slot(spec)))
        np.testing.assert_array_equal(tee.bank_labels(t, 4).numpy(), np.asarray(jee.bank_labels(spec, 4)))
        assert (t.n_per_class, t.support_size, t.query_size, t.total) == (
            spec.n_per_class, spec.support_size, spec.query_size, spec.total)
    x = np.arange(3 * 4 * 2).reshape(3, 4, 2)
    np.testing.assert_array_equal(tep.flatten_episode(torch.from_numpy(x)).numpy(), np.asarray(jep.flatten_episode(x)))
    accs = np.array([80.0, 93.3, 100.0, 66.7])
    assert tee.mean_ci95(accs) == pytest.approx(jee.mean_ci95(accs))
