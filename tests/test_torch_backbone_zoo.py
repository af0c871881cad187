"""The port's backbone zoo (mft_tpu_torch/models/backbone.py: ResNet10_FW,
ResNet18, ResNet34, the split-backbone pieces, the bottleneck block) against
the JAX package's, and against the torch reference's goldens
(tests/fixtures/golden_reference.npz).

Tolerances.  Forward passes in f64 (``jax.enable_x64``, ``compute_dtype
='float64'`` in both packages) on the same weights: rtol 1e-8, atol 1e-10
(the same sums in another order, some 1e-15 apart, renormalized by up to 37
batch-statistics BNs).  FWT noise in training is JAX's own draws, split as
its step splits them (:func:`jax_fwt_draws`), fed to the port.  The
reference goldens at the bounds of the JAX package's own golden tests
(rtol 1e-4 / atol 1e-5 in f32; the FWT train-mode golden rtol 1e-10 in
f64).  Structure and bit-exactness (init shapes, masks, frozen leaves, the
``.tar`` round trip) are exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from mft_tpu.models import backbone as jbb
from mft_tpu.train import optimizers as jopt
from mft_tpu.utils import torch_import as jti
from mft_tpu_torch import convert
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops.norm import batch_norm, softplus100
from mft_tpu_torch.train import optimizers as topt
from mft_tpu_torch.utils.checkpoint import keyed

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference.npz")
RTOL, ATOL = 1e-8, 1e-10
#: every registry model, and a two-stage bottleneck backbone (its first
#: block keeps the width: identity shortcut; its second halves: conv shortcut)
MODELS = tuple(jbb.MODEL_REGISTRY) + ("bottleneck",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(name: str):
    """The JAX and port configs of a model."""
    if name == "bottleneck":
        return (jbb.ResNetCfg((1, 1), (64, 128), "bottleneck"),
                tbb.ResNetCfg((1, 1), (64, 128), block="bottleneck"))
    return jbb.MODEL_REGISTRY[name](), tbb.MODEL_REGISTRY[name]()


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def jax_model(jcfg, seed: int = 0):
    """JAX-initialized ``(params, stats)`` as f64 numpy, every 1-D leaf (BN
    parameters and stats, the FWT strengths, C2's bias) perturbed."""
    p, s = jax.jit(lambda k: jbb.init_backbone(k, jcfg))(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    perturb = lambda a: np.asarray(a, np.float64) + (rs.rand(*np.shape(a)) * 0.2 if np.ndim(a) == 1 else 0.0)
    return jax.tree.map(perturb, p), jax.tree.map(perturb, s)


def jax_fwt_draws(rng, jcfg, dtype=jnp.float64):
    """The FWT noise JAX's ``apply_backbone(rng=rng)`` draws, as the port's
    per-block dicts (``tbb.draw_fwt_noise``'s layout): the key split per
    block (backbone.py:332), then ``r1, r2``, then ``kg, kb`` (:241-247)."""
    cin = 64 if jcfg.stem else jcfg.stem_in
    shortcuts = []
    for n, cout in zip(jcfg.stage_sizes, jcfg.widths):
        for _ in range(n):
            shortcuts.append((cout, cin != cout))
            cin = cout
    keys = jax.random.split(rng, len(shortcuts))
    out = []
    with jax.enable_x64():
        for key, (cout, sc) in zip(keys, shortcuts):
            r1, r2 = jax.random.split(key)
            d = {}
            for tag, r in (("2", r1), ("_sc", r2)) if sc else (("2", r1),):
                kg, kb = jax.random.split(r)
                d["gamma" + tag] = torch.from_numpy(np.array(jax.random.normal(kg, (cout,), dtype)))
                d["beta" + tag] = torch.from_numpy(np.array(jax.random.normal(kb, (cout,), dtype)))
            out.append(d)
    return out


def _input(jcfg, n: int, size: int, seed: int):
    """NHWC images (or the stem-less variant's 256-channel maps) and their
    NCHW copy."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, size, size, 3) if jcfg.stem else rs.randn(n, 4, 4, jcfg.stem_in)
    return x, torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _close_tree(got, want, label):
    paths = [jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert len(jax.tree.leaves(got)) == len(paths), label
    for path, a, b in zip(paths, jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=f"{label}{path}")


# --------------------------------------------------------------------------
# init and forward against JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_init_shapes_match_jax(name):
    """The port's init has JAX's tree (its FWT strengths 0.3 / 0.5, C2's
    bias within torch's bound) with every leaf's shape and dtype after
    ``convert.from_jax``."""
    jcfg, tcfg = cfgs(name)
    tp, ts = tbb.init_backbone(torch.Generator().manual_seed(0), tcfg)
    jp, js = jax.jit(lambda k: jbb.init_backbone(k, jcfg))(jax.random.PRNGKey(0))
    conv_p, conv_s = convert.from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    for got, want in ((keyed(tp), keyed(conv_p)), (keyed(ts), keyed(conv_s))):
        assert set(got) == set(want)
        for k, a in got.items():
            assert a.shape == want[k].shape and a.dtype == want[k].dtype, k
    want = keyed(conv_p)
    for key, a in keyed(tp).items():
        if "fwt_" in key:  # constants: the same values in both packages
            assert torch.equal(a, want[key]), key
        if "conv2_b" in key:
            assert float(a.abs().max()) <= 1.0 / np.sqrt(a.numel() * 9)
    assert tcfg.feat_dim == (jcfg.feat_dim if jcfg.flatten else (jcfg.feat_dim[2], 7, 7))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax_f64(name, train):
    """Each model's forward (features and, in training, the updated running
    stats) against JAX's on the same weights and inputs; ResNet10_FW in
    training with JAX's noise draws."""
    jcfg, tcfg = cfgs(name)
    jcfg, tcfg = jcfg._replace(compute_dtype="float64"), tcfg._replace(compute_dtype="float64")
    jp, js = jax_model(jcfg)
    x, xt = _input(jcfg, 3, 64, 1)
    rng = jax.random.PRNGKey(7)
    with jax.enable_x64():
        fwd = jax.jit(lambda p, s, x: jbb.apply_backbone(p, s, x, cfg=jcfg, train=train, update_stats=train,
                                                         rng=rng))
        want_y, want_s = jax.tree.map(np.asarray, fwd(jp, js, x))
    tp, ts = convert.from_jax(jp, js)
    noise = jax_fwt_draws(rng, jcfg) if jcfg.block == "fwt" else None
    got_y, got_s = tbb.apply_backbone(tp, ts, xt, cfg=tcfg, train=train, update_stats=train, fwt_noise=noise)
    got_y = got_y.numpy() if tcfg.flatten else np.transpose(got_y.numpy(), (0, 2, 3, 1))
    np.testing.assert_allclose(got_y, want_y, rtol=RTOL, atol=ATOL)
    _close_tree(convert.to_jax(tp, got_s)[1], want_s, "stats")
    if jcfg.block == "fwt" and train:  # the noise is on: without it the features differ
        plain, _ = tbb.apply_backbone(tp, ts, xt, cfg=tcfg, train=True)
        assert not np.allclose(plain.numpy(), want_y, atol=1e-3)


def test_start_stage_and_noise_draws():
    """``start_stage`` resumes from a stage's input map as JAX's does;
    ``draw_fwt_noise`` gives every block its draws (the shortcut's where the
    block has one), and a list of the wrong length is refused."""
    jcfg, tcfg = cfgs("ResNet10_FW")
    jcfg, tcfg = jcfg._replace(compute_dtype="float64"), tcfg._replace(compute_dtype="float64")
    jp, js = jax_model(jcfg, 3)
    tp, ts = convert.from_jax(jp, js)
    fmap = np.random.RandomState(2).randn(2, 8, 8, 128)
    with jax.enable_x64():
        want, _ = jax.jit(lambda p, s, x: jbb.apply_backbone(p, s, x, cfg=jcfg, train=True, start_stage=2))(
            jp, js, fmap)
    got, _ = tbb.apply_backbone(tp, ts, torch.from_numpy(np.ascontiguousarray(fmap.transpose(0, 3, 1, 2))),
                                cfg=tcfg, train=True, start_stage=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    _, xt = _input(jcfg, 2, 32, 4)
    draws = tbb.draw_fwt_noise(torch.Generator().manual_seed(5), tcfg, dtype=torch.float64)
    assert [sorted(d) for d in draws] == [["beta2", "gamma2"]] + [["beta2", "beta_sc", "gamma2", "gamma_sc"]] * 3
    assert [d["gamma2"].shape[0] for d in draws] == [64, 128, 256, 512]
    noisy, _ = tbb.apply_backbone(tp, ts, xt, cfg=tcfg, train=True, fwt_noise=draws)
    plain, _ = tbb.apply_backbone(tp, ts, xt, cfg=tcfg, train=True, fwt_noise=[None] * 4)
    assert torch.equal(plain, tbb.apply_backbone(tp, ts, xt, cfg=tcfg, train=True)[0])
    assert not torch.allclose(noisy, plain)
    with pytest.raises(ValueError, match="blocks"):
        tbb.apply_backbone(tp, ts, xt, cfg=tcfg, train=True, fwt_noise=draws[:2])


# --------------------------------------------------------------------------
# the reference's goldens through the port
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def g():
    assert os.path.exists(FIX), "run tools/gen_golden_reference.py to regenerate"
    return dict(np.load(FIX))


def _bn(g, pre):
    return {"scale": torch.from_numpy(g[f"{pre}.weight"]), "bias": torch.from_numpy(g[f"{pre}.bias"])}


def _run(g, pre):
    return {"mean": torch.from_numpy(g[f"{pre}.running_mean"]), "var": torch.from_numpy(g[f"{pre}.running_var"])}


def test_simple_block2_eval_mode_golden(g):
    """SimpleBlock2 (the ResNet10_FW block, reference backbone.py:90-130) in
    eval mode: the FWT layers reduce to running-stat BN (JAX
    tests/test_golden_reference.py's test of the same name)."""
    t = lambda k: torch.from_numpy(g[f"simple_block2.{k}"])
    p = {"conv1": t("C1.weight"), "bn1": _bn(g, "simple_block2.BN1"), "conv2": t("C2.weight"),
         "bn2": _bn(g, "simple_block2.BN2"), "fwt_gamma2": t("BN2.gamma").reshape(-1),
         "fwt_beta2": t("BN2.beta").reshape(-1), "conv_sc": t("shortcut.weight"),
         "bn_sc": _bn(g, "simple_block2.BNshortcut"), "fwt_gamma_sc": t("BNshortcut.gamma").reshape(-1),
         "fwt_beta_sc": t("BNshortcut.beta").reshape(-1)}
    s = {"bn1": _run(g, "simple_block2.BN1"), "bn2": _run(g, "simple_block2.BN2"),
         "bn_sc": _run(g, "simple_block2.BNshortcut")}
    ctx = tbb.BNCtx(use_batch_stats=False, update_stats=False, momentum=0.1, sample_mask=None)
    y, _ = tbb._apply_block(p, s, t("x"), True, ctx)
    np.testing.assert_allclose(y.numpy(), g["simple_block2.y_eval"], rtol=1e-4, atol=1e-5)


def test_fwt_train_mode_golden(g):
    """FeatureWiseTransformation2d_fw in training against the reference's
    own forward (backbone.py:333-350) with its recorded noise draws:
    batch-stats BN with the running-stat update, then the port's
    ``_fwt_noise`` and ``softplus100``, f64."""
    x = torch.from_numpy(g["fwt.x"]).double()
    p = {"scale": torch.from_numpy(g["fwt.weight"]).double(), "bias": torch.from_numpy(g["fwt.bias"]).double()}
    s = {"mean": torch.from_numpy(g["fwt.running_mean"]).double(), "var": torch.from_numpy(g["fwt.running_var"]).double()}
    out, new_s = batch_norm(x, p, s, use_batch_stats=True, update_stats=True, momentum=0.1)
    f64 = lambda k: torch.from_numpy(np.asarray(g[k], np.float64))
    y = tbb._fwt_noise(out, f64("fwt.gamma").reshape(-1), f64("fwt.beta").reshape(-1), f64("fwt.eps_gamma"),
                       f64("fwt.eps_beta"))
    np.testing.assert_allclose(y.numpy(), g["fwt.y_train"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(new_s["mean"].numpy(), g["fwt.updated.running_mean"], rtol=1e-10)
    np.testing.assert_allclose(new_s["var"].numpy(), g["fwt.updated.running_var"], rtol=1e-10)
    # softplus100 = F.softplus(beta=100), on both sides of its linear switch
    v = torch.linspace(-0.5, 0.5, 101, dtype=torch.float64)
    np.testing.assert_allclose(softplus100(v).numpy(), torch.nn.functional.softplus(v, beta=100).numpy(), rtol=1e-12)


def test_bottleneck_block_golden(g):
    """BottleneckBlock (reference backbone.py:264-311) in training mode."""
    t = lambda k: torch.from_numpy(g[f"bottleneck.{k}"])
    p = {"conv1": t("C1.weight"), "bn1": _bn(g, "bottleneck.BN1"), "conv2": t("C2.weight"), "conv2_b": t("C2.bias"),
         "bn2": _bn(g, "bottleneck.BN2"), "conv3": t("C3.weight"), "bn3": _bn(g, "bottleneck.BN3"),
         "conv_sc": t("shortcut.weight")}
    s = {k: _run(g, f"bottleneck.{k.upper()}") for k in ("bn1", "bn2", "bn3")}
    ctx = tbb.BNCtx(use_batch_stats=True, update_stats=False, momentum=0.1, sample_mask=None)
    y, _ = tbb._apply_block(p, s, t("x"), True, ctx)
    np.testing.assert_allclose(y.numpy(), g["bottleneck.y_train"], rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# the split backbone and the adaptation boundary
# --------------------------------------------------------------------------


def test_split_backbone_variants_compose():
    """ResNet8 / ResNet_3 emit 256-channel stage-3 maps, ResNet_fin consumes
    them without a stem and gives the 512-d embedding (JAX
    tests/test_backbone.py's composition); ResNet_fin's single stage is the
    adapted block and its trunk holds nothing."""
    _, xt = _input(jbb.resnet10(), 2, 64, 0)
    for name in ("ResNet8", "ResNet_3"):
        cfg = tbb.MODEL_REGISTRY[name]()
        assert cfg.feat_dim == (256, 7, 7) and not cfg.flatten
        p, s = tbb.init_backbone(torch.Generator().manual_seed(0), cfg)
        maps, _ = tbb.apply_backbone(p, s, xt, cfg=cfg, train=True)
        assert maps.shape == (2, 256, 4, 4)
    fin = tbb.resnet_fin()
    assert fin.feat_dim == 512
    pf, sf = tbb.init_backbone(torch.Generator().manual_seed(1), fin)
    feats, _ = tbb.apply_backbone(pf, sf, maps, cfg=fin, train=True)
    assert feats.shape == (2, 512)
    trunk, last = tbb.adapt_split(pf)
    assert set(last) == {"conv1", "bn1", "conv2", "bn2", "conv_sc", "bn_sc"}
    assert not pytree.tree_leaves(trunk)
    trunk_s, last_s = tbb.adapt_split(sf)
    fmap = tbb.apply_trunk(trunk, trunk_s, maps, cfg=fin, train=True)
    assert torch.equal(fmap, maps)  # stem-less, one block: the trunk is the identity
    torch.testing.assert_close(tbb.apply_final_block(last, last_s, fmap, cfg=fin, train=True), feats, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet34"])
def test_resnet18_34_adapt_boundary(name):
    """The structural boundary (README "Documented deviations"): the
    adapted block is the last stage's LAST block, 512 -> 512 with an
    identity shortcut, and the stage's earlier blocks stay in the trunk;
    trunk + final block equals the whole backbone and JAX's final block, f64."""
    jcfg, tcfg = cfgs(name)
    jcfg, tcfg = jcfg._replace(compute_dtype="float64"), tcfg._replace(compute_dtype="float64")
    jp, js = jax_model(jcfg, 1)
    tp, ts = convert.from_jax(jp, js)
    trunk, last = tbb.adapt_split(tp)
    trunk_s, last_s = tbb.adapt_split(ts)
    assert set(last) == {"conv1", "bn1", "conv2", "bn2"}
    assert len(trunk["stages"][-1]) == tcfg.stage_sizes[-1] and trunk["stages"][-1][0]
    assert not tbb.final_block_has_shortcut(tcfg)
    merged, full = keyed(tbb.adapt_merge(trunk, last)), keyed(tp)
    assert set(merged) == set(full) and all(torch.equal(v, full[k]) for k, v in merged.items())
    x, xt = _input(jcfg, 3, 64, 2)
    fmap = tbb.apply_trunk(trunk, trunk_s, xt, cfg=tcfg, train=True)
    got = tbb.apply_final_block(last, last_s, fmap, cfg=tcfg, train=True)
    whole, _ = tbb.apply_backbone(tp, ts, xt, cfg=tcfg, train=True)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-12, atol=1e-14)
    _, jlast = jbb.adapt_split(jp)
    _, jlast_s = jbb.adapt_split(js)
    with jax.enable_x64():
        want = jax.jit(lambda b, s, f: jbb.apply_final_block(b, s, f, cfg=jcfg, train=True))(
            jlast, jlast_s, np.transpose(fmap.numpy(), (0, 2, 3, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["ResNet10_FW", "ResNet18", "bottleneck"])
def test_final_block_lanes_equal_each_lane(name):
    """``apply_final_block_lanes`` on three lanes of per-lane weights equals
    the final block on each lane alone: the FWT block (strengths ride along
    unused), the identity-shortcut block, the bottleneck (its C2 bias)."""
    _, tcfg = cfgs(name)
    tcfg = tcfg._replace(compute_dtype="float64")
    p, s = tbb.init_backbone(torch.Generator().manual_seed(2), tcfg, dtype=torch.float64)
    _, block = tbb.adapt_split(p)
    _, block_s = tbb.adapt_split(s)
    lanes = pytree.tree_map(lambda v: torch.stack([v * (1 + 0.1 * i) for i in range(3)]), block)
    cin = block["conv1"].shape[1]
    fmap = torch.from_numpy(np.random.RandomState(3).randn(3, 5, cin, 4, 4))
    w = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0], dtype=torch.float64)
    got = tbb.apply_final_block_lanes(lanes, block_s, fmap, cfg=tcfg, train=True, sample_mask=w)
    for i in range(3):
        one = tbb.apply_final_block(pytree.tree_map(lambda t: t[i], lanes), block_s, fmap[i], cfg=tcfg, train=True,
                                    sample_mask=w)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=1e-12, atol=1e-14)


# --------------------------------------------------------------------------
# the trainable mask and freeze_masked
# --------------------------------------------------------------------------


def test_fwt_trainable_mask_matches_jax():
    for name in ("ResNet10", "ResNet10_FW"):
        jcfg, tcfg = cfgs(name)
        jp, _ = jax_model(jcfg)
        tp, _ = convert.from_jax(jp)
        want = jbb.fwt_trainable_mask(jp)
        got = tbb.fwt_trainable_mask(tp)
        assert jax.tree.leaves(got) == jax.tree.leaves(want)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert all(jax.tree.leaves(got)) == (name == "ResNet10")


def test_freeze_masked_leaves_frozen_leaves_bit_exact():
    """Three Adam steps through ``freeze_masked``: every frozen leaf is
    bit-for-bit its start and keeps no moments; every other leaf moves as
    plain ``torch_adam`` on the tree without the frozen leaves moves it; and
    the whole thing equals JAX's ``freeze_masked`` in f64 (rtol 1e-8)."""
    jcfg, tcfg = cfgs("ResNet10_FW")
    jp, _ = jax_model(jcfg, 4)
    tp, _ = convert.from_jax(jp)
    mask = tbb.fwt_trainable_mask(tp)
    tx = topt.freeze_masked(topt.torch_adam(1e-3), mask)
    plain = topt.torch_adam(1e-3)
    state = tx.init(tp)
    assert all("fwt_" not in pytree.keystr(path) for path, _ in pytree.tree_flatten_with_path(state["mu"])[0])
    pruned = topt._prune(tp, mask)
    pstate = plain.init(pruned)
    rs = np.random.RandomState(5)
    grads_np = [jax.tree.map(lambda a: rs.randn(*np.shape(a)), jp) for _ in range(3)]
    p = tp
    for gnp in grads_np:
        gt, _ = convert.from_jax(gnp)
        upd, state = tx.update(gt, state, p)
        pupd, pstate = plain.update(topt._prune(gt, mask), pstate, pruned)
        p = pytree.tree_map(lambda a, u: a + u, p, upd)
        pruned = pytree.tree_map(lambda a, u: a + u, pruned, pupd)
    for (path, a), b in zip(pytree.tree_flatten_with_path(p)[0], pytree.tree_leaves(tp)):
        if "fwt_" in pytree.keystr(path):
            assert torch.equal(a, b), pytree.keystr(path)
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(topt._prune(p, mask)), pytree.tree_leaves(pruned)))
    with jax.enable_x64():
        jtx = jopt.freeze_masked(jopt.torch_adam(1e-3), jbb.fwt_trainable_mask(jp))
        jpar = jax.tree.map(jnp.asarray, jp)
        jst = jtx.init(jpar)
        for gnp in grads_np:
            upd, jst = jtx.update(jax.tree.map(jnp.asarray, gnp), jst, jpar)
            jpar = jax.tree.map(lambda a, u: a + u, jpar, upd)
        jpar = jax.tree.map(np.asarray, jpar)
        jst = jax.tree.map(np.asarray, jst)
    _close_tree(convert.to_jax(p)[0], jpar, "params")
    moments = convert.adam_from_jax(jst)
    assert moments["t"] == 3 == state["t"]
    for k in ("mu", "nu"):
        got, want = keyed(state[k]), keyed(moments[k])
        assert set(got) == set(want) and not any("fwt_" in path for path in got)
        for path, a in got.items():
            np.testing.assert_allclose(a.numpy(), want[path].numpy(), rtol=RTOL, atol=1e-14, err_msg=path)


# --------------------------------------------------------------------------
# .tar state dicts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ResNet10_FW", "ResNet18", "ResNet_fin"])
def test_tar_round_trip(name, tmp_path):
    """``to_state_dict`` -> ``.tar`` -> ``from_state_dict`` (strict) gives the
    same trees bit for bit, and the state dict is JAX
    ``torch_import.export_state_dict``'s on the same weights: the same keys
    (ResNet10_FW's ``(1, C, 1, 1)`` ``BN2.gamma/beta`` and
    ``BNshortcut.gamma/beta``, ResNet_fin's blocks from ``trunk.0``), the same
    values."""
    jcfg, tcfg = cfgs(name)
    jp, js = jax_model(jcfg, 6)
    jp32 = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    js32 = jax.tree.map(lambda a: np.asarray(a, np.float32), js)
    tp, ts = convert.from_jax(jp32, js32)
    sd = convert.to_state_dict({"feature": tp}, ts)
    want = jti.export_state_dict({"feature": jp32}, js32, jcfg)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    if name == "ResNet10_FW":
        assert tuple(sd["feature.trunk.7.BNshortcut.gamma"].shape) == (1, 512, 1, 1)
        assert "feature.trunk.4.BNshortcut.gamma" not in sd  # 64 -> 64: no shortcut
    path = str(tmp_path / "1.tar")
    convert.save_tar(path, 1, sd)
    epoch, loaded = convert.load_tar(path)
    back_p, back_s = convert.from_state_dict(loaded, tcfg)
    assert epoch == 1
    for got, ref in ((keyed(back_p["feature"]), keyed(tp)), (keyed(back_s), keyed(ts))):
        assert set(got) == set(ref) and all(torch.equal(v, ref[k]) for k, v in got.items())
    if name == "ResNet10_FW":  # the plain ResNet10 mapping leaves the strengths unconsumed, and says so
        with pytest.raises(ValueError, match="not mapped"):
            convert.from_state_dict(loaded, tbb.resnet10())
