"""The port's ResNet10 (mft_tpu_torch/models/backbone.py) against the JAX
backbone on converted weights, and against the SimpleBlock / BN goldens of
the torch reference (tests/fixtures/golden_reference.npz).

Tolerances: f32 features at rtol/atol 1e-4 (ten conv layers of sums in
another order, each renormalized by batch-stats BN); bf16 at 3e-2 (every
conv output rounds to bf16, 2^-8 relative, through ten layers); the goldens
at the bounds the JAX package's own golden tests use (rtol 1e-4, atol 1e-5).
"""

import os

import jax
import numpy as np
import pytest
import torch

from mft_tpu.models import backbone as jbb
from mft_tpu_torch import convert
from mft_tpu_torch.models import backbone as tbb

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference.npz")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


@pytest.fixture(scope="module")
def model():
    cfg = jbb.resnet10()
    p, s = jax.jit(lambda k: jbb.init_backbone(k, cfg))(jax.random.PRNGKey(0))
    # non-trivial BN parameters and running stats
    rs = np.random.RandomState(0)
    perturb = lambda a: np.asarray(a) + (rs.rand(*np.shape(a)).astype(np.float32) * 0.2 if np.ndim(a) == 1 else 0)
    p = jax.tree.map(perturb, p)
    s = jax.tree.map(perturb, s)
    tp, ts = convert.from_jax(p, s)
    x = rs.rand(6, 32, 32, 3).astype(np.float32)
    return cfg, p, s, tp, ts, x


@pytest.mark.parametrize("train", [True, False])
def test_apply_backbone_f32(model, train):
    cfg, p, s, tp, ts, x = model
    want, _ = jax.jit(lambda p, s, x: jbb.apply_backbone(p, s, x, cfg=cfg, train=train))(p, s, x)
    got, _ = tbb.apply_backbone(tp, ts, nchw(x), cfg=tbb.resnet10(), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_apply_backbone_bf16(model):
    """bf16 rounds every conv output, so two implementations drift apart
    by about as much as each drifts from f32: measured relative L2 1.5e-2
    between the port and JAX at 64 px, 1.2e-2 between JAX bf16 and f32."""
    cfg, p, s, tp, ts, _ = model
    x = np.random.RandomState(1).rand(6, 64, 64, 3).astype(np.float32)
    jcfg = cfg._replace(compute_dtype="bfloat16")
    want, _ = jax.jit(lambda p, s, x: jbb.apply_backbone(p, s, x, cfg=jcfg, train=True))(p, s, x)
    f32, _ = jax.jit(lambda p, s, x: jbb.apply_backbone(p, s, x, cfg=cfg, train=True))(p, s, x)
    got, _ = tbb.apply_backbone(tp, ts, nchw(x), cfg=tbb.resnet10()._replace(compute_dtype="bfloat16"), train=True)
    assert got.dtype == torch.bfloat16
    want, f32 = np.asarray(want, np.float32), np.asarray(f32)
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got.float().numpy(), want) <= min(3e-2, 2 * rel(want, f32))


def test_trunk_then_masked_final_block(model):
    cfg, p, s, tp, ts, x = model
    tcfg = tbb.resnet10()
    fmap_j = jax.jit(lambda p, s, x: jbb.apply_trunk(p, s, x, cfg=cfg, train=True))(p, s, x)
    fmap_t = tbb.apply_trunk(tp, ts, nchw(x), cfg=tcfg, train=True)
    np.testing.assert_allclose(nhwc(fmap_t), np.asarray(fmap_j), rtol=1e-4, atol=1e-4)

    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    _, last_p = jbb.adapt_split(p)
    _, last_s = jbb.adapt_split(s)
    want = jax.jit(lambda b, bs, f, m: jbb.apply_final_block(b, bs, f, cfg=cfg, train=True, sample_mask=m))(
        last_p, last_s, fmap_j, mask)
    trunk_t, last_t = tbb.adapt_split(tp)
    _, last_ts = tbb.adapt_split(ts)
    got = tbb.apply_final_block(last_t, last_ts, fmap_t, cfg=tcfg, train=True, sample_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    # trunk + final block == the whole backbone under batch-stats BN, unmasked
    full = tbb.apply_final_block(last_t, last_ts, fmap_t, cfg=tcfg, train=True)
    whole, _ = tbb.apply_backbone(tbb.adapt_merge(trunk_t, last_t), ts, nchw(x), cfg=tcfg, train=True)
    np.testing.assert_allclose(full.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)


def test_init_backbone_shapes_match_jax():
    tp, ts = tbb.init_backbone(torch.Generator().manual_seed(0), tbb.resnet10())
    jp, js = jbb.init_backbone(jax.random.PRNGKey(0), jbb.resnet10())
    conv, _ = convert.from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tp)) == jax.tree.structure(jax.tree.map(lambda t: 0, conv))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(conv)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.fixture(scope="module")
def g():
    assert os.path.exists(FIX), "run tools/gen_golden_reference.py to regenerate"
    return dict(np.load(FIX))


def _golden_block(g):
    t = lambda k: torch.from_numpy(g[k])
    bn = lambda pre: {"scale": t(f"{pre}.weight"), "bias": t(f"{pre}.bias")}
    run = lambda pre: {"mean": t(f"{pre}.running_mean"), "var": t(f"{pre}.running_var")}
    p = {"conv1": t("simple_block.C1.weight"), "bn1": bn("simple_block.BN1"),
         "conv2": t("simple_block.C2.weight"), "bn2": bn("simple_block.BN2"),
         "conv_sc": t("simple_block.shortcut.weight"), "bn_sc": bn("simple_block.BNshortcut")}
    s = {"bn1": run("simple_block.BN1"), "bn2": run("simple_block.BN2"), "bn_sc": run("simple_block.BNshortcut")}
    return p, s, t("simple_block.x")


@pytest.mark.parametrize("train", [False, True])
def test_simple_block_golden(g, train):
    p, s, x = _golden_block(g)
    ctx = tbb.BNCtx(use_batch_stats=train, update_stats=train, momentum=0.1, sample_mask=None)
    y, new_s = tbb._apply_block(p, s, x, True, ctx)
    want = g["simple_block.y_train" if train else "simple_block.y_eval"]
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-5)
    if train:
        for ours, theirs in [("bn1", "BN1"), ("bn2", "BN2"), ("bn_sc", "BNshortcut")]:
            for k, tk in (("mean", "running_mean"), ("var", "running_var")):
                np.testing.assert_allclose(new_s[ours][k].numpy(), g[f"simple_block.updated.{theirs}.{tk}"],
                                           rtol=1e-4, atol=1e-6)
