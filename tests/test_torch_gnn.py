"""The port's GNN head (mft_tpu_torch/models/gnn.py, methods/gnnnet.py) and
its edge op (kernels/edge_mlp.py) against the JAX package.

On the CPU the edge op computes its plain version; it is held against the
JAX Pallas kernel run in interpret mode (as tests/test_pallas.py runs it),
forward and custom-VJP gradient.  The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py.

Tolerances: f32 at rtol/atol 1e-4 (the edge op sums F <= 229 products per
output; the GNN stacks five BN-renormalized layers), as tests/test_pallas.py
uses for the kernel.
"""

import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mft_tpu.ops.pallas.edge_mlp as jem
from mft_tpu.methods import gnnnet as jgn
from mft_tpu.models import gnn as jgnn
from mft_tpu_torch import convert
from mft_tpu_torch.kernels import edge_mlp as tem
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.models import gnn as tgnn

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_reference.npz")


def _interpret(x, w, b, interpret=False):
    return _orig(x, w, b, True)


_orig = jem.edge_abs_diff_matmul


def _edge_inputs(b, n, f, c, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n, f).astype(np.float32), (rs.randn(f, c) * 0.05).astype(np.float32),
            rs.randn(c).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 30, 133, 192), (1, 130, 40, 24)])
def test_edge_forward_matches_pallas_interpret(shape):
    x, w, b = _edge_inputs(*shape, seed=0)
    want = np.asarray(jax.jit(lambda x, w, b: jem.edge_abs_diff_matmul(x, w, b, True))(x, w, b))
    got = tem.edge_abs_diff_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 30, 24, 16), (1, 130, 12, 8)])
def test_edge_gradient_matches_custom_vjp(shape):
    """The autograd.Function's backward (``_edge_bwd``) and autograd through
    the plain version both equal JAX's custom VJP of the Pallas kernel."""
    x, w, b = _edge_inputs(*shape, seed=1)
    loss = lambda x, w, b: jnp.sum(jnp.sin(jem.edge_abs_diff_matmul(x, w, b, True)))
    gx, gw, gb = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, w, b)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w.T.copy()).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = tem.edge_abs_diff_matmul(xt, wt, bt)
    g = torch.cos(out.detach())  # d sum(sin(out)) / d out
    dx, dw, db = tem._edge_bwd(xt.detach(), wt.detach(), g)
    ax, aw, ab = torch.autograd.grad(torch.sin(out).sum(), (xt, wt, bt))
    for ours, auto, want in ((dx, ax, gx), (dw.T, aw.T, gw), (db, ab, gb)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(auto.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_edge_wrapper_refuses_bad_inputs():
    x = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError):
        tem._launch(x, torch.zeros(5, 4), torch.zeros(5))  # CPU tensors never reach the kernel
    with pytest.raises(ValueError):
        tem._launch(x, torch.zeros(5, 3), torch.zeros(5))


@pytest.fixture(scope="module")
def head():
    cfg = jgn.GnnNetCfg(feat_dim=16, n_way=3, n_support=2, proj_dim=12, gnn_nf=8)
    h = jax.jit(lambda k: jgn.init_head(k, cfg))(jax.random.PRNGKey(0))
    h = jax.tree.map(np.asarray, h)
    th, _ = convert.from_jax(h)
    return cfg, h, th


@pytest.mark.parametrize("use_pallas", [False, True])
def test_wcompute_and_gnn_match(head, use_pallas):
    cfg, h, th = head
    x = np.random.RandomState(2).randn(4, 9, cfg.gnn_cfg.in_features).astype(np.float32)
    with mock.patch.object(jem, "edge_abs_diff_matmul", _interpret):
        w_j = jax.jit(lambda p, x: jgnn.apply_wcompute(p, x, use_pallas))(h["gnn"]["layers"][0]["w"], x)
        out_j = jax.jit(lambda p, x: jgnn.apply_gnn(p, x, use_pallas))(h["gnn"], x)
    w_t = tgnn.apply_wcompute(th["gnn"]["layers"][0]["w"], torch.from_numpy(x), use_pallas)
    out_t = tgnn.apply_gnn(th["gnn"], torch.from_numpy(x), use_pallas)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gnn_scores_match(head, use_pallas):
    cfg, h, th = head
    cfg = cfg._replace(use_pallas=use_pallas)
    z = np.random.RandomState(3).randn(3, 2 + 4, 16).astype(np.float32)
    with mock.patch.object(jem, "edge_abs_diff_matmul", _interpret):
        want = jax.jit(lambda h, z: jgn.gnn_scores(h, z, cfg, 4))(h, z)
    tcfg = tgn.GnnNetCfg(**cfg._asdict())
    got = tgn.gnn_scores(th, torch.from_numpy(z), tcfg, 4)
    assert got.shape == (12, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_init_head_shapes_match_jax():
    cfg = tgn.GnnNetCfg()
    th = tgn.init_head(torch.Generator().manual_seed(0), cfg)
    jh, _ = convert.from_jax(jax.tree.map(np.asarray, jgn.init_head(jax.random.PRNGKey(0), jgn.GnnNetCfg())))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, th)) == jax.tree.structure(jax.tree.map(lambda t: 0, jh))
    for a, b in zip(jax.tree.leaves(th), jax.tree.leaves(jh)):
        assert a.shape == b.shape


@pytest.fixture(scope="module")
def g():
    assert os.path.exists(FIX), "run tools/gen_golden_reference.py to regenerate"
    return dict(np.load(FIX))


def _wcompute_tree(g, prefix):
    t = lambda k: torch.from_numpy(g[k])
    p = {}
    for i in range(1, 5):
        p[f"conv{i}"] = {"w": t(f"{prefix}.conv2d_{i}.weight")[:, :, 0, 0], "b": t(f"{prefix}.conv2d_{i}.bias")}
        p[f"bn{i}"] = {"scale": t(f"{prefix}.bn_{i}.weight"), "bias": t(f"{prefix}.bn_{i}.bias")}
    p["conv_last"] = {"w": t(f"{prefix}.conv2d_last.weight")[:, :, 0, 0], "b": t(f"{prefix}.conv2d_last.bias")}
    return p


@pytest.mark.parametrize("use_pallas", [False, True])
def test_wcompute_golden(g, use_pallas):
    w = tgnn.apply_wcompute(_wcompute_tree(g, "wcompute"), torch.from_numpy(g["wcompute.x"]), use_pallas)
    np.testing.assert_allclose(w.numpy(), g["wcompute.W"], rtol=1e-4, atol=1e-5)


def test_gconv_golden(g):
    t = lambda k: torch.from_numpy(g[k])
    p = {"fc": {"w": t("gconv.fc.weight"), "b": t("gconv.fc.bias")},
         "bn": {"scale": t("gconv.bn.weight"), "bias": t("gconv.bn.bias")}}
    y = tgnn.apply_gconv(p, t("gconv.w_ops"), t("gconv.x"))
    np.testing.assert_allclose(y.numpy(), g["gconv.y"], rtol=1e-4, atol=1e-5)
