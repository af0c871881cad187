"""The port's ops (mft_tpu_torch/ops, convert.py) against the JAX package's,
on the same numpy inputs.

Tolerances: f32 at rtol 1e-5 (atol 1e-5 where sums of ~100 terms meet
zero-crossings); bf16 at 2 bf16 ulps (rtol 1e-2): both sides round the same
operands to bf16 and accumulate in f32, so only the order of the f32 sums
and the final bf16 rounding differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.ops import convpool as jcp
from mft_tpu.ops import initializers as jinit
from mft_tpu.ops import norm as jnorm
from mft_tpu_torch import convert
from mft_tpu_torch.ops import convpool as tcp
from mft_tpu_torch.ops import initializers as tinit
from mft_tpu_torch.ops import norm as tnorm

RS = np.random.RandomState


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 3), (2, 0, 1), (2, 3, 7)])
def test_conv2d_f32(stride, padding, k):
    rs = RS(0)
    x = rs.randn(2, 12, 12, 8).astype(np.float32)
    w = (rs.randn(k, k, 8, 16) * 0.2).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, w: jcp.conv2d(x, w, stride, padding))(x, w))
    got = nhwc(tcp.conv2d(nchw(x), oihw(w), stride, padding))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv2d_bf16_rounds_output():
    rs = RS(1)
    x = rs.randn(2, 10, 10, 16).astype(np.float32)
    w = (rs.randn(3, 3, 16, 8) * 0.2).astype(np.float32)
    want = jax.jit(lambda x, w: jcp.conv2d(x, w, 2, 1, compute_dtype=jnp.bfloat16))(x, w)
    got = tcp.conv2d(nchw(x), oihw(w), 2, 1, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


def test_pools():
    rs = RS(2)
    x = rs.randn(3, 9, 9, 4).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jcp.max_pool(x, 3, 2, 1))(x))
    np.testing.assert_array_equal(nhwc(tcp.max_pool(nchw(x), 3, 2, 1)), want)
    want = np.asarray(jax.jit(jcp.global_avg_pool)(x))
    np.testing.assert_allclose(tcp.global_avg_pool(nchw(x)).numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_and_leaky_relu(dtype):
    rs = RS(3)
    x = rs.randn(6, 20).astype(np.float32)
    p = {"w": (rs.randn(20, 7) * 0.3).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(lambda x, p: jcp.linear(x.astype(jd), p))(x, p)
    pt, _ = convert.from_jax(p)
    got = tcp.linear(torch.from_numpy(x).to(td), pt)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(tcp.leaky_relu(torch.from_numpy(x)).numpy(), np.asarray(jcp.leaky_relu(x)), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rank", [2, 4])
def test_batch_norm_batch_stats(masked, rank):
    rs = RS(4)
    shape = (6, 5, 5, 3) if rank == 4 else (6, 3)
    x = (rs.randn(*shape) * 2 + 1).astype(np.float32)
    p = {"scale": rs.rand(3).astype(np.float32) + 0.5, "bias": rs.randn(3).astype(np.float32)}
    s = {"mean": rs.randn(3).astype(np.float32), "var": rs.rand(3).astype(np.float32) + 0.5}
    mask = np.array([1, 1, 0, 1, 1, 0], np.float32) if masked else None

    def jf(x, p, s, m):
        return jnorm.batch_norm(x, p, s, use_batch_stats=True, update_stats=True, sample_mask=m)

    y_j, s_j = jax.jit(jf)(x, p, s, mask)
    xt = nchw(x) if rank == 4 else torch.from_numpy(x)
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    y_t, s_t = tnorm.batch_norm(xt, tt(p), tt(s), use_batch_stats=True, update_stats=True,
                                sample_mask=None if mask is None else torch.from_numpy(mask))
    y_t = nhwc(y_t) if rank == 4 else y_t.numpy()
    np.testing.assert_allclose(y_t, np.asarray(y_j), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(s_j[k]), rtol=1e-5, atol=1e-6)


def test_batch_norm_running_stats_and_channels_last():
    rs = RS(5)
    x = rs.randn(2, 4, 4, 3).astype(np.float32)
    p = {"scale": rs.rand(3).astype(np.float32), "bias": rs.randn(3).astype(np.float32)}
    s = {"mean": rs.randn(3).astype(np.float32), "var": rs.rand(3).astype(np.float32) + 0.5}
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    y_j, _ = jnorm.batch_norm(x, p, s, use_batch_stats=False)
    y_t, _ = tnorm.batch_norm(nchw(x), tt(p), tt(s), use_batch_stats=False)
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), rtol=1e-5, atol=1e-6)
    # channels-last (the GNN edge tensor) normalizes over every other dim
    y_j, _ = jax.jit(lambda x, p: jnorm.batch_norm(x, p, None, use_batch_stats=True))(x, p)
    y_t, _ = tnorm.batch_norm(torch.from_numpy(x), tt(p), None, use_batch_stats=True, channel_dim=-1)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)


def test_batch_norm_bf16_stats_in_f32():
    x = (RS(6).randn(8, 4, 3, 3) * 3 + 5).astype(np.float32)
    p = {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}
    y_j, _ = jax.jit(lambda x: jnorm.batch_norm(x.astype(jnp.bfloat16), p, None, use_batch_stats=True))(
        np.transpose(x, (0, 2, 3, 1)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y_t, _ = tnorm.batch_norm(torch.from_numpy(x).to(torch.bfloat16), tp, None, use_batch_stats=True)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j, np.float32), rtol=1e-2, atol=1e-2)


def test_initializer_statistics():
    g = torch.Generator().manual_seed(0)
    w = tinit.conv_fanin_normal(g, 3, 3, 64, 128)
    assert w.shape == (128, 64, 3, 3)
    np.testing.assert_allclose(float(w.std()), np.sqrt(2.0 / (9 * 128)), rtol=0.02)
    j = np.asarray(jinit.conv_fanin_normal(jax.random.PRNGKey(0), 3, 3, 64, 128))
    np.testing.assert_allclose(float(w.std()), float(j.std()), rtol=0.03)
    lin = tinit.torch_linear(g, 100, 300)
    assert lin["w"].shape == (300, 100) and lin["b"].shape == (300,)
    assert float(lin["w"].abs().max()) <= 0.1 and float(lin["w"].abs().max()) > 0.099
    bp, bs = tinit.bn_params(5), tinit.bn_stats(5)
    for t, v in ((bp["scale"], 1), (bp["bias"], 0), (bs["mean"], 0), (bs["var"], 1)):
        assert torch.equal(t, torch.full((5,), float(v)))


def test_convert_round_trip_and_layout():
    from mft_tpu.methods import gnnnet as jgn
    from mft_tpu.models import backbone as jbb

    p, s = jbb.init_backbone(jax.random.PRNGKey(0), jbb.resnet10())
    head = jgn.init_head(jax.random.PRNGKey(1), jgn.GnnNetCfg())
    tree = jax.tree.map(np.asarray, {"feature": p, **head})
    stats = jax.tree.map(np.asarray, s)
    tp, ts = convert.from_jax(tree, stats)
    assert tuple(tp["feature"]["stem_conv"].shape) == (64, 3, 7, 7)
    assert tuple(tp["fc"]["linear"]["w"].shape) == (128, 512)
    assert tuple(tp["gnn"]["layers"][0]["w"]["conv1"]["w"].shape) == (192, 133)
    back, back_s = convert.to_jax(tp, ts)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(stats), jax.tree.leaves(back_s)):
        np.testing.assert_array_equal(a, b)
    # the reference state-dict layout round-trips through the port too
    sd = convert.to_state_dict(tp, ts)
    tp2, ts2 = convert.from_state_dict(sd, __import__("mft_tpu_torch.models.backbone", fromlist=["x"]).resnet10())
    for a, b in zip(jax.tree.leaves(convert.to_jax(tp)[0]), jax.tree.leaves(convert.to_jax(tp2)[0])):
        np.testing.assert_array_equal(a, b)
