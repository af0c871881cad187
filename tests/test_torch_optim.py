"""The port's optimizers and inner loop (mft_tpu_torch/train) against the
JAX package's, on shared gradients and an explicit shared schedule.

Tolerances: f32 trajectories at rtol 1e-5 / atol 1e-6 over 3-4 steps (few
steps on purpose: Adam's first steps move each weight by ~lr whatever the
gradient's size, so long runs amplify rounding); bf16-moment Adam at atol
1e-5 (both round the same f32 moments to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mft_tpu.train import inner_loop as jil
from mft_tpu.train import optimizers as jopt
from mft_tpu_torch.train import inner_loop as til
from mft_tpu_torch.train import optimizers as topt


def _trees(seed=0):
    rs = np.random.RandomState(seed)
    params = {"a": rs.randn(3, 4).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    grads = [{"a": (rs.randn(3, 4) * 10.0 ** -k).astype(np.float32), "b": (rs.randn(5) * 10.0 ** -k).astype(np.float32)}
             for k in range(4)]
    return params, grads


def _run_jax(tx, params, grads):
    p = jax.tree.map(jnp.asarray, params)
    s = tx.init(p)
    for g in grads:
        u, s = tx.update(jax.tree.map(jnp.asarray, g), s, p)
        p = optax.apply_updates(p, u)
    return jax.tree.map(np.asarray, p)


def _run_torch(tx, params, grads):
    t = lambda tree: {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    p = t(params)
    s = tx.init(p)
    for g in grads:
        u, s = tx.update(t(g), s, p)
        p = {k: p[k] + u[k] for k in p}
    return {k: v.numpy() for k, v in p.items()}


@pytest.mark.parametrize(
    "name,jtx,ttx,atol",
    [
        ("adam", jopt.torch_adam(0.01), topt.torch_adam(0.01), 1e-6),
        ("adam_wd", jopt.torch_adam(0.01, 0.001), topt.torch_adam(0.01, 0.001), 1e-6),
        ("adam_lowmem", jopt.torch_adam_lowmem(0.01), topt.torch_adam_lowmem(0.01), 1e-5),
        ("adam_lowmem_wd", jopt.torch_adam_lowmem(0.01, 0.001), topt.torch_adam_lowmem(0.01, 0.001), 1e-5),
        ("sgd", jopt.torch_sgd(0.1), topt.torch_sgd(0.1), 1e-6),
        ("probe_sgd", jopt.reference_probe_sgd(0.01), topt.torch_sgd(0.01, 0.9, 0.9, 0.001), 1e-6),
    ],
)
def test_optimizer_trajectories(name, jtx, ttx, atol):
    params, grads = _trees()
    want, got = _run_jax(jtx, params, grads), _run_torch(ttx, params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=atol, err_msg=f"{name}:{k}")


def test_grouped():
    params, grads = _trees(1)
    labels = {"a": "x", "b": "y"}
    jtx = jopt.grouped({"x": jopt.torch_adam(0.01), "y": jopt.torch_adam(0.01, 0.001)}, labels)
    ttx = topt.grouped({"x": topt.torch_adam(0.01), "y": topt.torch_adam(0.01, 0.001)}, labels)
    want, got = _run_jax(jtx, params, grads), _run_torch(ttx, params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bank,bs,epochs", [(25, 5, 2), (25, 4, 2), (7, 5, 3)])
def test_schedule_from_perms_matches(bank, bs, epochs):
    rs = np.random.RandomState(bank + bs)
    perms = np.stack([rs.permutation(bank) for _ in range(epochs)])
    jcfg, tcfg = jil.InnerLoopCfg(epochs, bs, bank), til.InnerLoopCfg(epochs, bs, bank)
    ji, jw = jil.schedule_from_perms(perms, jcfg)
    ti, tw = til.schedule_from_perms(perms, tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tcfg.n_steps == jcfg.n_steps


def test_minibatch_schedule_draws_permutations():
    cfg = til.InnerLoopCfg(3, 4, 10)
    idx, w = til.minibatch_schedule(torch.Generator().manual_seed(0), cfg)
    assert idx.shape == (9, 4) and w.shape == (9, 4)
    for e in range(3):
        rows, wts = idx[3 * e : 3 * e + 3].reshape(-1), w[3 * e : 3 * e + 3].reshape(-1)
        assert sorted(rows[wts > 0].tolist()) == list(range(10))
        assert rows[wts == 0].tolist() == [0, 0]  # pad rows gather row 0 at weight 0
    again, _ = til.minibatch_schedule(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(idx, again)


@pytest.mark.parametrize("adam", ["torch_adam", "torch_adam_lowmem"])
def test_inner_fit_shared_schedule(adam):
    """A masked-CE linear model trained by both engines on the same bank
    and the same explicit ragged schedule (bank 7, batch 5: each epoch's
    second minibatch has 3 pad rows)."""
    rs = np.random.RandomState(3)
    feats = rs.randn(7, 6).astype(np.float32)
    labels = rs.randint(0, 3, 7)
    p0 = {"w": (rs.randn(6, 3) * 0.3).astype(np.float32), "b": np.zeros(3, np.float32)}
    cfg = jil.InnerLoopCfg(2, 5, 7)
    perms = np.stack([rs.permutation(7) for _ in range(2)])

    from mft_tpu.methods.baseline import ce_loss as jce
    from mft_tpu_torch.methods.baseline import ce_loss as tce

    def jloss(p, idx, w):
        return jce(jnp.asarray(feats)[idx] @ p["w"] + p["b"], jnp.asarray(labels)[idx], w)

    want = jax.jit(lambda p: jil.inner_fit(jloss, p, getattr(jopt, adam)(0.01), None, cfg,
                                           schedule=jil.schedule_from_perms(perms, cfg)))(p0)
    tf, tl = torch.from_numpy(feats), torch.from_numpy(labels)

    def tloss(p, idx, w):
        return tce(tf[idx] @ p["w"] + p["b"], tl[idx], w)

    tcfg = til.InnerLoopCfg(2, 5, 7)
    start = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    got = til.inner_fit(tloss, start, getattr(topt, adam)(0.01), None, tcfg,
                        schedule=til.schedule_from_perms(perms, tcfg))
    for k in p0:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)
    assert torch.equal(start["w"], torch.from_numpy(p0["w"]))  # the input tree is left as it was
