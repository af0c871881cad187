"""The port's fused inner scan (mft_tpu_torch/kernels/fused_inner_scan.py)
against the JAX module it ports (mft_tpu/ops/pallas/fused_inner_scan.py).

On the CPU the port runs its plain PyTorch version; the Pallas kernel runs
in interpret mode, as tests/test_fused_inner_scan.py runs it.  Inputs come
from numpy seeds and go to both sides.  Small geometry (the JAX tests'):
``BlockGeom(8, 16, 32, 2, 4)``, bank span 10, T = 9 steps (3 epochs).

Tolerances, each with its reason:

* one step's loss and gradients: rtol 1e-5 (loss), rtol 2e-4 / atol 2e-5
  (gradients) -- the same f32 math with other summation orders (the JAX
  tests' own bounds against autodiff);
* one Adam step / a one-step scan: rtol 1e-4 / atol 1e-5 (f32 carry);
* several steps: per-tensor relative L2 under 1e-2.  Adam divides by
  sqrt(v), so a near-zero gradient whose sign differs between two summation
  orders moves its weight by +-lr: elementwise bounds mean nothing after a
  few steps, the trajectories have to stay normwise together.  The same
  bound holds the fused scan against the eager loop (``inner_fit``) with an
  f32 carry; under a bf16 carry the two also round at different places (the
  eager optimizer rounds the update, the fused scan rounds the updated
  parameter) and the bound is 5e-2, explained at the test.
"""

import functools
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
from mft_tpu.ops.pallas import fused_inner_scan as jfis
from mft_tpu.train import eval_engine as jee
from mft_tpu.train import inner_loop as jil
from mft_tpu_torch import convert
from mft_tpu_torch.core import episode as tep
from mft_tpu_torch.kernels import fused_inner_scan as tfis
from mft_tpu_torch.methods import gnnnet as tgn
from mft_tpu_torch.methods.baseline import ce_loss
from mft_tpu_torch.models import backbone as tbb
from mft_tpu_torch.ops import augment as taug
from mft_tpu_torch.train import eval_engine as tee
from mft_tpu_torch.train import inner_loop as til
from mft_tpu_torch.train import optimizers as topt

GEOM = (8, 16, 32, 2, 4)
JGEOM, TGEOM = jfis.BlockGeom(*GEOM), tfis.BlockGeom(*GEOM)
SPAN, EPOCHS, T = 10, 3, 9
LR = 0.01
#: several Adam steps: relative L2 per tensor (see the module docstring)
DRIFT = 1e-2


@functools.lru_cache(maxsize=None)
def _setup():
    """Numpy inputs in the JAX layout: flat params, NHWC bank, labels, schedule."""
    rs = np.random.RandomState(0)
    _, ci, co, _, _ = GEOM
    conv = lambda k, c: (rs.randn(k * k * c, co) * np.sqrt(2.0 / (k * k * c))).astype(np.float32)
    vec = lambda m: (m + 0.1 * rs.randn(1, co)).astype(np.float32)
    flat = {"conv1": conv(3, ci), "bn1_s": vec(1.0), "bn1_b": vec(0.0), "conv2": conv(3, co), "bn2_s": vec(1.0),
            "bn2_b": vec(0.0), "conv_sc": conv(1, ci), "bnsc_s": vec(1.0), "bnsc_b": vec(0.0)}
    fmap = rs.randn(SPAN, GEOM[0], GEOM[0], ci).astype(np.float32)
    bank_y = (np.arange(SPAN) % 3).astype(np.int32)
    perms = np.stack([rs.permutation(SPAN) for _ in range(EPOCHS)])
    idx, w = til.schedule_from_perms(perms, til.InnerLoopCfg(EPOCHS, GEOM[4], SPAN))
    return flat, fmap, bank_y, idx.numpy().astype(np.int32), w.numpy()


def _torch_inputs(carry=torch.float32, cd=torch.float32):
    flat, fmap, bank_y, idx, w = _setup()
    return (convert.flat_from_jax(flat, dtype=carry), torch.from_numpy(fmap).to(cd), torch.from_numpy(bank_y),
            torch.from_numpy(idx), torch.from_numpy(w))


def _jax_step_grads(flat, fmap, bank_y, idx_t, w_t):
    onehot = jax.nn.one_hot(bank_y[idx_t], JGEOM.c_out, dtype=jnp.float32)
    wbc = jnp.broadcast_to(jnp.asarray(w_t)[:, None], (JGEOM.batch, JGEOM.c_out))
    xp = jnp.pad(jnp.asarray(fmap)[idx_t], ((0, 0), (1, 1), (1, 1), (0, 0)))
    return jax.jit(functools.partial(jfis._step_grads, geom=JGEOM))({k: jnp.asarray(v) for k, v in flat.items()}, xp, onehot, wbc)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------------------
# one step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 2], ids=["full_minibatch", "ragged_minibatch"])
def test_step_grads_match_jax(t):
    flat, fmap, bank_y, idx, w = _setup()
    assert (w[2] == 0).any() and (w[1] == 1).all()  # step 2 is the epoch's short last minibatch
    want, want_loss = _jax_step_grads(flat, fmap, bank_y, idx[t], w[t])
    p, bank, y, ti, tw = _torch_inputs()
    got, loss = tfis.step_grads_reference(p, bank[ti[t].long()], y[ti[t].long()], tw[t], TGEOM)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for k in tfis.PKEYS:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=2e-4, atol=2e-5, err_msg=k)


def test_fused_step_grads_on_cpu_is_the_plain_version():
    p, bank, y, ti, tw = _torch_inputs()
    want, want_loss = tfis.step_grads_reference(p, bank[ti[1].long()], y[ti[1].long()], tw[1], TGEOM)
    before = tfis.LAUNCHES
    got, loss = tfis.fused_step_grads(p, bank, y, ti[1], tw[1], geom=TGEOM)
    assert tfis.LAUNCHES == before  # no kernel launch on CPU tensors
    assert float(loss) == float(want_loss)
    for k in tfis.PKEYS:
        assert torch.equal(got[k], want[k])


def test_step_grads_respect_mask():
    """A masked row contributes nothing: the gradients with (row present,
    w = 0) equal those with the row replaced by garbage, and equal JAX's."""
    flat, fmap, bank_y, _, _ = _setup()
    p, bank, y, _, _ = _torch_inputs()
    idx_t = torch.tensor([0, 1, 2, 3])
    w_t = torch.tensor([1.0, 1.0, 0.0, 1.0])
    x = bank[idx_t]
    g1, l1 = tfis.step_grads_reference(p, x, y[idx_t], w_t, TGEOM)
    garbled = x.clone()
    garbled[2] = x[2] * 7.0 + 3.0
    g2, l2 = tfis.step_grads_reference(p, garbled, y[idx_t], w_t, TGEOM)
    want, want_loss = _jax_step_grads(flat, fmap, bank_y, np.array([0, 1, 2, 3]), w_t.numpy())
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(float(l1), float(want_loss), rtol=1e-5)
    for k in tfis.PKEYS:
        np.testing.assert_allclose(_np(g1[k]), _np(g2[k]), rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(_np(g1[k]), np.asarray(want[k]), rtol=2e-4, atol=2e-5, err_msg=k)


def _port_block():
    """The port's block tree (OIHW) and stats of the shared parameters."""
    p, _, _, _, _ = _torch_inputs()
    block = tfis.flat_to_block(p, TGEOM)
    stats = {k: {"mean": torch.zeros(TGEOM.c_out), "var": torch.ones(TGEOM.c_out)} for k in ("bn1", "bn2", "bn_sc")}
    return block, stats


#: a two-stage config whose final block is the GEOM block (stride 2, 16 -> 32)
TBCFG = tbb.ResNetCfg((1, 1), (16, 32))


def _port_loss_fn(stats, bank_nchw, y):
    def loss_fn(block, idx_t, w_t):
        feats = tbb.apply_final_block(block, stats, bank_nchw[idx_t], cfg=TBCFG, train=True, sample_mask=w_t)
        return ce_loss(feats, y[idx_t], w_t)

    return loss_fn


@pytest.mark.parametrize("t", [1, 2], ids=["full_minibatch", "ragged_minibatch"])
def test_step_grads_match_port_autodiff(t):
    """The hand-derived backward against torch.autograd through the port's
    own ``apply_final_block`` + ``ce_loss`` (the eager inner loop's loss)."""
    p, bank, y, ti, tw = _torch_inputs()
    block, stats = _port_block()
    leaves = {k: (v.requires_grad_(True) if not isinstance(v, dict) else {n: u.requires_grad_(True) for n, u in v.items()})
              for k, v in block.items()}
    loss = _port_loss_fn(stats, bank.permute(0, 3, 1, 2), y.long())(leaves, ti[t].long(), tw[t])
    loss.backward()
    auto = tfis.block_to_flat({k: (v.grad if not isinstance(v, dict) else {n: u.grad for n, u in v.items()})
                               for k, v in leaves.items()})
    got, got_loss = tfis.step_grads_reference(p, bank[ti[t].long()], y[ti[t].long()], tw[t], TGEOM)
    np.testing.assert_allclose(float(got_loss), float(loss.detach()), rtol=1e-5)
    for k in tfis.PKEYS:
        np.testing.assert_allclose(_np(got[k]), _np(auto[k]), rtol=2e-4, atol=2e-5, err_msg=k)


# --------------------------------------------------------------------------
# Adam
# --------------------------------------------------------------------------


@pytest.mark.parametrize("carry", ["float32", "bfloat16"])
def test_adam_update_matches_jax(carry):
    """Four updates with fixed gradients.  The moments are bf16 on both
    sides and the rounded moments feed the update: agreement to one bf16
    ulp of the moments (rtol 2**-7) and, for the parameters, rtol 1e-4 /
    atol 1e-5 in f32 or one bf16 ulp (rtol 2**-7) under a bf16 carry, where
    a last-bit difference in f32 can flip the final rounding."""
    rs = np.random.RandomState(1)
    shapes = {"a": (7, 5), "b": (1, 9)}
    jdt, tdt = getattr(jnp, carry), getattr(torch, carry)
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    jmu = {k: jnp.zeros(s, jnp.bfloat16) for k, s in shapes.items()}
    jnu = dict(jmu)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    tmu = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in shapes.items()}
    tnu = dict(tmu)
    jstep = jax.jit(functools.partial(jfis._adam_update, lr=LR))
    for t in range(1, 5):
        g = {k: (rs.randn(*s) * 10.0 ** rs.uniform(-4, 0)).astype(np.float32) for k, s in shapes.items()}
        jp, jmu, jnu = jstep(jp, jmu, jnu, {k: jnp.asarray(v) for k, v in g.items()}, jnp.asarray(t, jnp.int32))
        tp, tmu, tnu = tfis.adam_update_reference(tp, tmu, tnu, {k: torch.from_numpy(v) for k, v in g.items()}, t, LR)
        for k in shapes:
            assert tp[k].dtype == tdt and tmu[k].dtype == tnu[k].dtype == torch.bfloat16
            np.testing.assert_allclose(_np(tmu[k]), np.asarray(jmu[k], np.float32), rtol=2.0**-7, err_msg=f"mu {k} t={t}")
            np.testing.assert_allclose(_np(tnu[k]), np.asarray(jnu[k], np.float32), rtol=2.0**-7, err_msg=f"nu {k} t={t}")
            tol = dict(rtol=1e-4, atol=1e-5) if carry == "float32" else dict(rtol=2.0**-7, atol=1e-5)
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k], np.float32), err_msg=f"p {k} t={t}", **tol)


def test_adam_reads_the_rounded_moment():
    """With g = 1 + 2**-9 the f32 moment is not a bf16 value: the update
    must use the bf16-rounded one, as the JAX kernel does."""
    g = {"a": torch.full((3,), 1.0 + 2.0**-9)}
    p = {"a": torch.zeros(3)}
    z = {"a": torch.zeros(3, dtype=torch.bfloat16)}
    new_p, mu, nu = tfis.adam_update_reference(p, z, dict(z), g, 1, LR)
    bc1, bc2 = tfis.bias_corrections(1)
    want = -LR * (mu["a"].float() / bc1) / (torch.sqrt(nu["a"].float() / bc2) + 1e-8)
    unrounded = -LR * ((0.1 * g["a"]) / bc1) / (torch.sqrt(0.001 * g["a"].square() / bc2) + 1e-8)
    assert torch.equal(new_p["a"], want) and not torch.equal(want, unrounded)


# --------------------------------------------------------------------------
# the scan
# --------------------------------------------------------------------------


def _jax_scan_inputs(carry="float32"):
    flat, fmap, bank_y, idx, w = _setup()
    jflat = {k: jnp.asarray(v, getattr(jnp, carry)) for k, v in flat.items()}
    return jflat, jnp.asarray(fmap), jnp.asarray(bank_y), jnp.asarray(idx), jnp.asarray(w)


@pytest.mark.parametrize("side", ["xla", "pallas_interpret"])
def test_one_step_scan_matches_jax(side):
    jflat, jfmap, jy, jidx, jw = _jax_scan_inputs()
    if side == "xla":
        want = jfis.fused_inner_scan_xla(jflat, jfmap, jy, jidx[:1], jw[:1], geom=JGEOM, lr=LR)
    else:
        want = jfis.fused_inner_scan(jflat, jfmap, jy, jidx[:1], jw[:1], geom=JGEOM, lr=LR, interpret=True)
    p, bank, y, ti, tw = _torch_inputs()
    got = tfis.fused_inner_scan(p, bank, y, ti[:1], tw[:1], geom=TGEOM, lr=LR)
    for k in tfis.PKEYS:
        # the first Adam step moves every weight by lr*g/|g|: where a gradient
        # is rounding noise (a few 1e-8) its sign may differ between the two
        # summation orders, so up to 1 % of the elements may sit up to 2*lr
        # apart (measured: 0.23 % of conv2); the rest is held tight
        diff = np.abs(_np(got[k]) - np.asarray(want[k]))
        tight = diff <= 1e-5 + 1e-4 * np.abs(np.asarray(want[k]))
        assert tight.mean() >= 0.99, f"{k}: {1 - tight.mean():.4f} of the elements differ"
        assert diff.max() <= 2 * LR + 1e-5, k
        assert _rel_l2(_np(got[k]), np.asarray(want[k])) < DRIFT, k


@pytest.mark.parametrize("carry", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["xla", "pallas_interpret"])
def test_scan_matches_jax(side, carry):
    jflat, jfmap, jy, jidx, jw = _jax_scan_inputs(carry)
    if side == "xla":
        want = jfis.fused_inner_scan_xla(jflat, jfmap, jy, jidx, jw, geom=JGEOM, lr=LR)
    else:
        want = jfis.fused_inner_scan(jflat, jfmap, jy, jidx, jw, geom=JGEOM, lr=LR, interpret=True)
    p, bank, y, ti, tw = _torch_inputs(getattr(torch, carry))
    got = tfis.fused_inner_scan(p, bank, y, ti, tw, geom=TGEOM, lr=LR)
    for k in tfis.PKEYS:
        assert got[k].dtype == getattr(torch, carry) and tuple(got[k].shape) == want[k].shape
        assert _rel_l2(_np(got[k]), np.asarray(want[k], np.float32)) < DRIFT, k
    # and the scan did move the weights: it is not compared at its start
    assert _rel_l2(_np(got["conv2"]), _np(p["conv2"])) > 10 * DRIFT


def test_scan_lanes_match_pallas_lanes_grid():
    """Two lanes, each with its own bank and schedule (the JAX test's
    case): lane by lane against the Pallas grid in interpret mode."""
    jflat, jfmap, jy, jidx, jw = _jax_scan_inputs()
    want = jfis.fused_inner_scan_lanes(
        jax.tree.map(lambda a: jnp.stack([a, a]), jflat), jnp.stack([jfmap, jfmap * 0.5]), jy,
        jnp.stack([jidx, jnp.flip(jidx, axis=0)]), jw, geom=JGEOM, lr=LR, interpret=True)
    p, bank, y, ti, tw = _torch_inputs()
    got = tfis.fused_inner_scan_lanes({k: torch.stack([v, v]) for k, v in p.items()}, torch.stack([bank, bank * 0.5]), y,
                                      torch.stack([ti, torch.flip(ti, dims=(0,))]), tw, geom=TGEOM, lr=LR)
    single = tfis.fused_inner_scan(p, bank, y, ti, tw, geom=TGEOM, lr=LR)
    for k in tfis.PKEYS:
        assert tuple(got[k].shape) == (2,) + tuple(p[k].shape)
        assert torch.equal(got[k][0], single[k])  # lane 0 is the single-lane scan
        for lane in range(2):
            assert _rel_l2(_np(got[k][lane]), np.asarray(want[k][lane])) < DRIFT, (k, lane)
    assert not torch.equal(got["conv1"][0], got["conv1"][1])


@pytest.mark.parametrize("carry,bound", [("float32", DRIFT), ("bfloat16", 5e-2)])
def test_scan_matches_port_inner_fit(carry, bound):
    """Against the port's eager loop (autodiff + ``torch_adam_lowmem``) on
    the same schedule: relative L2 under DRIFT with an f32 carry.  Under a
    bf16 carry the two round at different places: the eager optimizer
    rounds the update to bf16 and the loop rounds the bf16 sum again, the
    fused scan adds in f32 and rounds the updated parameter once.  Each
    step so leaves up to a bf16 ulp (2**-8 relative) between them on every
    weight, and nine steps of lr-sized moves on weights of a few lr add up:
    the bound is 5e-2 (measured: 1.7e-2 on conv1, below 5e-3 elsewhere)."""
    dt = getattr(torch, carry)
    p, bank, y, ti, tw = _torch_inputs(dt)
    block, stats = _port_block()
    block = jax.tree.map(lambda v: v.to(dt), block)
    icfg = til.InnerLoopCfg(EPOCHS, TGEOM.batch, SPAN)
    want = tfis.block_to_flat(til.inner_fit(_port_loss_fn(stats, bank.permute(0, 3, 1, 2), y.long()), block,
                                            topt.torch_adam_lowmem(LR), None, icfg, schedule=(ti.long(), tw)))
    got = tfis.fused_inner_scan(p, bank, y, ti, tw, geom=TGEOM, lr=LR)
    for k in tfis.PKEYS:
        assert _rel_l2(_np(got[k]), _np(want[k])) < bound, k


# --------------------------------------------------------------------------
# layout adapters and the wrapper's refusals
# --------------------------------------------------------------------------


def test_block_flat_round_trip_and_jax_adapters():
    jp, _ = jax.jit(lambda k: jbb.init_backbone(k, jbb.resnet10()))(jax.random.PRNGKey(3))
    _, jblock = jbb.adapt_split(jp)
    jflat = {k: np.asarray(v) for k, v in jfis.block_to_flat(jblock).items()}
    tparams, _ = convert.from_jax(jax.tree.map(np.asarray, jp))
    _, tblock = tbb.adapt_split(tparams)
    tflat = tfis.block_to_flat(tblock)
    geom = tfis.BlockGeom()  # the production geometry: 14, 256, 512, 2, 5
    assert {k: tuple(v.shape) for k, v in tflat.items()} == tfis.param_shapes(geom)
    for k in tfis.PKEYS:  # OIHW -> matrix form equals JAX's HWIO reshape
        np.testing.assert_array_equal(tflat[k].numpy(), jflat[k], err_msg=k)
    back = tfis.flat_to_block(tflat, geom)
    for k in ("conv1", "conv2", "conv_sc"):
        assert torch.equal(back[k], tblock[k]) and back[k].is_contiguous()
    for k in ("bn1", "bn2", "bn_sc"):
        assert torch.equal(back[k]["scale"], tblock[k]["scale"]) and torch.equal(back[k]["bias"], tblock[k]["bias"])
    # through convert: the JAX flat dict maps onto the port's and back
    via = convert.flat_from_jax(jflat)
    rt = convert.flat_to_jax(via)
    jback = jfis.flat_to_block({k: jnp.asarray(v) for k, v in rt.items()}, jfis.BlockGeom())
    for k in tfis.PKEYS:
        assert torch.equal(via[k], tflat[k])
        np.testing.assert_array_equal(rt[k], jflat[k])
    np.testing.assert_array_equal(np.asarray(jback["conv2"]), np.asarray(jblock["conv2"]))
    assert convert.flat_from_jax(jflat, dtype=torch.bfloat16)["conv1"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        convert.flat_from_jax({"conv1": jflat["conv1"]})


def test_bank_to_nhwc():
    x = torch.arange(2 * 3 * 4 * 4, dtype=torch.float32).reshape(2, 3, 4, 4)
    out = tfis.bank_to_nhwc(x)
    assert out.shape == (2, 4, 4, 3) and out.is_contiguous() and torch.equal(out[1, 2, 3], x[1, :, 2, 3])


def test_wrapper_refusals():
    p, bank, y, ti, tw = _torch_inputs()
    # the kernels store bf16 moments and nothing else: the wrappers take no
    # such option (the eval refuses opt_state_dtype='float32', see
    # test_fused_refusals_and_the_linear_member), as the JAX functions take none
    with pytest.raises(TypeError, match="opt_state_dtype"):
        tfis.fused_inner_scan(p, bank, y, ti, tw, geom=TGEOM, lr=LR, opt_state_dtype="float32")
    # the launch path takes CUDA tensors only and never falls back (the
    # geometry is refused by the built library, which only the card has)
    with pytest.raises(ValueError, match="CUDA"):
        tfis._check_inputs(p, bank, y, ti, tw, TGEOM, None)
    with pytest.raises(ValueError, match="CUDA"):
        tfis._check_inputs({k: v[None] for k, v in p.items()}, bank[None], y, ti[None], tw, TGEOM, 1)


# --------------------------------------------------------------------------
# the slice: the eval with inner_scan='fused'
# --------------------------------------------------------------------------

SPEC = (3, 2, 2)  # n_way, n_support, n_query
SIZE = 64


@pytest.fixture(scope="module")
def episode():
    rs = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    bp, bs = tbb.init_backbone(gen, tbb.resnet10())
    gp, gs = tbb.init_backbone(gen, tbb.resnet10())
    head = tgn.init_head(gen, tgn.GnnNetCfg(feat_dim=512, n_way=3, n_support=2))
    base = rs.randint(0, 256, (3, 4, int(SIZE * 1.15), int(SIZE * 1.15), 3)).astype(np.uint8)
    support_size = SPEC[0] * SPEC[1]
    perms = np.stack([rs.permutation(3 * support_size) for _ in range(2)])
    return dict(bp=bp, bs=bs, gp=gp, gs=gs, head=head, base=base, perms=perms)


def _port_gnn_scores(e, inner_scan, **tkw):
    spec = tep.EpisodeSpec(*SPEC)
    tcfg = tee.TransferCfg(fine_tune_epochs=2, linear_epochs=2, inner_scan=inner_scan, **tkw)
    base = torch.from_numpy(e["base"]).permute(0, 1, 4, 2, 3)
    sched = til.schedule_from_perms(e["perms"], til.InnerLoopCfg(2, 5, 3 * spec.support_size))
    return tee.gnn_member_scores(
        e["gp"], e["gs"], e["head"], taug.center_batch(base, SIZE), base[:, : spec.n_support], None, bcfg=tbb.resnet10(),
        gcfg=tgn.GnnNetCfg(feat_dim=512, n_way=3, n_support=2, use_pallas=True), spec=spec, tcfg=tcfg,
        aug_cfg=taug.AugmentCfg(image_size=SIZE), gen_examples=0, inner_schedule=sched).numpy()


def test_gnn_member_fused_matches_eager_and_jax(episode):
    """The GNN member at 64 px, f32, bf16 Adam moments, the same explicit
    schedule (8 steps): the fused scan against the port's eager loop and
    against the JAX eval (autodiff scan).  The adapted weights agree
    normwise (DRIFT), not elementwise, so the softmax scores are held to
    atol 2e-2 with the same argmax (measured: about 3e-3)."""
    eager = _port_gnn_scores(episode, "eager")
    with mock.patch.object(tfis, "fused_inner_scan_lanes", wraps=tfis.fused_inner_scan_lanes) as spy:
        fused = _port_gnn_scores(episode, "fused")
    assert spy.call_count == 1
    geom = spy.call_args.kwargs["geom"]
    assert geom == tfis.BlockGeom(SIZE // 16, 256, 512, 2, 5) and spy.call_args.args[3].shape == (1, 8, 5)
    assert fused.shape == (6, 3) and np.isfinite(fused).all()
    np.testing.assert_allclose(fused, eager, atol=2e-2)
    np.testing.assert_array_equal(fused.argmax(1), eager.argmax(1))
    print(f"fused vs eager: max |d score| = {np.abs(fused - eager).max():.3e}")

    jspec = jep.EpisodeSpec(*SPEC)
    gp, gs = convert.to_jax(episode["gp"], episode["gs"])
    head, _ = convert.to_jax(episode["head"])
    jtcfg = jee.TransferCfg(fine_tune_epochs=2, linear_epochs=2, opt_state_dtype="bfloat16")

    def run(gp, gs, head, base):
        k = jax.random.PRNGKey(1)
        return jee.gnn_member_scores(
            gp, gs, head, jaug.center_batch(base, SIZE), base[:, : jspec.n_support], k, k, bcfg=jbb.resnet10(),
            gcfg=jgn.GnnNetCfg(feat_dim=512, n_way=3, n_support=2, use_pallas=True), spec=jspec, tcfg=jtcfg,
            aug_cfg=jaug.AugmentCfg(image_size=SIZE), gen_examples=0,
            inner_schedule=jil.schedule_from_perms(episode["perms"], jil.InnerLoopCfg(2, 5, 3 * jspec.support_size)))

    plain_edge = lambda x, w, b, interpret=False: jem.edge_abs_diff_matmul_reference(x, w, b)
    with mock.patch.object(jem, "edge_abs_diff_matmul", plain_edge):
        want = np.asarray(jax.jit(run)(gp, gs, head, episode["base"]))
    np.testing.assert_allclose(fused, want, atol=2e-2)
    np.testing.assert_array_equal(fused.argmax(1), want.argmax(1))
    print(f"fused vs JAX: max |d score| = {np.abs(fused - want).max():.3e}")


def test_eval_program_method_all_fused_matches_eager(episode):
    """``make_eval_program(method='all')`` with the same generator seed:
    the linear member is identical (it stays eager, and the fused path
    consumes the generator as the eager one does), the ensemble agrees as
    the GNN member does."""
    spec = tep.EpisodeSpec(*SPEC)
    base = torch.from_numpy(episode["base"]).permute(0, 1, 4, 2, 3)
    models = {"baseline": (episode["bp"], episode["bs"]), "gnn": (episode["gp"], episode["gs"], episode["head"])}
    out, after = {}, {}
    for mode in ("eager", "fused"):
        tcfg = tee.TransferCfg(fine_tune_epochs=1, linear_epochs=1, inner_scan=mode)
        program = tee.make_eval_program(method="all", bcfg=tbb.resnet10(), spec=spec, tcfg=tcfg, gen_examples=1,
                                        gcfg=tgn.GnnNetCfg(feat_dim=512, n_way=3, n_support=2, use_pallas=True),
                                        aug_cfg=taug.AugmentCfg(image_size=SIZE))
        gen = torch.Generator().manual_seed(5)
        scores, accs = program(models, base[None], [gen])
        out[mode], after[mode] = scores[0].numpy(), torch.rand(1, generator=gen).item()
        assert 0.0 <= accs[0] <= 100.0
    assert after["eager"] == after["fused"]  # the same draws were consumed
    np.testing.assert_allclose(out["fused"], out["eager"], atol=2e-2)
    np.testing.assert_array_equal(out["fused"].argmax(1), out["eager"].argmax(1))


def test_fused_refusals_and_the_linear_member(episode):
    with pytest.raises(ValueError, match="opt_state_dtype"):
        _port_gnn_scores(episode, "fused", opt_state_dtype="float32")
    with pytest.raises(ValueError, match="inner_scan"):
        _port_gnn_scores(episode, "scan")
    # a member with a head stays on the eager loop: identical scores, no scan call
    spec = tep.EpisodeSpec(*SPEC)
    base = torch.from_numpy(episode["base"]).permute(0, 1, 4, 2, 3)
    scores = {}
    with mock.patch.object(tfis, "fused_inner_scan_lanes", side_effect=AssertionError("the linear member must stay eager")):
        for mode in ("eager", "fused"):
            tcfg = tee.TransferCfg(fine_tune_epochs=1, linear_epochs=1, inner_scan=mode)
            scores[mode] = tee.linear_member_scores(
                episode["bp"], episode["bs"], taug.center_batch(base, SIZE), base[:, : spec.n_support],
                torch.Generator().manual_seed(2), bcfg=tbb.resnet10(), spec=spec, tcfg=tcfg,
                aug_cfg=taug.AugmentCfg(image_size=SIZE))
    assert torch.equal(scores["eager"], scores["fused"])
    # a final block without the 1x1 shortcut conv is not the block the kernels take
    block = {k: v for k, v in tbb.adapt_split(episode["gp"])[1].items() if k not in ("conv_sc", "bn_sc")}
    with pytest.raises(ValueError, match="SimpleBlock"):
        tee._adapt_block_fused(block, None, torch.zeros(6, 256, 4, 4), None, bcfg=tbb.resnet10(),
                               tcfg=tee.TransferCfg(inner_scan="fused"), icfg=til.InnerLoopCfg(1, 5, 6))


def test_cli_inner_scan_flag(tmp_path, capsys):
    """``--inner_scan fused`` through ``cli.finetune.main`` on the CPU, with the
    CLI's bf16 defaults, on seeded random checkpoints."""
    import chip_smoke
    from mft_tpu_torch import config as tcfg_mod
    from mft_tpu_torch.cli import finetune

    assert tcfg_mod.parse_finetune_args([]).inner_scan == "eager"
    with pytest.raises(SystemExit):
        tcfg_mod.parse_finetune_args(["--inner_scan", "pallas"])
    pj = chip_smoke.write_checkpoints(torch, str(tmp_path))
    argv = ["--device", "cpu", "--method", "all", "--use_pallas", "--test_dataset", "synthetic", "--image_size", "32",
            "--n_shot", "5", "--n_query", "3", "--gen_examples", "1", "--fine_tune_epoch", "1", "--iter_num", "2",
            "--eval_batch", "1", "--paths_json", pj]
    with mock.patch.object(tfis, "fused_inner_scan_lanes", wraps=tfis.fused_inner_scan_lanes) as spy:
        res = finetune.main(argv + ["--inner_scan", "fused"])
    assert spy.call_count == 2  # one scan per episode (one-episode batches)
    p0, bank = spy.call_args.args[0], spy.call_args.args[1]
    assert p0["conv1"].dtype == torch.bfloat16 and bank.dtype == torch.bfloat16 and bank.shape == (1, 100, 2, 2, 256)
    assert "2 Test Acc = " in capsys.readouterr().out
    assert len(res.accs) == 2 and all(np.isfinite(res.accs)) and all(0.0 <= a <= 100.0 for a in res.accs)


# --------------------------------------------------------------------------
# the seven products of a step, one by one
# --------------------------------------------------------------------------

#: small geometries for the per-product tests: a stride-2 and a stride-1 block
PRODUCT_GEOMS = {"stride2": (6, 16, 32, 2, 3), "stride1": (4, 16, 32, 1, 3)}
#: a product of f32 sums against the same convolution in f64, as a share of
#: the output's largest value: the f32 summation error of at most 9*32 terms
PRODUCT_F64_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _product_inputs(geom_id, cd_name):
    """One plain step at a small geometry: (geom, p, x, labels, w, products, grads)."""
    geom = tfis.BlockGeom(*PRODUCT_GEOMS[geom_id])
    rs = np.random.RandomState(7)
    shapes = tfis.param_shapes(geom)
    p = {k: torch.from_numpy((rs.randn(*s) * (np.sqrt(2.0 / s[0]) if k.startswith("conv") else 0.1)
                              + (1.0 if k.endswith("_s") else 0.0)).astype(np.float32)) for k, s in shapes.items()}
    cd = getattr(torch, cd_name)
    x = torch.from_numpy(rs.randn(geom.batch, geom.h_in, geom.h_in, geom.c_in).astype(np.float32)).to(cd)
    labels = torch.from_numpy(rs.randint(0, 3, geom.batch))
    w = torch.tensor([1.0] * (geom.batch - 1) + [0.0])
    prods = tfis.step_products_reference(p, x, labels, w, geom)
    grads, _ = tfis.step_grads_reference(p, x, labels, w, geom)
    return geom, p, x, labels, w, prods, grads


def _conv_f64(which, prod, geom):
    """The product by ``torch.nn.functional.conv2d`` (and its autograd) in
    f64 on the same operands, independent of the im2col form."""
    first = which.startswith(("conv1", "conv_sc"))
    k, pad = (1, 0) if which.startswith("conv_sc") else (3, 1)
    cin, stride, hin = (geom.c_in, geom.stride, geom.h_in) if first else (geom.c_out, 1, geom.h_out)
    co, b = geom.c_out, geom.batch
    oihw = lambda m: m.double().reshape(k, k, cin, co).permute(3, 2, 0, 1)
    rows = lambda t: t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])  # NCHW -> [rows, C]
    w4 = (oihw(prod["w"]) if prod["w"] is not None else torch.zeros(co, cin, k, k, dtype=torch.float64)).requires_grad_()
    x4 = (prod["x"].double().permute(0, 3, 1, 2) if prod["x"] is not None
          else torch.zeros(b, cin, hin, hin, dtype=torch.float64)).requires_grad_()
    y = torch.nn.functional.conv2d(x4, w4, stride=stride, padding=pad)
    if prod["dy"] is None:
        return rows(y).detach()
    dy4 = prod["dy"].double().reshape(b, geom.h_out, geom.h_out, co).permute(0, 3, 1, 2)
    gx, gw = torch.autograd.grad(y, (x4, w4), dy4)
    return rows(gx) if which == "conv2_dx" else gw.permute(2, 3, 1, 0).reshape(k * k * cin, co)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom_id", list(PRODUCT_GEOMS))
def test_step_products_recombine_to_step_grads(geom_id, cd):
    """The three weight-gradient products ARE the step's conv gradients, bit
    for bit, and every product has the shapes ``product_shapes`` names."""
    geom, _, _, _, _, prods, grads = _product_inputs(geom_id, cd)
    assert set(prods) == set(tfis.PRODUCTS)
    for key, which in (("conv1", "conv1_dw"), ("conv2", "conv2_dw"), ("conv_sc", "conv_sc_dw")):
        assert torch.equal(prods[which]["out"], grads[key]), which
    for which, prod in prods.items():
        shapes = tfis.product_shapes(which, geom)
        assert prod["out"].dtype == torch.float32 and tuple(prod["out"].shape) == shapes["out"]
        for k in ("w", "x", "dy"):
            assert (prod[k] is None) == (shapes[k] is None), (which, k)
            assert prod[k] is None or (tuple(prod[k].shape) == shapes[k] and prod[k].dtype == getattr(torch, cd))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", tfis.PRODUCTS)
def test_products_match_f64_conv(which, cd):
    for geom_id in PRODUCT_GEOMS:
        geom, _, _, _, _, prods, _ = _product_inputs(geom_id, cd)
        want = _conv_f64(which, prods[which], geom)
        err = float((prods[which]["out"].double() - want).abs().max() / want.abs().max())
        assert err <= PRODUCT_F64_TOL, (which, geom_id, err)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", tfis.PRODUCTS)
def test_fused_product_on_cpu_is_the_plain_product(which, cd):
    geom, _, _, _, _, prods, _ = _product_inputs("stride2", cd)
    prod = prods[which]
    before = tfis.LAUNCHES
    got = tfis.fused_product(which, prod["w"], prod["x"], prod["dy"], geom)
    fma = tfis.fused_product(which, prod["w"], prod["x"], prod["dy"], geom, route="fma")
    assert tfis.LAUNCHES == before
    assert got.dtype == torch.float32 and torch.equal(got, prod["out"]) and torch.equal(fma, prod["out"])


@pytest.mark.parametrize("key,which", [("conv1", "conv1_dw"), ("conv2", "conv2_dw"), ("conv_sc", "conv_sc_dw")])
def test_weight_gradient_products_match_jax(key, which):
    """The weight-gradient products of the plain step against JAX's
    ``_step_grads``, at the one-step tolerance of the module docstring."""
    flat, fmap, bank_y, idx, w = _setup()
    want, _ = _jax_step_grads(flat, fmap, bank_y, idx[2], w[2])
    p, bank, y, ti, tw = _torch_inputs()
    prods = tfis.step_products_reference(p, bank[ti[2].long()], y[ti[2].long()], tw[2], TGEOM)
    np.testing.assert_allclose(_np(prods[which]["out"]), np.asarray(want[key]), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("geom_id", list(PRODUCT_GEOMS))
def test_centre_tap_is_the_shortcut_pixel(geom_id):
    """Tap (1, 1) of the 3x3 pad-1 stride-s window is pixel (s*oy, s*ox): the
    rows the 1x1 stride-s shortcut reads, which is why one launch can hold
    conv1 and the shortcut."""
    geom, _, x, _, _, _, _ = _product_inputs(geom_id, "float32")
    span = geom.stride * geom.h_out
    xs = x[:, 0:span : geom.stride, 0:span : geom.stride, :].reshape(geom.rows, geom.c_in)
    assert torch.equal(tfis._patches3x3(tfis._pad_hw(x), geom.stride)[4], xs)


@pytest.mark.parametrize("beta", [0.9, 0.999])
def test_bias_corrections_follow_the_kernels_f32_formula(beta):
    """``1 - exp(t*log(b))`` in f32 steps, as the C loop computes it for the
    Adam kernel, for every step of a 500-step scan: equal to the same
    expression written out in numpy f32, and within a few f32 ulps of
    ``1 - b**t`` in f64."""
    log_b = np.float32(np.log(beta))
    for t in range(1, 501):
        got = tfis.bias_corrections(t)[0 if beta == 0.9 else 1]
        mine = np.float32(1.0) - np.exp(np.float32(t) * log_b, dtype=np.float32)
        assert got == float(mine)
        np.testing.assert_allclose(got, 1.0 - beta**t, rtol=2e-4 if t < 5 and beta == 0.999 else 3e-5)


def test_fused_product_refusals():
    geom, _, _, _, _, prods, _ = _product_inputs("stride2", "float32")
    prod = prods["conv2_dw"]
    with pytest.raises(ValueError, match="which"):
        tfis.fused_product("conv3", None, prod["x"], prod["dy"], geom)
    with pytest.raises(ValueError, match="operand"):
        tfis.fused_product("conv2_dw", prods["conv2"]["w"], prod["x"], prod["dy"], geom)  # a weight gradient takes no w
    with pytest.raises(ValueError, match="operand"):
        tfis.fused_product("conv2_dw", None, prod["x"][:, :1], prod["dy"], geom)
    with pytest.raises(TypeError, match="dtype"):
        tfis.fused_product("conv2_dw", None, prod["x"].bfloat16(), prod["dy"], geom)
    with pytest.raises(ValueError, match="route"):
        tfis.fused_product("conv2_dw", None, prod["x"], prod["dy"], geom, route="tensor_cores")
    p, bank, y, ti, tw = _torch_inputs()
    with pytest.raises(ValueError, match="route"):
        tfis.fused_step_grads(p, bank, y, ti[1], tw[1], geom=TGEOM, route="auto")
    want, _ = tfis.fused_step_grads(p, bank, y, ti[1], tw[1], geom=TGEOM)
    got, _ = tfis.fused_step_grads(p, bank, y, ti[1], tw[1], geom=TGEOM, route="fma")  # on the CPU both are the plain version
    assert all(torch.equal(got[k], want[k]) for k in tfis.PKEYS)
