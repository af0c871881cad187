"""Fused inner scan: the whole T-step adaptation of ResNet10's final block.

Port of the TPU kernel ``mft_tpu/ops/pallas/fused_inner_scan.py``
(``fused_inner_scan_lanes``) as hand-written CUDA kernels
(``csrc/fused_inner_scan.cu``, which documents the design and the bound):
with a bf16 bank the seven products of a step run on the tensor cores
(``wgmma``), with an f32 bank as f32 FMAs.
One call runs, per episode lane, every minibatch step of the GNN member's
eval-time fine-tune on the device: gather ``B`` rows of the frozen-trunk
feature bank, forward of the final residual block (conv1 3x3 + masked
batch-stats BN + ReLU, conv2 3x3 + BN, 1x1 shortcut + BN, add, ReLU,
global average pool), masked CE on the pooled features used as logits, the
hand-derived backward, and torch-Adam with bf16-stored moments.

Layouts at the public functions are the JAX module's: parameters are a
flat dict (:data:`PKEYS`) with conv weights in stacked-tap matrix form
``[kh*kw*ci, co]`` (HWIO flattened) and BN vectors as ``[1, C]``; the bank is
channels-last ``[span, H, H, Ci]``.  :func:`block_to_flat` /
:func:`flat_to_block` convert from and to the port's OIHW block tree and
:func:`bank_to_nhwc` converts the NCHW bank, once per episode.

* On CUDA tensors :func:`fused_inner_scan_lanes`, :func:`fused_inner_scan`
  and :func:`fused_step_grads` launch the kernels or raise; they never fall
  back.  ``LAUNCHES`` counts one per call of the scan entry point, which
  enqueues ``kernels_per_step(bank.dtype)`` device kernels a step program
  from a C loop: with a bf16 bank a step program's grids cover every lane
  of the call (``T`` programs), with an f32 bank it is one lane's (``L * T``
  programs).  :func:`fused_product` runs one of the seven products alone, by
  the route the scan takes for the operands' dtype, for checks and times.
* On CPU tensors they compute the plain version below
  (:func:`step_grads_reference`, :func:`adam_update_reference`,
  :func:`fused_inner_scan_reference`), which repeats the JAX step math line
  by line; the tests hold it against JAX and ``chip_smoke.py`` holds the
  kernels against it on the card.

Rounding places (kept from the JAX module): conv outputs, the ReLU output
fed to conv2, the pooled features and every ``dy`` entering a product round
to the compute dtype (the bank's dtype); products accumulate in f32; BN and
the loss are f32; the Adam moments round to bf16 and the *rounded* moments
feed the update; the parameter is carried in its own dtype (bf16 or f32).
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from mft_tpu_torch.utils import metrics

_BN_EPS = 1e-5  # torch default (ops/norm.py)
_ADAM_EPS = 1e-8

#: calls of the scan entry point that launched the CUDA kernels (read by chip_smoke.py)
LAUNCHES = 0
#: host seconds the last scan call spent inside the C entry point (enqueue only, no synchronise)
LAST_ENQUEUE_SECONDS = 0.0

PKEYS = ("conv1", "bn1_s", "bn1_b", "conv2", "bn2_s", "bn2_b", "conv_sc", "bnsc_s", "bnsc_b")
#: the seven products of a step, in the C entry point's numbering: the three
#: forward convs, conv2's input gradient, the three weight gradients
PRODUCTS = ("conv1", "conv_sc", "conv2", "conv2_dx", "conv1_dw", "conv2_dw", "conv_sc_dw")


class BlockGeom(NamedTuple):
    """Static geometry of the adapted block (ResNet10 stage 4: 14->7)."""

    h_in: int = 14
    c_in: int = 256
    c_out: int = 512
    stride: int = 2
    batch: int = 5

    @property
    def h_out(self) -> int:
        return self.h_in // self.stride

    @property
    def rows(self) -> int:
        return self.batch * self.h_out * self.h_out


def param_shapes(geom: BlockGeom) -> dict:
    """Shape of each flat parameter (one lane)."""
    ci, co = geom.c_in, geom.c_out
    vec = (1, co)
    return {"conv1": (9 * ci, co), "bn1_s": vec, "bn1_b": vec, "conv2": (9 * co, co), "bn2_s": vec, "bn2_b": vec,
            "conv_sc": (ci, co), "bnsc_s": vec, "bnsc_b": vec}


# --------------------------------------------------------------------------
# adapters: the port's block tree / NCHW bank <-> the kernel's layout
# --------------------------------------------------------------------------


def block_to_flat(block: dict) -> dict:
    """The port's final-block tree (OIHW conv weights, ``bn*`` dicts) ->
    flat dict: conv weights as ``[kh*kw*ci, co]`` (OIHW -> HWIO, flattened),
    BN vectors as ``[1, C]``.  Leading lane dims (``[L, O, I, kh, kw]``)
    stay leading."""
    def mat(w):
        n = w.dim() - 4
        return w.permute(*range(n), n + 2, n + 3, n + 1, n).reshape(tuple(w.shape[:n]) + (-1, w.shape[n])).contiguous()

    vec = lambda v: v.unsqueeze(-2)
    return {
        "conv1": mat(block["conv1"]),
        "bn1_s": vec(block["bn1"]["scale"]),
        "bn1_b": vec(block["bn1"]["bias"]),
        "conv2": mat(block["conv2"]),
        "bn2_s": vec(block["bn2"]["scale"]),
        "bn2_b": vec(block["bn2"]["bias"]),
        "conv_sc": mat(block["conv_sc"]),
        "bnsc_s": vec(block["bn_sc"]["scale"]),
        "bnsc_b": vec(block["bn_sc"]["bias"]),
    }


def flat_to_block(flat: dict, geom: BlockGeom) -> dict:
    """Inverse of :func:`block_to_flat`: back to OIHW and ``[C]`` vectors
    (leading lane dims kept)."""
    ci, co = geom.c_in, geom.c_out

    def oihw(m, k, c):
        lead = tuple(m.shape[:-2])
        n = len(lead)
        return m.reshape(lead + (k, k, c, co)).permute(*range(n), n + 3, n + 2, n, n + 1).contiguous()

    vec = lambda v: v.squeeze(-2)
    return {
        "conv1": oihw(flat["conv1"], 3, ci),
        "bn1": {"scale": vec(flat["bn1_s"]), "bias": vec(flat["bn1_b"])},
        "conv2": oihw(flat["conv2"], 3, co),
        "bn2": {"scale": vec(flat["bn2_s"]), "bias": vec(flat["bn2_b"])},
        "conv_sc": oihw(flat["conv_sc"], 1, ci),
        "bn_sc": {"scale": vec(flat["bnsc_s"]), "bias": vec(flat["bnsc_b"])},
    }


def bank_to_nhwc(fmap_bank: torch.Tensor) -> torch.Tensor:
    """The eval's NCHW feature bank ``[..., span, Ci, H, H]`` -> ``[...,
    span, H, H, Ci]`` contiguous (one copy per call)."""
    return fmap_bank.movedim(-3, -1).contiguous()


# --------------------------------------------------------------------------
# the plain version: the JAX step math in plain PyTorch
# --------------------------------------------------------------------------


def _patches3x3(xp: torch.Tensor, stride: int):
    """The 9 shifted windows of a 3x3 pad-1 conv over the PRE-PADDED input
    ``[B, H+2, H+2, C]``, each ``[B*ho*ho, C]``, ky-major then kx (the row
    order of the ``[9C, Co]`` weight matrix)."""
    b, hp, _, c = xp.shape
    ho = (hp - 2) // stride
    span = stride * ho
    return [xp[:, ky : ky + span : stride, kx : kx + span : stride, :].reshape(b * ho * ho, c)
            for ky in range(3) for kx in range(3)]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of compute-dtype operands accumulated in f32."""
    return torch.matmul(a.float(), b.float())


def _pad_hw(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))


def _conv3x3_fwd(pieces, wmat, c):
    acc = _mm(pieces[0], wmat[:c])
    for k in range(1, 9):
        acc = acc + _mm(pieces[k], wmat[k * c : (k + 1) * c])
    return acc


def _conv3x3_dw(pieces, dy):
    return torch.cat([_mm(p.t(), dy) for p in pieces], dim=0)


def _conv3x3_dx_s1(dy, wmat, b, h, c_in):
    """Input gradient of the stride-1 3x3 conv: per tap ``dy @ W_k^T`` added
    back at its pad shift.  ``dy [B*h*h, Co]`` -> ``[B, h, h, c_in]`` f32."""
    out = torch.zeros((b, h + 2, h + 2, c_in), dtype=torch.float32, device=dy.device)
    k = 0
    for ky in range(3):
        for kx in range(3):
            out[:, ky : ky + h, kx : kx + h, :] += _mm(dy, wmat[k * c_in : (k + 1) * c_in].t()).reshape(b, h, h, c_in)
            k += 1
    return out[:, 1 : 1 + h, 1 : 1 + h, :]


def _bn_fwd(y, scale, bias, wcol, count):
    """``y [R, C]`` f32, ``wcol [R, 1]`` row weights -> ``(out, xhat, inv)``."""
    mean = (y * wcol).sum(dim=0, keepdim=True) / count
    var = ((y - mean).square() * wcol).sum(dim=0, keepdim=True) / count
    inv = torch.rsqrt(var + _BN_EPS)
    xhat = (y - mean) * inv
    return xhat * scale + bias, xhat, inv


def _bn_bwd(dy, xhat, inv, scale, wcol, count):
    """Masked-BN input gradient and ``(dscale, dbias)``; masked rows get ``dx = 0``."""
    dscale = (dy * xhat).sum(dim=0)
    dbias = dy.sum(dim=0)
    dxhat = dy * scale
    m1 = (dxhat * wcol).sum(dim=0, keepdim=True) / count
    m2 = (dxhat * xhat * wcol).sum(dim=0, keepdim=True) / count
    return (dxhat - m1 - xhat * m2) * inv * wcol, dscale, dbias


def _product(which: str, wmat, x, dy, geom: BlockGeom) -> torch.Tensor:
    """One of :data:`PRODUCTS` on compute-dtype operands, f32 out: ``wmat``
    the product's weight matrix, ``x [B, h, h, C]`` its (gathered)
    activations, ``dy [R, Co]`` the gradient entering it (each None where the
    product has no such operand)."""
    if which == "conv_sc" or which == "conv_sc_dw":
        span = geom.stride * geom.h_out
        xs = x[:, 0:span : geom.stride, 0:span : geom.stride, :].reshape(geom.rows, geom.c_in)
        return _mm(xs, wmat) if which == "conv_sc" else _mm(xs.t(), dy)
    if which == "conv2_dx":
        return _conv3x3_dx_s1(dy, wmat, geom.batch, geom.h_out, geom.c_out).reshape(geom.rows, geom.c_out)
    pieces = _patches3x3(_pad_hw(x), geom.stride if which.startswith("conv1") else 1)
    if which.endswith("_dw"):
        return _conv3x3_dw(pieces, dy)
    return _conv3x3_fwd(pieces, wmat, x.shape[-1])


def step_grads_reference(p: dict, x: torch.Tensor, labels: torch.Tensor, w: torch.Tensor, geom: BlockGeom):
    """Forward and hand-derived backward of the final block on one minibatch.

    ``p``: flat dict of f32 parameter VALUES; ``x [B, H, H, Ci]``: the
    gathered bank rows in the compute dtype; ``labels [B]`` int; ``w [B]``
    f32 row weights (0 for a padded row).  Returns ``(grads, loss)`` with
    f32 gradients shaped like ``p``."""
    grads, loss, _ = _step(p, x, labels, w, geom)
    return grads, loss


def step_products_reference(p: dict, x: torch.Tensor, labels: torch.Tensor, w: torch.Tensor, geom: BlockGeom) -> dict:
    """The seven products of the plain step (arguments as
    :func:`step_grads_reference`): ``{which: {"w": weight matrix or None,
    "x": activations or None, "dy": incoming gradient or None, "out": f32}}``
    with the operands in the compute dtype as the step hands them to the
    product and ``out`` as the step goes on with it, before any rounding."""
    return _step(p, x, labels, w, geom)[2]


def _step(p: dict, x: torch.Tensor, labels: torch.Tensor, w: torch.Tensor, geom: BlockGeom):
    """The plain step: ``(grads, loss, products)``."""
    b, ho, co, ci = geom.batch, geom.h_out, geom.c_out, geom.c_in
    r, hw = geom.rows, geom.h_out * geom.h_out
    cd = x.dtype
    w = w.to(torch.float32)
    wcol = w[:, None].expand(b, hw).reshape(r, 1)
    count = torch.clamp(w.sum(), min=1e-6) * hw
    rnd = lambda a: a.to(cd).float()  # round to the compute dtype, go on in f32

    w1, w2, wsc = p["conv1"].to(cd), p["conv2"].to(cd), p["conv_sc"].to(cd)

    # ---- forward
    prods = {}

    def product(which, wmat, xin, dy):
        out = _product(which, wmat, xin, dy, geom)
        prods[which] = {"w": wmat, "x": xin, "dy": dy, "out": out}
        return out

    y1 = rnd(product("conv1", w1, x, None))
    h1, xhat1, inv1 = _bn_fwd(y1, p["bn1_s"], p["bn1_b"], wcol, count)
    z1c = torch.relu(h1).to(cd).reshape(b, ho, ho, co)

    y2 = rnd(product("conv2", w2, z1c, None))
    h2, xhat2, inv2 = _bn_fwd(y2, p["bn2_s"], p["bn2_b"], wcol, count)

    ys = rnd(product("conv_sc", wsc, x, None))
    hs, xhats, invs = _bn_fwd(ys, p["bnsc_s"], p["bnsc_b"], wcol, count)

    pre = h2 + hs
    out = torch.relu(pre)
    logits = rnd(out.reshape(b, hw, co).mean(dim=1))  # global average pool, features as logits

    # ---- masked CE
    onehot = torch.nn.functional.one_hot(labels.long(), co).to(torch.float32)
    zmax = logits.max(dim=1, keepdim=True).values
    ez = torch.exp(logits - zmax)
    sez = ez.sum(dim=1, keepdim=True)
    lse = torch.log(sez) + zmax
    denom = torch.clamp(w.sum(), min=1.0)
    ce = (lse - (logits * onehot).sum(dim=1, keepdim=True)) * w[:, None]
    loss = ce.sum() / denom

    # ---- backward
    dlogits = (ez / sez - onehot) * (w[:, None] / denom)
    dout = (dlogits[:, None, :] / hw).expand(b, hw, co).reshape(r, co)
    dpre = torch.where(pre > 0.0, dout, torch.zeros_like(dout))

    dy2, dg2, db2 = _bn_bwd(dpre, xhat2, inv2, p["bn2_s"], wcol, count)
    dys, dgs, dbs = _bn_bwd(dpre, xhats, invs, p["bnsc_s"], wcol, count)

    dy2c = dy2.to(cd)
    dw2 = product("conv2_dw", None, z1c, dy2c)
    dz1 = product("conv2_dx", w2, None, dy2c)
    dh1 = torch.where(h1 > 0.0, dz1, torch.zeros_like(dz1))
    dy1, dg1, db1 = _bn_bwd(dh1, xhat1, inv1, p["bn1_s"], wcol, count)
    dw1 = product("conv1_dw", None, x, dy1.to(cd))
    dwsc = product("conv_sc_dw", None, x, dys.to(cd))

    grads = {"conv1": dw1, "bn1_s": dg1[None, :], "bn1_b": db1[None, :], "conv2": dw2, "bn2_s": dg2[None, :],
             "bn2_b": db2[None, :], "conv_sc": dwsc, "bnsc_s": dgs[None, :], "bnsc_b": dbs[None, :]}
    return grads, loss, prods


def bias_corrections(t: int, b1: float = 0.9, b2: float = 0.999):
    """``1 - b**t`` as ``1 - exp(t * log(b))`` in f32, as the kernels compute it."""
    tf = np.float32(t)
    bc = lambda b: float(np.float32(1.0) - np.exp(tf * np.float32(math.log(b)), dtype=np.float32))
    return bc(b1), bc(b2)


def adam_update_reference(p, mu, nu, g, t: int, lr: float, b1: float = 0.9, b2: float = 0.999):
    """torch-Adam with moments STORED in their own dtype (bf16) and f32
    math: the moments are rounded first and the rounded values feed the
    update; the parameter keeps its carry dtype.  ``t`` counts from 1."""
    bc1, bc2 = bias_corrections(t, b1, b2)
    new_p, new_mu, new_nu = {}, {}, {}
    for k in p:
        gf = g[k].float()
        new_mu[k] = (b1 * mu[k].float() + (1.0 - b1) * gf).to(mu[k].dtype)
        new_nu[k] = (b2 * nu[k].float() + (1.0 - b2) * gf.square()).to(nu[k].dtype)
        mh = new_mu[k].float() / bc1
        vh = new_nu[k].float() / bc2
        upd = -lr * mh / (torch.sqrt(vh) + _ADAM_EPS)
        new_p[k] = (p[k].float() + upd).to(p[k].dtype)
    return new_p, new_mu, new_nu


def fused_inner_scan_reference(p0, fmap_bank, bank_y, idx, w, *, geom: BlockGeom, lr: float):
    """The scan in plain PyTorch, a Python loop over the ``T`` steps.
    ``p0``: flat dict in the carry dtype; ``fmap_bank [span, H, H, Ci]``;
    ``bank_y [span]``; ``idx``/``w``: ``[T, B]``."""
    p = dict(p0)
    mu = {k: torch.zeros_like(v, dtype=torch.bfloat16) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v, dtype=torch.bfloat16) for k, v in p0.items()}
    idx = idx.long()
    for t in range(idx.shape[0]):
        pf = {k: v.float() for k, v in p.items()}
        g, _ = step_grads_reference(pf, fmap_bank[idx[t]], bank_y[idx[t]], w[t], geom)
        p, mu, nu = adam_update_reference(p, mu, nu, g, t + 1, lr)
    return p


# --------------------------------------------------------------------------
# the CUDA kernels' wrappers
# --------------------------------------------------------------------------

_GEOM_ARGS = [ctypes.c_int] * 5  # h_in, c_in, c_out, stride, batch
_CARRY = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _lib():
    from mft_tpu_torch.kernels.build import load

    lib = load("fused_inner_scan")
    if not getattr(lib, "_mft_bound", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_inner_scan_scratch_bytes.argtypes = _GEOM_ARGS + [ci]  # geom, tensor-core route
        lib.fused_inner_scan_scratch_bytes.restype = ctypes.c_size_t
        lib.fused_inner_scan_kernels_per_step.argtypes = [ci]  # bank_is_bf16
        lib.fused_inner_scan_kernels_per_step.restype = ci
        for sfx in _CARRY.values():
            scan = getattr(lib, f"fused_inner_scan_{sfx}")
            # p, bank, bank_is_bf16, bank_y, idx, w, scratch, L, T, span, geom, lr, stream
            scan.argtypes = [vp, vp, ci, vp, vp, vp, vp, ci, ci, ci] + _GEOM_ARGS + [cf, vp]
            scan.restype = ci
            grads = getattr(lib, f"fused_step_grads_{sfx}")
            # p, bank, bank_is_bf16, bank_y, idx_t, w_t, scratch, grads_out, loss_out, span, geom, route, stream
            grads.argtypes = [vp, vp, ci, vp, vp, vp, vp, vp, vp, ci] + _GEOM_ARGS + [ci, vp]
            grads.restype = ci
        # which, W, X, DY, out, scratch, is_bf16, route, geom, stream
        lib.fused_inner_scan_product.argtypes = [ci, vp, vp, vp, vp, vp, ci, ci] + _GEOM_ARGS + [vp]
        lib.fused_inner_scan_product.restype = ci
        lib._mft_bound = True
    return lib


def kernels_per_step(bank_dtype: torch.dtype = torch.bfloat16) -> int:
    """Device kernels the C loop enqueues per inner step for a bank of this
    dtype (builds the library)."""
    return int(_lib().fused_inner_scan_kernels_per_step(int(bank_dtype == torch.bfloat16)))


_ROUTES = {None: 0, "fma": 1}


def _route(route) -> int:
    """The C entry points' route number: None = the scan's own (tensor cores
    for bf16 operands, f32 FMAs for f32), "fma" = the FMA products whatever
    the dtype.  Explicit, for checks; the scan has no such argument."""
    if route not in _ROUTES:
        raise ValueError(f"route must be None or 'fma', got {route!r}")
    return _ROUTES[route]


def _check_inputs(p0, bank, bank_y, idx, w, geom: BlockGeom, lanes):
    """Raise on any tensor the kernels do not take (:func:`_scratch` refuses
    the geometry).  ``lanes``: L, or None for un-stacked (single step)
    arguments.  Returns the carry dtype."""
    lead = () if lanes is None else (lanes,)
    dev = bank.device
    if dev.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got the bank on {dev}")
    if set(p0) != set(PKEYS):
        raise ValueError(f"p0 must hold exactly {PKEYS}, got {sorted(p0)}")
    dt = p0["conv1"].dtype
    if dt not in _CARRY:
        raise TypeError(f"parameters must be carried in bfloat16 or float32, got {dt}")
    for k, shape in param_shapes(geom).items():
        if tuple(p0[k].shape) != lead + shape or p0[k].dtype != dt or p0[k].device != dev:
            raise ValueError(f"p0[{k!r}] must be {lead + shape} {dt} on {dev}, got {tuple(p0[k].shape)} {p0[k].dtype} "
                             f"on {p0[k].device}")
    if bank.dtype not in _CARRY:
        raise TypeError(f"the bank must be bfloat16 or float32, got {bank.dtype}")
    if bank.dim() != len(lead) + 4 or tuple(bank.shape[len(lead) + 1 :]) != (geom.h_in, geom.h_in, geom.c_in) \
            or tuple(bank.shape[: len(lead)]) != lead:
        raise ValueError(f"the bank must be {lead + ('span', geom.h_in, geom.h_in, geom.c_in)}, got {tuple(bank.shape)}")
    if not bank.is_contiguous():
        raise ValueError("the bank must be contiguous (bank_to_nhwc makes it so)")
    span = bank.shape[len(lead)]
    if span >= 32768:
        raise ValueError(f"at most 32767 bank rows, got {span}")
    if tuple(bank_y.shape) != (span,) or bank_y.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"bank_y must be [{span}] int32/int64, got {tuple(bank_y.shape)} {bank_y.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if idx.dim() != len(lead) + (2 if lanes is not None else 1) or idx.shape[-1] != geom.batch \
            or tuple(idx.shape[: len(lead)]) != lead:
        raise ValueError(f"idx must be {lead + (('T',) if lanes is not None else ()) + (geom.batch,)}, got {tuple(idx.shape)}")
    if tuple(w.shape) != tuple(idx.shape[len(lead) :]):
        raise ValueError(f"w must be {tuple(idx.shape[len(lead):])} (shared by the lanes), got {tuple(w.shape)}")
    for name, t in (("bank_y", bank_y), ("idx", idx), ("w", w)):
        if t.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {t.device}")
    return dt


def _pack(p0: dict, lead: tuple) -> torch.Tensor:
    """The nine tensors as one ``lead + [n_params]`` buffer in PKEYS order (a fresh copy)."""
    return torch.cat([p0[k].reshape(lead + (-1,)) for k in PKEYS], dim=-1).contiguous()


def _unpack(flat: torch.Tensor, geom: BlockGeom, lead: tuple) -> dict:
    shapes = param_shapes(geom)
    parts = torch.split(flat, [math.prod(shapes[k]) for k in PKEYS], dim=-1)
    return {k: part.reshape(lead + shapes[k]) for k, part in zip(PKEYS, parts)}


def _scratch(lib, geom: BlockGeom, dev, tensor_cores: bool, lanes: int = 1) -> torch.Tensor:
    """The one scratch buffer of a call, ``lanes`` slices of what the
    library asks for a lane on the products' route (it answers 0 for a
    geometry its kernels do not take)."""
    nbytes = int(lib.fused_inner_scan_scratch_bytes(*geom, int(tensor_cores))) * lanes
    if nbytes == 0:
        raise ValueError(f"the fused inner-scan kernels do not take {geom}: stride 1 or 2 dividing h_in <= 255, "
                         "c_in and c_out multiples of 16 (for a bfloat16 bank, whose products run on the tensor "
                         "cores: c_in a multiple of 64, c_out of 128), at most 1024 rows (batch*h_out^2)")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch_scan(p0, fmap_banks, bank_y, idx, w, geom: BlockGeom, lr: float) -> dict:
    global LAUNCHES, LAST_ENQUEUE_SECONDS
    if idx.dim() != 3:
        raise ValueError(f"idx must be [L, T, {geom.batch}], got {tuple(idx.shape)}")
    lanes = idx.shape[0]
    dt = _check_inputs(p0, fmap_banks, bank_y, idx, w, geom, lanes)
    n_steps, span, dev = idx.shape[1], fmap_banks.shape[1], fmap_banks.device
    if lanes == 0 or n_steps == 0:
        return {k: v.clone() for k, v in p0.items()}
    lib = _lib()
    state = _pack(p0, (lanes,))  # updated in place by the kernels
    tensor_cores = fmap_banks.dtype == torch.bfloat16
    # a step's grids cover every lane on the tensor-core route; the FMA route runs the lanes in turn on one slice
    scratch = _scratch(lib, geom, dev, tensor_cores, lanes if tensor_cores else 1)
    metrics.count("scan.grid_steps", n_steps if tensor_cores else lanes * n_steps)
    y32 = bank_y.to(torch.int32).contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    fn = getattr(lib, f"fused_inner_scan_{_CARRY[dt]}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES += 1
    t0 = time.perf_counter()
    with torch.cuda.device(dev):  # the library sets up its kernels on the current device
        err = fn(state.data_ptr(), fmap_banks.data_ptr(), int(tensor_cores), y32.data_ptr(),
                 idx32.data_ptr(), w32.data_ptr(), scratch.data_ptr(), lanes, n_steps, span, *geom, float(lr),
                 stream)
    LAST_ENQUEUE_SECONDS = time.perf_counter() - t0
    if err != 0:
        raise RuntimeError(f"fused_inner_scan_{_CARRY[dt]} launch failed: cudaError {err}")
    # the stream orders the kernels before any later use or reuse of these buffers
    return _unpack(state, geom, (lanes,))


def fused_inner_scan_lanes(p0, fmap_banks, bank_y, idx, w, *, geom: BlockGeom, lr: float):
    """The whole adaptation scan for ``L`` episode lanes in one call.

    ``p0``: flat dict (PKEYS) of ``[L, ...]`` tensors in the carry dtype
    (bf16 or f32); ``fmap_banks [L, span, H, H, Ci]`` in the compute dtype;
    ``bank_y [span]`` int (shared by the lanes); ``idx [L, T, B]`` per-lane
    minibatch schedules; ``w [T, B]`` row weights (the same for every lane:
    the padding of ``minibatch_schedule`` depends only on the position).
    Returns the adapted parameters (``[L, ...]``, same dtype); ``p0`` is
    not modified.  Adds the call's ``L * T`` steps to the lane batch's
    ``adapt.lane_steps`` counter (``utils/metrics.count``), and the step
    programs it runs one after another to ``scan.grid_steps``: ``T`` where
    a step's grids cover every lane (a bf16 bank on CUDA), ``L * T`` where
    the lanes run in turn (an f32 bank, and the plain version on the CPU)."""
    metrics.count("adapt.lane_steps", idx.shape[0] * idx.shape[1])
    if fmap_banks.device.type == "cpu":
        metrics.count("scan.grid_steps", idx.shape[0] * idx.shape[1])
        outs = [fused_inner_scan_reference({k: v[l] for k, v in p0.items()}, fmap_banks[l], bank_y, idx[l], w,
                                           geom=geom, lr=lr) for l in range(idx.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in PKEYS}
    return _launch_scan(p0, fmap_banks, bank_y, idx, w, geom, lr)


def fused_inner_scan(p0, fmap_bank, bank_y, idx, w, *, geom: BlockGeom, lr: float):
    """Single-lane form of :func:`fused_inner_scan_lanes`."""
    out = fused_inner_scan_lanes({k: v[None] for k, v in p0.items()}, fmap_bank[None], bank_y, idx[None], w,
                                 geom=geom, lr=lr)
    return {k: v[0] for k, v in out.items()}


def fused_step_grads(p, fmap_bank, bank_y, idx_t, w_t, *, geom: BlockGeom, route=None):
    """One forward and backward without the Adam update, for checks:
    ``(grads, loss)`` of the minibatch ``idx_t [B]`` / ``w_t [B]`` of the
    bank ``[span, H, H, Ci]`` at the flat parameters ``p`` (carry dtype).
    CUDA tensors go through the same device kernels as the scan;
    ``route="fma"`` runs the f32 FMA products on them whatever the bank's
    dtype (a bf16 bank otherwise takes the tensor cores)."""
    rt = _route(route)
    if fmap_bank.device.type == "cpu":
        idx_t = idx_t.long()
        return step_grads_reference({k: v.float() for k, v in p.items()}, fmap_bank[idx_t], bank_y[idx_t], w_t, geom)
    dt = _check_inputs(p, fmap_bank, bank_y, idx_t, w_t, geom, None)
    lib, dev = _lib(), fmap_bank.device
    flat = _pack(p, ())
    grads = torch.empty(flat.shape, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    bank_bf16 = fmap_bank.dtype == torch.bfloat16
    scratch = _scratch(lib, geom, dev, bank_bf16 and rt == 0)
    y32, idx32, w32 = bank_y.to(torch.int32).contiguous(), idx_t.to(torch.int32).contiguous(), w_t.float().contiguous()
    fn = getattr(lib, f"fused_step_grads_{_CARRY[dt]}")
    with torch.cuda.device(dev):
        err = fn(flat.data_ptr(), fmap_bank.data_ptr(), int(bank_bf16), y32.data_ptr(),
                 idx32.data_ptr(), w32.data_ptr(), scratch.data_ptr(), grads.data_ptr(), loss.data_ptr(),
                 fmap_bank.shape[0], *geom, rt, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_step_grads_{_CARRY[dt]} launch failed: cudaError {err}")
    return _unpack(grads, geom, ()), loss


def product_shapes(which: str, geom: BlockGeom) -> dict:
    """Shapes of one product's operands and output (None: no such operand)."""
    r, ci, co, b = geom.rows, geom.c_in, geom.c_out, geom.batch
    x_in, x_mid = (b, geom.h_in, geom.h_in, ci), (b, geom.h_out, geom.h_out, co)
    return {
        "conv1": {"w": (9 * ci, co), "x": x_in, "dy": None, "out": (r, co)},
        "conv_sc": {"w": (ci, co), "x": x_in, "dy": None, "out": (r, co)},
        "conv2": {"w": (9 * co, co), "x": x_mid, "dy": None, "out": (r, co)},
        "conv2_dx": {"w": (9 * co, co), "x": None, "dy": (r, co), "out": (r, co)},
        "conv1_dw": {"w": None, "x": x_in, "dy": (r, co), "out": (9 * ci, co)},
        "conv2_dw": {"w": None, "x": x_mid, "dy": (r, co), "out": (9 * co, co)},
        "conv_sc_dw": {"w": None, "x": x_in, "dy": (r, co), "out": (ci, co)},
    }[which]


def fused_product(which: str, wmat, x, dy, geom: BlockGeom, route=None) -> torch.Tensor:
    """One of the seven products of a step (:data:`PRODUCTS`) alone, for
    checks and times: ``wmat`` the product's weight matrix, ``x`` its
    gathered activations, ``dy`` the gradient entering it (None where
    :func:`product_shapes` says so), all in the compute dtype (bf16 or f32);
    f32 out.  CUDA tensors take the kernel the scan would take for that
    dtype (``route="fma"``: the FMA kernel) or raise; CPU tensors the plain
    product."""
    rt = _route(route)
    if which not in PRODUCTS:
        raise ValueError(f"which must be one of {PRODUCTS}, got {which!r}")
    shapes = product_shapes(which, geom)
    given = {"w": wmat, "x": x, "dy": dy}
    ops = [t for k, t in given.items() if shapes[k] is not None]
    for k, t in given.items():
        if (shapes[k] is None) != (t is None) or (t is not None and tuple(t.shape) != shapes[k]):
            raise ValueError(f"{which}: operand {k!r} must be {shapes[k]}, got {None if t is None else tuple(t.shape)}")
    cd, dev = ops[0].dtype, ops[0].device
    if cd not in _CARRY or any(t.dtype != cd or t.device != dev for t in ops):
        raise TypeError(f"{which}: operands must share one dtype (bfloat16 or float32) and one device")
    if dev.type == "cpu":
        return _product(which, wmat, x, dy, geom)
    if dev.type != "cuda" or not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{which}: expected contiguous CUDA (or CPU) tensors")
    lib = _lib()
    is_bf16 = cd == torch.bfloat16
    out = torch.empty(shapes["out"], dtype=torch.float32, device=dev)
    scratch = _scratch(lib, geom, dev, is_bf16 and rt == 0)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.fused_inner_scan_product(PRODUCTS.index(which), ptr(wmat), ptr(x), ptr(dy), out.data_ptr(),
                                           scratch.data_ptr(), int(is_bf16), rt, *geom,
                                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_inner_scan_product({which}) launch failed: cudaError {err}")
    return out
