"""GNN edge op: ``out[b,i,j,:] = |x[b,i,:] - x[b,j,:]| @ w.T + bias``.

Port of the TPU kernel ``mft_tpu/ops/pallas/edge_mlp.py:edge_abs_diff_matmul``
as a hand-written CUDA kernel (``csrc/edge_mlp.cu``, which documents its
design and bound).  ``w`` is in torch layout ``[C, F]``.  f32 in, f32 out:
the kernel's products run on the tensor cores as the three-term bf16 split
``hi*hi + hi*lo + lo*hi`` (:func:`split_bf16`), which
:func:`edge_abs_diff_matmul_split_reference` emulates in plain torch.

* On a CUDA tensor, :func:`edge_abs_diff_matmul` launches the kernel or
  raises; it never falls back.  One call is two device kernels, W's split
  pass and the product, and counts as one launch in ``LAUNCHES``.  Its
  gradient is a ``torch.autograd.Function`` whose backward is the
  plain-torch form of the JAX custom VJP (``_edge_bwd``, itself plain XLA on
  the TPU).
* On a CPU tensor it computes :func:`edge_abs_diff_matmul_reference`, the
  plain version the tests hold against JAX and ``chip_smoke.py`` holds the
  kernel against on the card.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of the CUDA kernel in this process (read by chip_smoke.py)
LAUNCHES = 0


def edge_abs_diff_matmul_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the ``[B, N, N, F]`` edge tensor, then a matmul."""
    e = (x[:, :, None, :] - x[:, None, :, :]).abs()
    return torch.matmul(e, w.t()) + b


def split_bf16(t: torch.Tensor):
    """``(hi, lo)`` bf16 with ``hi = bf16(t)``, ``lo = bf16(t - hi)`` (round
    to nearest, as the kernel splits): ``hi + lo`` is ``t`` to 2**-16."""
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def edge_abs_diff_matmul_split_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                         terms: int = 3) -> torch.Tensor:
    """Plain emulation of the kernel's arithmetic, for tests and
    ``chip_smoke.py``: edges and ``w`` split by :func:`split_bf16`, the
    products ``hi*hi + hi*lo + lo*hi`` (each exact in f32) summed in f32.
    ``terms=1`` keeps ``hi*hi`` alone: the single bf16 product the kernel
    does not use, because it misses the f32 tolerance."""
    e_hi, e_lo = split_bf16((x[:, :, None, :] - x[:, None, :, :]).abs())
    w_hi, w_lo = split_bf16(w)
    mm = lambda a, c: torch.matmul(a.float(), c.float().t())
    out = mm(e_hi, w_hi)
    if terms == 3:
        out = out + mm(e_hi, w_lo) + mm(e_lo, w_hi)
    elif terms != 1:
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    return out + b


def _lib():
    """The built library, its two C entry points typed."""
    from mft_tpu_torch.kernels.build import load

    lib = load("edge_mlp")
    lib.edge_abs_diff_matmul_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.edge_abs_diff_matmul_f32.restype = ctypes.c_int
    lib.edge_abs_diff_matmul_scratch_elems.argtypes = [ctypes.c_int] * 2
    lib.edge_abs_diff_matmul_scratch_elems.restype = ctypes.c_size_t
    return lib


def scratch_elems(f: int, c: int) -> int:
    """bf16 elements of the scratch the kernel needs for W's split, as its C
    side lays it out (hi rows then lo rows, padded to its tiles)."""
    return int(_lib().edge_abs_diff_matmul_scratch_elems(f, c))


def _edge_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """``(dx, dw, db)`` of the op at cotangent ``g [B, N, N, C]``
    (edge_mlp.py:94-103): with ``d = x_i - x_j``,
    ``dx = sum_j sign(d)*gW - sum_i sign(d)*gW``, ``dw = g^T |d|``,
    ``db = sum g``."""
    d = x[:, :, None, :] - x[:, None, :, :]
    sgw = torch.sign(d) * torch.matmul(g, w)
    dx = sgw.sum(dim=2) - sgw.sum(dim=1)
    dw = torch.einsum("bijc,bijf->cf", g, d.abs())
    return dx, dw, g.sum(dim=(0, 1, 2))


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if x.dim() != 3 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"expected x [B,N,F], w [C,F], b [C]; got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    bsz, n, f = x.shape
    c = w.shape[0]
    if w.shape[1] != f or b.shape[0] != c:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    if c > 256:  # all channels in one wgmma of at most 256 columns
        raise ValueError(f"at most 256 output channels, got {c}")
    if max(bsz * n * n, x.numel()) >= 2**31:  # the kernel indexes rows and x with int
        raise ValueError(f"too large for one call: x {tuple(x.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((bsz, n, n, c), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    wsplit = torch.empty(scratch_elems(f, c), device=x.device, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCHES += 1
    err = _lib().edge_abs_diff_matmul_f32(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                          wsplit.data_ptr(), bsz, n, f, c, stream)
    if err != 0:
        raise RuntimeError(f"edge_abs_diff_matmul_f32 launch failed: cudaError {err}")
    return out


class _EdgeAbsDiffMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _launch(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _edge_bwd(x, w, g)


def edge_abs_diff_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x ``[B, N, F]`` f32, w ``[C, F]``, b ``[C]`` -> ``[B, N, N, C]`` f32."""
    if x.device.type == "cpu":
        return edge_abs_diff_matmul_reference(x, w, b)
    return _EdgeAbsDiffMatmul.apply(x.contiguous(), w.contiguous(), b.contiguous())
