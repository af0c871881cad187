"""The arithmetic of the port's edge kernel (kernels/csrc/edge_mlp.cu) on the
CPU: its three-term bf16 split, emulated in plain torch by
``edge_abs_diff_matmul_split_reference``, against the JAX Pallas kernel in
interpret mode (as tests/test_torch_gnn.py runs it).

Why rtol/atol 1e-4: the JAX kernel is f32 and its tests hold 1e-4
(tests/test_pallas.py). The split ``hi = bf16(v)``, ``lo = bf16(v - hi)``
leaves ``v - hi - lo`` within 2**-16 of ``v``, and the products
``hi*hi + hi*lo + lo*hi`` drop only ``lo*lo`` and those remainders, so the
emulation sits about 5e-6 of the output's largest value from the f32
product: a 20x margin. One bf16 product alone is 2e-3 away, which is why the
kernel takes three; the last test records that. The CUDA kernel itself is
held against this emulation and the f32 plain version on the card by
chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

import mft_tpu.ops.pallas.edge_mlp as jem
from mft_tpu_torch.kernels import edge_mlp as tem


def _edge_inputs(b, n, f, c, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n, f).astype(np.float32), (rs.randn(f, c) * 0.05).astype(np.float32),
            rs.randn(c).astype(np.float32))


def _split_ref(x, w, b, terms=3):
    """The emulation on numpy inputs; ``w`` in the JAX layout ``[F, C]``."""
    return tem.edge_abs_diff_matmul_split_reference(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                                    torch.from_numpy(b), terms=terms).numpy()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_recovers_f32(scale, seed):
    """``hi`` is exactly a bf16 value and ``hi + lo`` is the f32 value to
    2**-16 relative, over values from tiny to large and of both signs."""
    rs = np.random.RandomState(seed)
    t = torch.from_numpy((rs.randn(4096) * scale * np.exp(rs.uniform(-4, 4, 4096))).astype(np.float32))
    hi, lo = tem.split_bf16(t)
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.float().to(torch.bfloat16).float().numpy(), hi.float().numpy())
    np.testing.assert_array_equal(hi.float().numpy(), t.to(torch.bfloat16).float().numpy())  # round to nearest
    err = (hi.double() + lo.double() - t.double()).abs() / t.double().abs()
    assert float(err.max()) <= 2.0**-16


@pytest.mark.parametrize("shape", [(2, 30, 133, 192), (2, 30, 229, 192), (1, 130, 40, 24)])
def test_split_reference_matches_pallas_interpret(shape):
    """The main path's widths (N = 30, C = 192, the first and last of its three
    F) and the 50-shot graph (N = 130), narrowed."""
    x, w, b = _edge_inputs(*shape, seed=0)
    want = np.asarray(jax.jit(lambda x, w, b: jem.edge_abs_diff_matmul(x, w, b, True))(x, w, b))
    got = _split_ref(x, w, b)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 30, 133, 192), (3, 7, 5, 8), (1, 30, 128, 64)])
def test_split_reference_close_to_plain(shape):
    """Against the port's f32 plain version, as a share of the output's
    largest value: within 2e-5, a fifth of the card's 1e-4."""
    x, w, b = _edge_inputs(*shape, seed=2)
    plain = tem.edge_abs_diff_matmul_reference(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                               torch.from_numpy(b)).numpy()
    err = np.abs(_split_ref(x, w, b) - plain).max() / np.abs(plain).max()
    assert err <= 2e-5


def test_one_term_misses_tolerance():
    """The single bf16 product (``lo`` terms dropped) is further than 1e-4 of
    the output's maximum from the f32 kernel at the main path's widest call,
    while the three-term form is within it."""
    x, w, b = _edge_inputs(2, 30, 229, 192, seed=0)
    want = np.asarray(jax.jit(lambda x, w, b: jem.edge_abs_diff_matmul(x, w, b, True))(x, w, b))
    scale = np.abs(want).max()
    one = np.abs(_split_ref(x, w, b, terms=1) - want).max() / scale
    three = np.abs(_split_ref(x, w, b) - want).max() / scale
    assert one > 1e-4 > three


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="256"):
        tem._launch(x, torch.zeros(257, 4), torch.zeros(257))
    with pytest.raises(ValueError, match="terms"):
        tem.edge_abs_diff_matmul_split_reference(x, torch.zeros(8, 4), torch.zeros(8), terms=2)


@pytest.mark.parametrize("x, w, b, match", [
    ((3, 4), (8, 4), (8,), "expected"),
    ((1, 3, 4), (8, 4, 1), (8,), "expected"),
    ((1, 3, 4), (8, 4), (8, 1), "expected"),
    ((1, 3, 4), (8, 5), (8,), "mismatch"),
    ((1, 3, 4), (8, 4), (7,), "mismatch"),
    ((1, 46341, 1), (8, 1), (8,), "too large"),  # 46341**2 rows overflow the kernel's int
    ((1, 3, 4), (8, 4), (8,), "CUDA tensor"),
], ids=["x-2d", "w-3d", "b-2d", "w-depth", "b-width", "rows-int32", "cpu-tensor"])
def test_wrapper_refuses_bad_inputs(x, w, b, match):
    """The kernel's wrapper refuses, before it builds or launches anything,
    what its C entry point would misread."""
    with pytest.raises(ValueError, match=match):
        tem._launch(torch.zeros(x), torch.zeros(w), torch.zeros(b))
