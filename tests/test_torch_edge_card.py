"""The port's edge kernel (kernels/csrc/edge_mlp.cu) on a CUDA card: the
scratch its C side asks for, and its output against the plain version at
ragged shapes.  Marked ``cuda``; without a card each test skips.  On the
card: ``python -m pytest -m cuda tests/test_torch_edge_card.py -q``
(imports no JAX).  ``chip_smoke.py`` holds the kernel at the main path's
shapes besides.
"""

import numpy as np
import pytest
import torch

from mft_tpu_torch.kernels import edge_mlp as tem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m cuda tests/test_torch_edge_card.py")
    return torch.device("cuda")


@pytest.mark.parametrize("f, c, want", [(133, 192, 2 * 192 * 192), (229, 192, 2 * 192 * 256),
                                        (128, 192, 2 * 192 * 128), (5, 8, 2 * 64 * 64), (40, 256, 2 * 256 * 64)])
def test_split_scratch_shape(cuda_dev, f, c, want):
    """W's split scratch as the C side lays it out: hi then lo rows,
    channels padded to the 64-column blocks of the wgmma, the reduction to
    whole 128-byte swizzle rows of 64 bf16."""
    assert tem.scratch_elems(f, c) == want


@pytest.mark.parametrize("shape", [(3, 7, 5, 8), (1, 30, 128, 64), (2, 11, 70, 130)])
def test_kernel_matches_plain(cuda_dev, shape):
    """Rows not a multiple of the 128-row tile, F a multiple of 64 or not,
    C of one to three 64-column blocks: within 1e-4 of the output's largest
    value, the f32 tolerance chip_smoke.py holds."""
    b, n, f, c = shape
    rs = np.random.RandomState(0)
    x, w, bias = (torch.from_numpy(a).to(cuda_dev) for a in (
        rs.randn(b, n, f).astype(np.float32), (rs.randn(c, f) * 0.05).astype(np.float32),
        rs.randn(c).astype(np.float32)))
    got = tem.edge_abs_diff_matmul(x, w, bias)
    want = tem.edge_abs_diff_matmul_reference(x, w, bias)
    assert got.shape == (b, n, n, c)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
