"""The port's fused inner scan (kernels/csrc/fused_inner_scan.cu) on a CUDA
card: with a bf16 bank a step's grids cover every lane of the call, and
each lane's adapted state must be, bit for bit, what a call with that lane
alone gives (the same tiling, split-K chunks, reduction order and rounding
places per lane).  Marked ``cuda``; without a card each test skips.  On the
card, where JAX is not installed: ``python -m pytest -m cuda --noconftest
tests/test_torch_fused_scan_card.py -q``.  ``chip_smoke.py`` holds the scan
against its plain version besides.
"""

import pytest
import torch

from mft_tpu_torch.kernels import fused_inner_scan as tfis
from mft_tpu_torch.train.inner_loop import InnerLoopCfg, lane_schedule
from mft_tpu_torch.utils import metrics

pytestmark = pytest.mark.cuda

#: the cells' final block (ResNet10 at 224 px) and the synthetic pipeline's at 64 px
GEOMS = {"224px": tfis.BlockGeom(14, 256, 512, 2, 5), "64px": tfis.BlockGeom(4, 256, 512, 2, 5)}
SPAN, STEPS, LR = 100, 20, 0.01


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m cuda --noconftest tests/test_torch_fused_scan_card.py")
    return torch.device("cuda")


def _inputs(geom, lanes, carry, dev):
    """Each lane its own parameters, bank and schedule: one epoch of STEPS
    minibatches of ``geom.batch`` rows over the bank's first rows, the last
    minibatch ragged."""
    gen = torch.Generator(device=dev).manual_seed(lanes)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    p0 = {k: (randn(lanes, *shape) * (2.0 / shape[0]) ** 0.5 if k.startswith("conv")
              else randn(lanes, *shape) * 0.1 + (1.0 if k.endswith("_s") else 0.0)).to(carry)
          for k, shape in tfis.param_shapes(geom).items()}
    banks = torch.relu(randn(lanes, SPAN, geom.h_in, geom.h_in, geom.c_in)).to(torch.bfloat16)
    bank_y = torch.arange(SPAN, device=dev) % 5
    cfg = InnerLoopCfg(1, geom.batch, STEPS * geom.batch - 3)
    idx, w = lane_schedule([torch.Generator().manual_seed(100 + l) for l in range(lanes)], cfg, dev)
    return p0, banks, bank_y, idx, w


@pytest.mark.parametrize("carry", [torch.bfloat16, torch.float32], ids=["bf16_carry", "f32_carry"])
@pytest.mark.parametrize("geom_id", list(GEOMS))
@pytest.mark.parametrize("lanes", [1, 3, 20])
def test_lanes_together_are_lanes_alone_bit_for_bit(cuda_dev, lanes, geom_id, carry):
    """The lanes-together scan on a bf16 bank against one single-lane call a
    lane: every parameter of every lane equal bit for bit; a second call
    on the same inputs gives the same bits; ``scan.grid_steps`` counts T a
    call (one step program for all lanes), ``adapt.lane_steps`` L x T."""
    geom = GEOMS[geom_id]
    p0, banks, bank_y, idx, w = _inputs(geom, lanes, carry, cuda_dev)
    with metrics.eval_batch(0, lanes) as b:
        together = tfis.fused_inner_scan_lanes(p0, banks, bank_y, idx, w, geom=geom, lr=LR)
    again = tfis.fused_inner_scan_lanes(p0, banks, bank_y, idx, w, geom=geom, lr=LR)
    alone = [tfis.fused_inner_scan_lanes({k: v[l : l + 1] for k, v in p0.items()}, banks[l : l + 1].contiguous(),
                                         bank_y, idx[l : l + 1].contiguous(), w, geom=geom, lr=LR)
             for l in range(lanes)]
    torch.cuda.synchronize()
    assert b.counters == {"adapt.lane_steps": lanes * STEPS, "scan.grid_steps": STEPS}
    for k in tfis.PKEYS:
        assert together[k].dtype == carry and bool(torch.isfinite(together[k]).all()), k
        assert not torch.equal(together[k], p0[k]), f"{k} did not move"
        assert torch.equal(together[k], again[k]), f"{k}: two calls on the same inputs differ"
        for l in range(lanes):
            assert torch.equal(together[k][l], alone[l][k][0]), f"{k}, lane {l}: not the single-lane call's bits"
