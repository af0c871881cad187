"""The plain reference against the port's CPU path on one small episode of
each configuration, through the benchmark's own check (``check.verify``):
in float32 the port follows the reference to rounding, and the faults of
the adaptation planted in the reference read far above it; in the
configuration's own bfloat16 the float8 control (the reference with every
product's operands in float8, put in the port's place) reads each number
at least three times the port's.  On a card (``cuda`` marker) the control
runs at the cells' own size against the limits that were set from it."""

import pytest

from portbench import calibrate, run
from portbench.tests.conftest import SMALL

F32 = ["--dtype", "float32", "--inner_param_dtype", "float32"]


@pytest.mark.parametrize("cell", ["all.5shot.e20", "dampnet.5shot.e20"])
def test_port_follows_the_reference_in_float32(cell):
    """In float32 the port's scores, banks and first step follow the
    reference to rounding, and its whole adaptation by the norm of each
    leaf's change; each fault planted in the reference put in the port's
    place reads at least three times that."""
    out = calibrate.calibrate(cell, 2**31 + 21, False, True, device="cpu", overrides={**SMALL, "extra_flags": F32})
    r = out["program"]
    assert r["rerun_gap"] == 0.0
    assert r["score_gap"] < 1e-4 and r["bank_err"] < 1e-4 and r["step_flip"] < 1e-3, r
    dnorm = {k: v for k, v in r.items() if k.startswith("dnorm.")}
    assert dnorm and max(dnorm.values()) < 0.05, r
    for fault, readings in out["faults"].items():
        assert all(readings[k] >= 3.0 * v for k, v in dnorm.items()), (fault, readings, r)


@pytest.mark.parametrize("cell", ["all.5shot.e20", "dampnet.5shot.e20"])
def test_the_float8_control_reads_far_above_the_port(cell):
    out = calibrate.calibrate(cell, 2**31 + 22, True, device="cpu", overrides=SMALL)
    for k in ("score_gap", "bank_err", "step_flip"):
        assert out["control"][k] >= 3.0 * out["program"][k] > 0.0, (k, out)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cells' own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["all.5shot.e20", "dampnet.5shot.e20"])
def test_the_control_fails_the_limits_at_full_size(card, cell):
    limits = run.load_cell(cell)["limits"]
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        out = calibrate.calibrate(cell, seed, True)
        assert all(out["program"][k] <= v["limit"] for k, v in limits.items()), out
        assert any(out["control"][k] > v["limit"] for k, v in limits.items()), out
