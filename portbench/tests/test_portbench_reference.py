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
from portbench.tests.conftest import SMALL, digest

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


#: sha256 of the reference ResNet10's ``trunk`` and ``final`` outputs (one
#: thread, float32, two BN groups) on the ``gnn`` weights of
#: ``resnet10_gnnnet_all`` for seed 2**31 + 41 and a seeded 4 x 3 x 32 x 32
#: input, recorded with the ResNet10-only class of before the backbone was
#: read from the configuration
RESNET10_OUTPUTS = {"trunk": "b3d70fc252bbe786e9bbea7e00d55ff39c631391346dac2a2fb79096c85403cf",
                    "final": "6899e4f4fdf837664db2b50d8aed69f32a7aa566d550fad8a070649e6de9b1e8"}


def test_the_reference_resnet10_computes_as_before():
    import torch

    from portbench import inputs
    from portbench.reference.nets import Precision, ResNet

    cfg = run.load_json(run.HERE, "configs", "resnet10_gnnnet_all.json")
    sd = inputs.make_models(2**31 + 41, cfg, 5, "cpu")["gnn"]
    x = torch.rand((4, 3, 32, 32), generator=torch.Generator().manual_seed(2**31 + 43))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        net = ResNet(sd, Precision("float32"), (1, 1, 1, 1), (64, 128, 256, 512))
        fmap = net.trunk(x, groups=2)
        feats = net.final(net.block_params(net.final_index), fmap, groups=2)
    finally:
        torch.set_num_threads(threads)
    assert net.final_index == 7 and tuple(fmap.shape) == (4, 256, 2, 2) and tuple(feats.shape) == (4, 512)
    assert {"trunk": digest([("trunk", fmap)]), "final": digest([("final", feats)])} == RESNET10_OUTPUTS


@pytest.mark.parametrize("stage_sizes,strides", [
    ((1, 1, 1, 1), [1, 2, 2, 2]),
    ((2, 2, 2, 2), [1, 1, 2, 1, 2, 1, 2, 1]),
    ((3, 4, 6, 3), [1, 1, 1, 2, 1, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1]),
])
def test_the_reference_resnet_follows_its_stage_sizes(stage_sizes, strides):
    """Every block at ``feature.trunk.4`` on, half resolution at each later
    stage's first block, the final block at its own stride (2 for ResNet10,
    1 for ResNet18/34); a state dict of another shape is refused."""
    import torch

    from portbench import inputs
    from portbench.reference.nets import Precision, ResNet

    widths = (64, 128, 256, 512)
    cfg = {**run.load_json(run.HERE, "configs", "resnet10_gnnnet_all.json"), "stage_sizes": list(stage_sizes),
           "models": {"baseline": ["resnet"]}}
    sd = inputs.make_models(5, cfg, 5, "cpu")["baseline"]
    net = ResNet(sd, Precision("float32"), stage_sizes, widths)
    assert net.blocks == [(4 + k, s) for k, s in enumerate(strides)] and net.final_index == 3 + len(strides)
    x = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(9))
    fmap = net.trunk(x)
    assert tuple(fmap.shape) == ((2, 256, 2, 2) if strides[-1] == 2 else (2, 512, 1, 1))
    assert tuple(net.final(net.block_params(net.final_index), fmap).shape) == (2, 512)
    other = (1, 1, 1, 1) if stage_sizes != (1, 1, 1, 1) else (2, 2, 2, 2)
    with pytest.raises(ValueError, match="not a block|more blocks"):
        ResNet(sd, Precision("float32"), other, widths)
