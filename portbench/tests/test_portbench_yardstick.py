"""The benchmark's FLOP and byte counts against figures worked out by hand
(ResNet10 at 224 px, the 5-shot episode)."""

import pytest

from portbench import yardstick


def test_resnet10_flops_per_image():
    r = yardstick.resnet_flops(224)
    assert r["trunk"] + r["final"] == pytest.approx(1.777e9, rel=1e-3)
    assert r["trunk"] == pytest.approx(1.418e9, rel=1e-3)
    # a final-block step at batch 5: forward and the backward of a block on a constant input
    assert 5 * (r["final"] + r["final_bwd"]) == pytest.approx(4.753e9, rel=1e-3)


def test_scan_bound_500_steps():
    b = yardstick.fused_bound(14, 256, 512, 2, 5, 500, carry_bytes=2, bank_bytes=2)
    assert b["ms_tc"] == pytest.approx(2.403, abs=5e-4)
    assert b["ms_bytes"] < b["ms_tc"]  # operations bind it


def test_edge_bound_5shot():
    total = sum(yardstick.edge_bound_ms(15, 30, f, 192)[0] for f in (133, 181, 229))
    assert total == pytest.approx(0.0097, abs=5e-5)
    assert yardstick.edge_bound_ms(15, 30, 133, 192)[1] == "bytes"


@pytest.mark.parametrize("members,head,want", [
    (["linear", "gnn"], {"proj": 128, "nf": 96, "feat": 512}, 3.889e12),
    (["dampnet"], {"proj": 128, "nf": 96, "feat": 512, "ntn": 300, "mlp": 500}, 3.201e12),
])
def test_episode_flops(members, head, want):
    cfg = {"members": members, "linear_epochs": 20, "head": head}
    traffic = {"image_size": 224, "n_way": 5, "n_shot": 5, "n_query": 15, "batch": 5, "gen_examples": 17,
               "fine_tune_epoch": 5}
    assert yardstick.episode_flops(cfg, traffic) == pytest.approx(want, rel=2e-3)


def test_idle_gaps_named_by_open_host_range():
    kernels = [(0, 1.0, "a"), (3000, 1.0, "b"), (10000, 2.0, "c")]  # ns starts, us lengths
    spans = [(500, 2500, "adapt:linear")]
    idle = yardstick._idle_by_host_range(kernels, spans)
    assert idle == {"adapt:linear": pytest.approx(2.0), "driver": pytest.approx(6.0)}
