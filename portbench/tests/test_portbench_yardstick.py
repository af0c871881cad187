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


@pytest.mark.parametrize("stage_sizes,table_1,counted", [
    ((2, 2, 2, 2), 2 * 1.8e9, 3.627e9),  # ResNet18: 1.8 G multiply-adds
    ((3, 4, 6, 3), 2 * 3.6e9, 7.326e9),  # ResNet34: 3.6 G multiply-adds
])
def test_deeper_resnet_flops_per_image(stage_sizes, table_1, counted):
    """Every block counted, at 224 px, against He et al. 2016
    (arXiv:1512.03385) Table 1's multiply-adds (two FLOPs each; the table
    rounds to 0.1 G and counts the 1000-way classifier, which the eval does
    not run)."""
    r = yardstick.resnet_flops(224, (64, 128, 256, 512), stage_sizes)
    assert r["trunk"] + r["final"] == pytest.approx(table_1, rel=0.03)
    assert r["trunk"] + r["final"] == pytest.approx(counted, rel=1e-3)
    # the final block keeps 7 x 7 x 512 with an identity shortcut: no shortcut weight gradient
    assert r["final"] == 2 * 2.0 * 49 * 512 * 512 * 9 and r["final_bwd"] == 3 * 2.0 * 49 * 512 * 512 * 9


def test_scan_bound_identity_shortcut():
    """ResNet18/34's final block, 500 steps at batch 5, by hand: per step a
    forward of conv1 and conv2 (2 x 9 x 512 x 512 x 245 multiply-adds) and
    a backward of conv2's weight and input gradients and conv1's weight
    gradient (3 x that), no shortcut; 4 x 512 BN parameters."""
    b = yardstick.fused_bound(7, 512, 512, 1, 5, 500, 2, 2)
    per_step = 2.0 * 245 * 512 * 512 * 9 * 5
    assert b["flops"] == per_step * 500
    assert b["ms_tc"] == pytest.approx(2.922, abs=5e-4)
    assert b["params"] == 2 * 9 * 512 * 512 + 4 * 512 == 4_720_640
    assert yardstick.fused_bound(14, 256, 512, 2, 5, 500, 2, 2)["params"] == 3_673_088  # ResNet10's, shortcut kept


def test_episode_flops_follow_the_configured_backbone():
    """``episode_flops`` counts the configuration's backbone: ResNet34's
    episode is ResNet10's plus each image's extra trunk and each step's
    extra final block, counted from ``resnet_flops``."""
    head = {"proj": 128, "nf": 96, "feat": 512}
    traffic = {"image_size": 224, "n_way": 5, "n_shot": 5, "n_query": 15, "batch": 5, "gen_examples": 17,
               "fine_tune_epoch": 5}
    r10 = {"members": ["linear", "gnn"], "linear_epochs": 20, "head": head, "stage_sizes": [1, 1, 1, 1],
           "widths": [64, 128, 256, 512]}
    r34 = {**r10, "stage_sizes": [3, 4, 6, 3]}
    assert yardstick.episode_flops(r10, traffic) == pytest.approx(3.889e12, rel=2e-3)
    a, b = yardstick.resnet_flops(224), yardstick.resnet_flops(224, stage_sizes=(3, 4, 6, 3))
    d = {k: b[k] - a[k] for k in a}
    trunk_images = 25 + 18 * 25  # the linear member's clean support; the GNN member's support and 17 replicas
    steps = 100 + 500
    embedded = 2 * 100  # each member embeds the whole episode
    want = (trunk_images * d["trunk"] + steps * 5 * (d["final"] + d["final_bwd"])
            + embedded * (d["trunk"] + d["final"]))
    assert yardstick.episode_flops(r34, traffic) - yardstick.episode_flops(r10, traffic) == pytest.approx(want, rel=1e-9)
