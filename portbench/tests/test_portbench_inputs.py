"""The dataset and the weights are functions of the seed, and the weights
load through the port's state-dict forms with every tensor placed."""

import numpy as np
import pytest
import torch

from portbench import inputs, run

DATA = {"classes": 4, "per_class": 3, "base_size": 36}


def test_dataset_is_a_function_of_the_seed():
    a, la = inputs.make_dataset(2**31 + 7, DATA)
    b, lb = inputs.make_dataset(2**31 + 7, DATA)
    c, _ = inputs.make_dataset(2**31 + 8, DATA)
    assert a.dtype == np.uint8 and a.shape == (12, 36, 36, 3)
    assert np.array_equal(a, b) and np.array_equal(la, lb) and not np.array_equal(a, c)
    assert list(la) == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]


@pytest.mark.parametrize("config", ["resnet10_gnnnet_all", "resnet10_dampnet_full_class"])
def test_weights_are_a_function_of_the_seed(config):
    cfg = run.load_json(run.HERE, "configs", config + ".json")
    a = inputs.make_models(5, cfg, 5, "cpu")
    b = inputs.make_models(5, cfg, 5, "cpu")
    c = inputs.make_models(6, cfg, 5, "cpu")
    assert a.keys() == b.keys() == set(cfg["models"]) | ({"proto_mean", "proto_std"} if "dampnet" in a else set())
    for name in cfg["models"]:
        assert all(torch.equal(a[name][k], b[name][k]) for k in a[name])
        assert any(not torch.equal(a[name][k], c[name][k]) for k in a[name] if a[name][k].is_floating_point())


@pytest.mark.parametrize("config", ["resnet10_gnnnet_all", "resnet10_dampnet_full_class"])
def test_weights_load_through_the_state_dict_forms(config):
    from mft_tpu_torch.models import backbone as bb

    cfg = run.load_json(run.HERE, "configs", config + ".json")
    sds = inputs.make_models(3, cfg, 5, "cpu")
    models = run.program_models(sds, cfg, bb.resnet10(), "cpu")  # strict: every tensor placed
    assert set(models) == set(cfg["models"])
    conv = sds[next(iter(cfg["models"]))]["feature.trunk.7.C2.weight"]
    assert conv.std().item() == pytest.approx((2.0 / (9 * 512)) ** 0.5, rel=0.02)
