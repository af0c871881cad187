"""The dataset and the weights are functions of the seed, and the weights
load through the port's state-dict forms with every tensor placed."""

import numpy as np
import pytest
import torch

from portbench import inputs, run
from portbench.tests.conftest import digest

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


#: sha256 of every model's state dict (and DampNet's prototypes) for seed
#: 2**31 + 41 and 5 ways, recorded with the ResNet10-only layout of before
#: the backbone was read from the configuration
RESNET10_DIGESTS = {"resnet10_gnnnet_all": "5d32a93664d586385555e5489d70fdc303cb7b887a68d83ba51a96dae1dc8302",
                    "resnet10_dampnet_full_class": "19dac4d583b05c32e46df7740a7550b68f909bae523aa45eabd06ce2ceba93b7"}


@pytest.mark.parametrize("config", sorted(RESNET10_DIGESTS))
def test_resnet10_weights_are_drawn_as_before(config):
    cfg = run.load_json(run.HERE, "configs", config + ".json")
    models = inputs.make_models(2**31 + 41, cfg, 5, "cpu")
    pairs = [(f"{n}.{k}", v) for n, m in models.items() for k, v in (m.items() if isinstance(m, dict) else [("", m)])]
    assert digest(pairs) == RESNET10_DIGESTS[config]


@pytest.mark.parametrize("model,blocks,shortcuts", [
    ("ResNet10", 4, [5, 6, 7]),
    ("ResNet18", 8, [6, 8, 10]),
    ("ResNet34", 16, [7, 11, 17]),
])
def test_deeper_resnets_load_through_the_state_dict_forms(model, blocks, shortcuts):
    """Every block of the configuration's backbone at ``feature.trunk.4`` on,
    a 1x1 shortcut exactly where a stage's width changes, and the port's
    state-dict form of ``--model`` takes every tensor (strict)."""
    from mft_tpu_torch.models import backbone as bb

    bcfg = bb.MODEL_REGISTRY[model]()
    cfg = {**run.load_json(run.HERE, "configs", "resnet10_gnnnet_all.json"), "stage_sizes": list(bcfg.stage_sizes),
           "models": {"baseline": ["resnet"]}}
    sd = inputs.make_models(3, cfg, 5, "cpu")["baseline"]
    idx = sorted({int(k.split(".")[2]) for k in sd if k.startswith("feature.trunk.")} - {0, 1})
    assert idx == list(range(4, 4 + blocks))
    assert sorted({int(k.split(".")[2]) for k in sd if ".shortcut." in k}) == shortcuts
    assert set(run.program_models({"baseline": sd}, cfg, bcfg, "cpu")) == {"baseline"}


def test_a_configuration_must_state_its_backbone():
    cfg = run.load_json(run.HERE, "configs", "resnet10_gnnnet_all.json")
    with pytest.raises(ValueError, match="states no stage_sizes"):
        inputs.make_models(3, {k: v for k, v in cfg.items() if k != "stage_sizes"}, 5, "cpu")
    with pytest.raises(ValueError, match="zip"):
        inputs.make_models(3, {**cfg, "stage_sizes": [1, 1, 1]}, 5, "cpu")
