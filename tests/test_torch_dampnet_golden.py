"""The port's DampNet against the reference's own runs: the eight DampNet
goldens of tests/fixtures/golden_reference.npz, at the JAX tests' own
tolerances (tests/test_golden_reference.py:219, 238, 262, 368, 393, 420,
1093, 1174).

The fixture's state dicts load straight into the port
(``convert.from_state_dict`` / ``convert.heads_from_state_dict``); the
gradient fixtures map through the same (linear) layout as the parameters.
The f64 goldens run the port in f64, the f32 ones in f32.
"""

import os

import numpy as np
import pytest
import torch

from mft_tpu_torch import convert
from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.methods import dampnet as dn
from mft_tpu_torch.methods.baseline import classifier_logits
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.ops.augment import AugmentCfg
from mft_tpu_torch.train import eval_engine as ee
from mft_tpu_torch.train import steps
from mft_tpu_torch.train.inner_loop import InnerLoopCfg, schedule_from_perms
from mft_tpu_torch.utils.checkpoint import keyed

HERE = os.path.dirname(__file__)
TINY = bb.ResNetCfg((1, 1, 1, 1), (8, 12, 14, 16))
F64 = torch.float64
CFG = dn.DampNetCfg(feat_dim=16, n_way=3, n_support=2, stat="class")
MODULES = ("feature.", "fc.", "gnn.", "trunk.") + tuple(m + "." for m in convert.DAMPNET_MODULES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g():
    with np.load(os.path.join(HERE, "fixtures", "golden_reference.npz")) as z:
        return {k: z[k] for k in z.files if k.startswith(("dampnet.", "dunsup.", "dadapt.", "dproto.", "dcorrupt.",
                                                         "dtrain.", "ftdamp"))}


def _sd(g, prefix, rename=""):
    n = len(prefix) + 1
    return {rename + k[n:]: torch.from_numpy(np.asarray(v)) for k, v in g.items()
            if k.startswith(prefix + ".") and k[n:].startswith(MODULES)}


def _heads(g, prefix, dtype=torch.float32, grads=None):
    sd = _sd(g, prefix)
    if grads is not None:
        sd.update(_sd(g, grads))
    return convert.heads_from_state_dict(sd, dtype=dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _state(g, prefix, dtype=torch.float32, **extra):
    return {"proto_mean": _t(g[f"{prefix}.proto_mean"], dtype), "proto_std": _t(g[f"{prefix}.proto_std"], dtype),
            "initialized": torch.ones((), dtype=torch.bool), **extra}


def _close_tree(got, want, rtol, atol_frac, label):
    got, want = keyed(got), keyed(want)
    assert sorted(got) == sorted(want), (label, sorted(set(got) ^ set(want)))
    for k, b in want.items():
        b = b.numpy()
        np.testing.assert_allclose(got[k].detach().numpy(), b, rtol=rtol,
                                   atol=atol_frac * (float(np.abs(b).max()) or 1.0) + 1e-9, err_msg=f"{label}{k}")


def test_dampnet_domain_shift_golden(g):
    """set_forward(x, is_feature=True, domain_shift=True) of
    dampnet_full_class.py:262-352."""
    scores = dn.dampnet_scores(_heads(g, "dampnet"), _state(g, "dampnet"), _t(g["dampnet.feats"]), CFG, 15,
                               mode="domain_shift")
    np.testing.assert_allclose(scores.detach().numpy(), g["dampnet.scores"], rtol=1e-3, atol=1e-4)


def test_dampnet_unsup_golden(g):
    """set_forward_unsup (dampnet_full_class.py:355-402)."""
    scores = dn.dampnet_scores(_heads(g, "dampnet"), _state(g, "dampnet"), _t(g["dunsup.feats"]), CFG, 15, mode="unsup",
                               unsup_stats=(_t(g["dunsup.x_u_mean"]), _t(g["dunsup.x_u_std"])))
    np.testing.assert_allclose(scores.detach().numpy(), g["dunsup.scores"], rtol=1e-3, atol=1e-4)


def test_dampnet_adaptation_full_golden(g):
    """set_forward_adaptation_full (dampnet_full_class.py:471-548): the
    100-epoch batch-4 probe with the reference's SGD on the recovered
    projections, its recorded permutations (4 + 2 ragged) and init; f64."""
    spec = EpisodeSpec(3, 2, 15)
    state = _state(g, "dampnet", F64)
    head0 = {"w": _t(g["dadapt.clf.weight"], F64), "b": _t(g["dadapt.clf.bias"], F64)}
    sched = schedule_from_perms(g["dadapt.perms"], InnerLoopCfg(epochs=100, batch_size=4, bank_size=6))
    head, z_query = ee.dampnet_probe(_heads(g, "dampnet", F64), state, _t(g["dadapt.feats"], F64), None, dcfg=CFG,
                                     spec=spec, schedule=sched, head0=head0)
    np.testing.assert_allclose(classifier_logits(head, z_query).numpy(), g["dadapt.scores"], rtol=1e-6, atol=1e-8)


def _proto_state(g, count):
    return _state(g, "dproto", store_mean=_t(g["dproto.store_mean"]), store_std=_t(g["dproto.store_std"]),
                  count=torch.tensor(count, dtype=torch.int32))


@pytest.mark.parametrize("mode,key", [("plain", "scores_plain"), ("recover", "scores_recover"),
                                      ("domain_shift", "scores_ds")])
def test_dampnet_prototype_branches_golden(g, mode, key):
    """The prototype variant's set_forward (methods/dampnet.py): the plain
    branch with the mean-center / L2-norm projection (:121-137), the
    store-driven recover branch (:210-249), the domain-shift eval (:250-291)."""
    cfg = dn.prototype_cfg(feat_dim=16, n_way=3, n_support=2)
    scores = dn.dampnet_scores(_heads(g, "dproto"), _proto_state(g, 152), _t(g["dproto.feats"]), cfg, 15, mode=mode)
    np.testing.assert_allclose(scores.detach().numpy(), g[f"dproto.{key}"], rtol=1e-3, atol=1e-4)


def test_dampnet_prototype_corrupt_golden(g):
    """The prototype variant's corrupt branch (dampnet.py:138-209) with the
    reference's recorded corruption replayed through ``corrupt_x``."""
    cfg = dn.prototype_cfg(feat_dim=16, n_way=3, n_support=2)
    scores = dn.dampnet_scores(_heads(g, "dproto"), _proto_state(g, 151), _t(g["dproto.feats"]), cfg, 15,
                               mode="corrupt", corrupt_x=_t(g["dproto.corrupt_x"]))
    np.testing.assert_allclose(scores.detach().numpy(), g["dproto.scores_corrupt"], rtol=1e-3, atol=1e-4)


def test_dampnet_corrupt_backward_golden(g):
    """dampnet_full_class's corrupt training step's backward
    (dampnet_full_class.py:145-218), its corruption replayed; only fc[0] is
    frozen (its gradient exactly 0); f64."""
    params = _heads(g, "dcorrupt", F64)
    state = _state(g, "dcorrupt", F64)

    def loss_fn(p):
        s = dn.dampnet_scores(p, state, _t(g["dcorrupt.feats"], F64), CFG, 5, mode="corrupt",
                              corrupt_x=_t(g["dcorrupt.corrupt_x"], F64))
        return dn.dampnet_loss(s, 3, 5), None

    loss, _, grads = steps._value_and_grad(loss_fn, params)
    np.testing.assert_allclose(float(loss), float(g["dcorrupt.loss"]), rtol=1e-9)
    assert all(float(v.abs().max()) == 0.0 for v in grads["fc"]["linear"].values())
    gv = dict(g)
    gv["dcorrupt.grad.fc.0.weight"] = np.zeros_like(g["dcorrupt.fc.0.weight"])
    gv["dcorrupt.grad.fc.0.bias"] = np.zeros_like(g["dcorrupt.fc.0.bias"])
    want = _heads(gv, "dcorrupt", F64, grads="dcorrupt.grad")
    assert float(want["fc"]["bn"]["scale"].abs().max()) > 0 and float(want["layer1"]["w"].abs().max()) > 0
    _close_tree(grads, want, 1e-6, 1e-8, "grad")


def test_dampnet_train_backward_golden(g):
    """The DampNet episodic train step's backward through the 'plain' branch
    (train_loop_full, dampnet_full_class.py:425-447): backbone, fc, GNN; f64."""
    params, stats = convert.from_state_dict(_sd(g, "dtrain"), TINY, dtype=F64)
    x = torch.from_numpy(np.random.RandomState(987).rand(21, 3, 224, 224))

    def loss_fn(p):
        feats, _ = bb.apply_backbone(p["feature"], stats, x, cfg=TINY, train=True, update_stats=True)
        head = {k: v for k, v in p.items() if k != "feature"}
        return dn.dampnet_loss(dn.dampnet_scores(head, None, feats.reshape(3, 7, -1), CFG, 5, mode="plain"), 3, 5), None

    loss, _, grads = steps._value_and_grad(loss_fn, params)
    np.testing.assert_allclose(float(loss), float(g["dtrain.loss"]), rtol=1e-9)
    sd = _sd(g, "dtrain")
    sd.update(_sd(g, "dtrain.grad"))
    want, _ = convert.from_state_dict(sd, TINY, dtype=F64)
    # the fixture records the gradients of the backbone, fc and GNN (the
    # plain branch never reaches the recovery network)
    _close_tree({k: grads[k] for k in ("feature", "fc", "gnn")}, {k: want[k] for k in ("feature", "fc", "gnn")},
                1e-6, 1e-8, "grad")
    assert all(float(v.abs().max()) == 0.0 for k in convert.DAMPNET_MODULES for v in keyed(grads[k]).values())


def test_dampnet_finetune_e2e_golden(g):
    """The live eval composition, the reference's finetune(..., ds=True)
    (finetune.py:182-328, the ds branch :313-314): bank, one epoch of the
    inner Adam on the last block (recorded permutations), then domain-shift
    scores of the adapted features; bf16 Adam moments as the JAX test."""
    params, stats = convert.from_state_dict(_sd(g, "ftdamp_base", rename="feature."), TINY)
    spec = EpisodeSpec(3, 2, 15)
    rs = np.random.RandomState(456)
    x_clean = rs.rand(3, 17, 3, 224, 224).astype(np.float32)
    x_aug = x_clean.copy()
    x_aug[:, :2] = rs.rand(3, 2, 3, 224, 224).astype(np.float32)
    sup, aug_sup = x_clean[:, :2], x_aug[:, :2]
    bank = torch.from_numpy(np.stack([sup, sup, sup, aug_sup]))
    sched = schedule_from_perms(g["ftdamp.perms"], InnerLoopCfg(epochs=1, batch_size=5, bank_size=24))
    scores = ee.dampnet_member_scores(params["feature"], stats, _heads(g, "dampnet"), _state(g, "dampnet"),
                                      torch.from_numpy(x_clean), bank, None, bcfg=TINY, dcfg=CFG, spec=spec,
                                      tcfg=ee.TransferCfg(fine_tune_epochs=1, bn_mode="minibatch"),
                                      aug_cfg=AugmentCfg(image_size=224), gen_examples=1, inner_schedule=sched)
    np.testing.assert_allclose(scores.numpy(), g["ftdamp.scores"], rtol=2e-3, atol=2e-3)
