"""Learning dynamics of the port (tests/test_learning.py's two cases): the
episodic losses can be minimised end to end, which single-step parity with
the JAX package cannot show (label plumbing, gradient flow).

The GnnNet head (``gnn_scores`` -> ``gnnnet_loss``) sits at a chance-level
plateau before it fits even trivially separable features; ProtoNet's
projector fits at once.  The features come from a ``torch.Generator``, the
steps are the training steps' ``_value_and_grad`` and ``torch_adam``, and
the bounds are the JAX tests' own.
"""

import pytest
import torch

from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.methods import gnnnet as gn
from mft_tpu_torch.methods.protonet import proto_scores, protonet_loss
from mft_tpu_torch.train import optimizers as opt
from mft_tpu_torch.train.steps import _apply, _value_and_grad


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _episode_features(gen, n_way, slots, dim, sep=2.0, noise=0.3):
    centers = torch.randn((n_way, 1, dim), generator=gen) * sep
    return centers + torch.randn((n_way, slots, dim), generator=gen) * noise


def _fit(loss_of, features, params, tx, n_steps, gen):
    """``n_steps`` Adam steps, each on a fresh episode's ``features(gen)``; the losses."""
    state, losses = tx.init(params), []
    for _ in range(n_steps):
        z = features(gen)
        loss, _, grads = _value_and_grad(lambda p: (loss_of(p, z), None), params)
        params, state = _apply(tx, params, grads, state)
        losses.append(float(loss))
    return torch.tensor(losses)


def test_gnn_head_fits_separable_features():
    cfg = gn.GnnNetCfg(feat_dim=16, n_way=3, n_support=3, proj_dim=32, gnn_nf=16)
    spec = EpisodeSpec(3, 3, 4)
    head = gn.init_head(torch.Generator().manual_seed(0), cfg)

    def loss_of(h, z):
        return gn.gnnnet_loss(gn.gnn_scores(h, z, cfg, spec.n_query), 3, spec.n_query)

    losses = _fit(loss_of, lambda g: _episode_features(g, 3, 7, 16), head, opt.torch_adam(2e-3), 900,
                  torch.Generator().manual_seed(1))
    assert losses[:20].mean() > 0.7  # starts near chance (ln 3 ~ 1.1)
    assert losses[-50:].mean() < 0.35, f"GNN head failed to fit: tail loss {losses[-50:].mean():.3f}"


def test_protonet_fits_separable_features_fast():
    spec = EpisodeSpec(3, 3, 4)

    def loss_of(w, z):
        p = z @ w
        return protonet_loss(proto_scores(p[:, :3], p[:, 3:], spec), spec)

    # weak separation so the identity projector starts lossy
    features = lambda g: _episode_features(g, 3, 7, 16, sep=0.25, noise=1.0)
    losses = _fit(loss_of, features, torch.eye(16), opt.torch_adam(1e-2), 120, torch.Generator().manual_seed(2))
    assert losses[-20:].mean() < losses[:5].mean(), f"{losses[:5]} -> {losses[-20:].mean()}"
