"""Feature-based episodic test driver of the port (counterpart of
``mft_tpu/cli/test.py``).

The upstream cdfsl-benchmark ``test.py`` stage (absent from the reference;
its flags remain at io_utils.py:41-47, its data path at
data/feature_loader.py): sample episodes from the features
``cli.save_features`` wrote, score each with the ProtoNet prototypes or,
with ``--adaptation``, the frozen-feature linear probe of
meta_template.set_forward_adaptation (100 epochs of batch 4 with the
reference's SGD, meta_template.py:153-186), and report mean +-
1.96*std/sqrt(n).  ``--eval_batch`` episodes are probed together as lanes
of one ``inner_fit`` (the JAX program vmaps them); each lane draws its head
and its minibatch order from its own generator, seeded by its index.

Run: ``python -m mft_tpu_torch.cli.test --dataset miniImageNet --method
baseline --split novel --adaptation``
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from mft_tpu_torch import config as cfg_mod
from mft_tpu_torch import resolve_device
from mft_tpu_torch.cli.save_features import features_path
from mft_tpu_torch.core.episode import EpisodeSpec, support_labels
from mft_tpu_torch.data.feature_store import load_features, sample_feature_episode
from mft_tpu_torch.methods.baseline import ce_loss, classifier_logits, init_classifier
from mft_tpu_torch.methods.protonet import proto_scores
from mft_tpu_torch.train.eval_engine import lane_accuracies, mean_ci95
from mft_tpu_torch.train.inner_loop import InnerLoopCfg, inner_fit
from mft_tpu_torch.train.optimizers import reference_probe_sgd


class TestResult(NamedTuple):
    mean: float
    ci95: float
    accs: list
    #: host seconds of each batch of --eval_batch episodes
    batch_seconds: list


def make_probe_program(spec: EpisodeSpec, feat_dim: int, adaptation: bool):
    """``fn(feats [E, n_way, s+q, feat], gens, *, head0=None,
    schedule=None) -> accs [E]`` (percent): without ``adaptation`` the
    ProtoNet scores of each episode; with it, a linear head per episode
    (``init_classifier`` with a random bias, drawn from that lane's
    generator, then its minibatch order) trained for 100 epochs of batch 4
    by ``reference_probe_sgd(0.01)`` on the support features, then the
    queries' logits.  ``head0`` (lane-stacked ``{"w" [E, n_way, feat], "b"
    [E, n_way]}``) and ``schedule`` (``(idx [E, T, 4], w [T, 4])``) replace
    the draws."""

    def program(feats: torch.Tensor, gens, *, head0=None, schedule=None):
        lanes, ns, dev = feats.shape[0], spec.n_support, feats.device
        if not adaptation:
            return lane_accuracies(proto_scores(feats[:, :, :ns], feats[:, :, ns:], spec), spec)
        z_support = feats[:, :, :ns].reshape(lanes, spec.support_size, feat_dim)
        z_query = feats[:, :, ns:].reshape(lanes, spec.query_size, feat_dim)
        y = support_labels(spec, dev)
        if head0 is None:
            heads = [init_classifier(g, feat_dim, spec.n_way, zero_bias=False, dtype=feats.dtype, device=dev)
                     for g in gens]
            head0 = {k: torch.stack([h[k] for h in heads]) for k in heads[0]}
        rows = torch.arange(lanes, device=dev)[:, None]

        def loss_fn(p, idx, w):
            return ce_loss(classifier_logits(p, z_support[rows, idx]), y[idx], w)

        icfg = InnerLoopCfg(epochs=100, batch_size=4, bank_size=spec.support_size)
        head = inner_fit(loss_fn, head0, reference_probe_sgd(0.01), gens, icfg, schedule=schedule, device=dev)
        with torch.no_grad():
            return lane_accuracies(classifier_logits(head, z_query), spec)

    return program


def main(argv=None) -> TestResult:
    a = cfg_mod.parse_features_args("test", argv)
    device = resolve_device(a.device)
    paths = cfg_mod.Paths.load(a.paths_json)
    cl_data = load_features(features_path(a, paths))
    feat_dim = next(iter(cl_data.values())).shape[1]
    spec = EpisodeSpec(a.test_n_way, a.n_shot, 15)
    program = make_probe_program(spec, feat_dim, adaptation=a.adaptation)
    # the JAX driver's episode stream: Philox keyed by --seed, E episodes a batch, the last batch's extra ones dropped
    rs = np.random.Generator(np.random.Philox(key=a.seed))
    accs, batch_seconds = [], []
    for b in range(-(-a.iter_num // a.eval_batch)):
        eps = np.stack([sample_feature_episode(cl_data, spec.n_way, spec.n_support, spec.n_query, rs)[0]
                        for _ in range(a.eval_batch)])
        gens = [torch.Generator().manual_seed(a.seed * 1_000_003 + b * a.eval_batch + j) for j in range(len(eps))]
        t0 = time.perf_counter()
        accs += program(torch.from_numpy(eps).to(device), gens)
        batch_seconds.append(time.perf_counter() - t0)
    accs = accs[: a.iter_num]
    mean, ci = mean_ci95(np.asarray(accs))
    print("%d Test Acc = %4.2f%% +- %4.2f%%" % (len(accs), mean, ci))
    return TestResult(mean, ci, accs, batch_seconds)


if __name__ == "__main__":
    main(sys.argv[1:])
