"""Whole-driver training replay of the port against the committed run of the
reference's own train.py (tests/fixtures/reference_train_e2e.json, written
by tools/run_reference_train_e2e.py): the same staged 64-class tree and the
same seeded starting checkpoint (``make_train_checkpoint``, exported to the
reference ``0.tar`` that the port resumes from with a fresh Adam, as the
reference does), the reference's recorded episodes and minibatches replayed
through ``mft_tpu_torch.cli.train --episode_manifest`` on the CPU, and the
per-episode losses compared under the bounds of
tests/test_reference_train_e2e.py (``TOL_POLICY``, ``FIRST_EPISODE_TOL``).

Tiers: ``plain`` (the episodic stage), ``baseline`` (pretraining),
``fine_tune`` (the meta fine-tune, ``--bn_mode minibatch``, whose inner
minibatch order is the reference's unseeded draw, hence its looser bound)
and ``train50`` (the reference's other training driver, train_50.py: the
compressed 50-shot GnnNet, replayed through ``mft_tpu_torch.cli.train_50``,
which keeps the reference's ``save_freq`` of 10).  Marked ``slow``: minutes
each on the CPU.
"""

import json
import os

import numpy as np
import pytest

from tests.test_reference_train_e2e import FIRST_EPISODE_TOL, TOL_POLICY, fixture, rte, staged  # noqa: F401


def _replay_port(fixture, staged, tier):  # noqa: F811
    from mft_tpu_torch.cli import train, train_50

    roots, root = staged
    run = fixture["runs"][tier]
    ref = run["reference"]
    method = ref["method"]
    is50 = ref.get("driver") == "train_50"
    ckpt_method = "gnnnet50" if is50 else method
    our_save = os.path.join(root, f"port_{tier}")
    ckpt_hash = rte.make_train_checkpoint(os.path.join(root, f"port_jax_{tier}"), our_save, fixture["ckpt_seed"],
                                          ckpt_method)
    if ckpt_hash != fixture[f"ckpt_hash_{ckpt_method}"]:
        pytest.skip("jax PRNG produced different init weights than at fixture generation")
    manifest = os.path.join(root, f"port_manifest_{tier}.json")
    with open(manifest, "w") as f:
        json.dump({"batches": ref["batches"]} if method == "baseline" else {"episodes": ref["episodes"]}, f)
    pj = os.path.join(root, f"port_paths_{tier}.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": our_save, "miniImageNet": roots[tier]}, f)
    argv = ["--device", "cpu", "--method", method, "--dataset", "miniImageNet", "--model", "ResNet10",
            "--start_epoch", str(ref["start_epoch"]), "--stop_epoch", str(ref["stop_epoch"] - 1),
            "--episode_manifest", manifest, "--episode_manifest_root", roots[tier], "--bn_mode", "minibatch",
            "--dtype", "float32", "--paths_json", pj]
    if not is50:  # the 50-shot driver keeps the reference's hard-coded save_freq of 10
        argv += ["--save_freq", "1"]
    if method == "baseline":
        argv += ["--batch_size", str(ref["batch_size"]), "--num_classes", str(rte.NUM_CLASSES)]
    else:
        argv += ["--n_shot", str(ref["n_shot"]), "--n_query", str(ref["n_query"]),
                 "--episodes_per_epoch", str(ref["episodes_per_epoch"])]
        if ref["fine_tune"]:
            argv += ["--fine_tune"]
    res = (train_50 if is50 else train).main(argv)
    per_epoch = ref["batches_per_epoch"] if method == "baseline" else ref["episodes_per_epoch"]
    logged = rte.parse_losses(os.path.join(res.ckpt_dir, "train_log.jsonl"), ref["start_epoch"],
                              ref["stop_epoch"] - 1, per_epoch)
    np.testing.assert_allclose(logged, res.losses, rtol=1e-9)
    r, o = np.asarray(ref["losses"]), np.asarray(res.losses)
    assert len(r) == len(o)
    mult, floor = TOL_POLICY[tier]
    tol = max(run["loss_compare"]["max_abs_delta"] * mult, floor)
    print(f"{tier}: port vs reference max |d loss| = {np.abs(r - o).max():.4e} (bound {tol:.4e}), first "
          f"{abs(r[0] - o[0]):.4e}")
    assert np.abs(r - o).max() <= tol, f"{tier}: max |d|={np.abs(r - o).max():.3e} > {tol:.3e}\nref:  {r}\nport: {o}"
    if tier != "fine_tune":
        assert abs(r[0] - o[0]) <= FIRST_EPISODE_TOL, f"{tier}: first loss ref {r[0]:.6f} vs port {o[0]:.6f}"


@pytest.mark.slow
@pytest.mark.parametrize("tier", ["plain", "baseline", "fine_tune", "train50"])
def test_port_replays_reference_train(fixture, staged, tier):  # noqa: F811
    if tier not in fixture["runs"]:
        pytest.skip(f"fixture has no {tier} tier; rerun tools/run_reference_train_e2e.py")
    _replay_port(fixture, staged, tier)
