"""Whole-driver eval replay of the port against the committed run of the
reference's own finetune.py (tests/fixtures/reference_e2e.json, written by
tools/run_reference_e2e.py): the same staged CropDisease tree and the same
seeded checkpoints (``make_checkpoints`` with a ``ref_save``, so the
exporter writes the reference ``.tar`` files that the port reads), the
reference's recorded episodes replayed through ``mft_tpu_torch.cli.finetune
--episode_manifest`` on the CPU in the faithful mode (``--bn_mode
minibatch``, strict f32, ``--gen_examples 0``, as the fixture's own
command), and the per-episode accuracies compared under the bounds of
tests/test_reference_e2e.py (``TOLERANCE``, imported, not copied).

Tiers: ``gnnnet_fte0`` (no inner loop: a deterministic function of the
pixels, the JAX package read 0.00 pp) and ``all_fte1`` (the headline
``--method all`` ensemble, one GNN epoch and the linear member's 20; the
free variable is inner RNG: shuffle order and classifier init).  Marked
``slow``: minutes on the CPU.
"""

import json
import os

import numpy as np
import pytest

from tests.test_reference_e2e import TOLERANCE, fixture, r2e  # noqa: F401


@pytest.fixture(scope="module")
def staged_port(fixture, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("port_ref_e2e")
    data_root = str(root / "CropDisease")
    if r2e.stage_dataset(data_root, **fixture["stage"]) != fixture["data_hash"]:
        pytest.skip("PIL JPEG encoder produced different bytes than at fixture generation; "
                    "regenerate with tools/run_reference_e2e.py")
    ref_save = str(root / "ref_logs")
    if r2e.make_checkpoints(str(root / "jax_logs"), ref_save, fixture["ckpt_seed"]) != fixture["ckpt_hash"]:
        pytest.skip("jax PRNG produced different init weights than at fixture generation; "
                    "regenerate with tools/run_reference_e2e.py")
    pj = str(root / "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": ref_save, "CropDisease": data_root}, f)
    return data_root, pj, str(root)


def _replay_port(fixture, staged_port, key):  # noqa: F811
    from mft_tpu_torch.cli import finetune

    data_root, pj, root = staged_port
    run = fixture["runs"][key]
    ref = run["reference"]
    manifest = os.path.join(root, f"manifest_{key}.json")
    with open(manifest, "w") as f:
        json.dump({"episodes": ref["episodes"]}, f)
    res = finetune.main([
        "--device", "cpu", "--method", run["method"], "--test_dataset", "CropDisease", "--n_shot", "5",
        "--train_aug", "--save_iter", "600", "--fine_tune_epoch", str(run["fine_tune_epoch"]), "--gen_examples", "0",
        "--bn_mode", "minibatch", "--dtype", "float32", "--inner_param_dtype", "float32",
        "--episode_manifest", manifest, "--episode_manifest_root", data_root, "--paths_json", pj,
    ])
    r, o = np.asarray(ref["acc_all"]), np.asarray(res.accs)
    assert len(o) == len(r) == fixture["iter_num"]
    mean_tol, ep_tol = TOLERANCE[key]
    d = np.abs(r - o)
    print(f"{key}: port vs reference |d mean| = {abs(r.mean() - o.mean()):.2f} pp (bound {mean_tol}), max |d episode| = "
          f"{d.max():.2f} pp (bound {ep_tol}); per episode {np.round(d, 2).tolist()}")
    assert abs(r.mean() - o.mean()) <= mean_tol, f"{key}: mean {r.mean():.2f} vs port {o.mean():.2f}"
    assert d.max() <= ep_tol, f"{key}: per-episode |d| {d.max():.2f} pp > {ep_tol}\nref:  {r}\nport: {o}"


@pytest.mark.slow
@pytest.mark.parametrize("key", ["gnnnet_fte0", "all_fte1"])
def test_port_replays_reference_finetune(fixture, staged_port, key):  # noqa: F811
    if key not in fixture["runs"]:
        pytest.skip(f"fixture has no {key} tier; rerun tools/run_reference_e2e.py")
    _replay_port(fixture, staged_port, key)
