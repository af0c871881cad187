"""The port's eval driver with episode lanes (``--eval_batch``) and its
other flags, on the CPU at 32 px with the seeded random checkpoints of
``chip_smoke.write_checkpoints``:

* ``--eval_batch 3`` over 4 episodes (a full batch and a short one) gives
  the per-episode accuracies of ``--eval_batch 1`` and scores within 1e-5,
  strict f32.  The runs take the GNN member with ``--inner_scan fused``
  (the main path's), whose plain version steps each lane alone on the CPU,
  so only the bank, embed and score phases see the lanes' batched sums.
  An eager inner loop would not hold 1e-5 in f32: its lanes' grouped
  convolution sums in another order than one episode's convolution (2.6e-6
  apart at one step), and Adam's first steps move each weight by about lr
  whatever a gradient's size, which carried that to 1.2e-3 in the scores
  after 20 steps (measured here); the eager members' lanes are held to
  their single episodes in f64 in tests/test_torch_eval_lanes.py;
* ``--episode_cache``: the first run writes one ``.npy`` per episode, the
  second reads them without decoding and gives the same accuracies;
* ``--trace_dir`` writes a Chrome trace; ``eval_log.jsonl`` holds one
  record per episode and the run's; ``--freeze_backbone`` runs;
* every flag of ``mft_tpu.cli.finetune`` parses, and the engine's four
  knobs (``--ensemble_fuse``, ``--fanout_group_pass``, ``--inner_gather``,
  ``--inner_carry``) reach ``TransferCfg``.
"""

import argparse
import glob
import json
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from mft_tpu_torch import config as tcfg_mod
from mft_tpu_torch.cli import finetune
from mft_tpu_torch.data import pipeline
from mft_tpu_torch.train import eval_engine as ee


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    import chip_smoke

    d = tmp_path_factory.mktemp("ckpts")
    return chip_smoke.write_checkpoints(torch, str(d)), str(d)


def _argv(pj, *extra):
    return ["--device", "cpu", "--method", "gnnnet", "--train_aug", "--save_iter", "600", "--use_pallas",
            "--inner_scan", "fused", "--test_dataset", "synthetic", "--image_size", "32", "--n_shot", "5", "--n_query",
            "1", "--gen_examples", "1", "--fine_tune_epoch", "1", "--iter_num", "4", "--dtype", "float32",
            "--inner_param_dtype", "float32", "--paths_json", pj, *extra]


def _run(argv):
    """The driver's result and every episode's scores, in order."""
    seen = []
    make = ee.make_eval_program

    def spy(**kw):
        program = make(**kw)

        def run(models, base, gens):
            scores, accs = program(models, base, gens)
            seen.extend(scores)
            return scores, accs

        return run

    with mock.patch.object(ee, "make_eval_program", spy):
        res = finetune.main(argv)
    return res, torch.stack(seen).numpy()


def test_eval_batch_lanes_equal_one_episode_batches(ckpts, capsys):
    pj, _ = ckpts
    one, s1 = _run(_argv(pj, "--eval_batch", "1"))
    lanes, s3 = _run(_argv(pj, "--eval_batch", "3"))
    out = capsys.readouterr().out
    assert "4 Test Acc = " in out and "episodes/sec = " in out
    assert len(lanes.batch_seconds) == 2 and len(one.batch_seconds) == 4 and len(lanes.seconds) == 4
    assert lanes.seconds[0] == pytest.approx(lanes.batch_seconds[0] / 3)
    assert lanes.accs == one.accs
    np.testing.assert_allclose(s3, s1, atol=1e-5)
    assert tcfg_mod.parse_finetune_args([]).eval_batch == 5


def test_episode_cache_trace_and_eval_log(ckpts, tmp_path):
    pj, save_dir = ckpts
    cache, trace = str(tmp_path / "cache"), str(tmp_path / "trace")
    log = os.path.join(save_dir, "eval_log.jsonl")
    if os.path.exists(log):
        os.remove(log)
    argv = _argv(pj, "--eval_batch", "2", "--iter_num", "2", "--episode_cache", cache)
    first = finetune.main(argv + ["--trace_dir", trace])
    files = glob.glob(os.path.join(cache, "*", "ep*.npy"))
    assert len(files) == 2 and not glob.glob(os.path.join(cache, "*", "*.tmp.npy"))
    with mock.patch.object(pipeline, "_decode_many", side_effect=AssertionError("the cache must serve every episode")):
        second = finetune.main(argv)
    assert second.accs == first.accs
    traces = glob.glob(os.path.join(trace, "*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    episodes = [r for r in recs if r["kind"] == "episode"]
    evals = [r for r in recs if r["kind"] == "eval"]
    assert [r["index"] for r in episodes] == [0, 1, 0, 1] and [r["acc"] for r in episodes[:2]] == first.accs
    assert len(evals) == 2 and evals[0]["episodes"] == 2 and evals[0]["eps_per_sec"] > 0
    frozen = finetune.main(argv + ["--freeze_backbone", "--iter_num", "1"])
    assert len(frozen.accs) == 1 and 0.0 <= frozen.accs[0] <= 100.0


def _flags(parse, *args):
    """The option strings of the parser that ``parse(*args)`` builds."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        seen.setdefault("parser", self)
        return orig(self, [] if argv is None else argv, namespace)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        parse(*args)
    return {o for act in seen["parser"]._actions for o in act.option_strings}


def test_every_flag_of_the_jax_driver_parses():
    """The port's eval parser defines every option of the JAX driver's
    (``mft_tpu.config.parse_args('train')``, which ``mft_tpu.cli.finetune``
    calls), and ``--eval_batch`` must be positive."""
    from mft_tpu import config as jcfg

    assert _flags(jcfg.parse_args, "train", []) - _flags(tcfg_mod.parse_finetune_args, []) == set()
    a = tcfg_mod.parse_finetune_args(["--freeze_backbone", "--episode_cache", "c", "--trace_dir", "t", "--fine_tune",
                                      "--stop_epoch", "3", "--episode_batch", "2"])
    assert (a.freeze_backbone, a.episode_cache, a.trace_dir, a.eval_batch) == (True, "c", "t", 5)
    with pytest.raises(SystemExit):
        tcfg_mod.parse_finetune_args(["--eval_batch", "0"])
    assert tcfg_mod.parse_train_args(["--episode_cache", "c"]).episode_cache == "c"


@pytest.mark.parametrize("knobs", [("--ensemble_fuse", "lane", "--fanout_group_pass", "2"),
                                   ("--inner_gather", "epoch", "--inner_carry", "flat")])
def test_engine_knob_flags_reach_the_transfer_cfg(ckpts, knobs):
    """The engine's knobs reach ``TransferCfg`` from the command line (the
    defaults when not given).  That each gives its default's numbers is held
    in f64 in tests/test_torch_eval_knobs.py: in f32 a knob's other summation
    order, carried through Adam's first steps, parts the scores by some 5e-3
    (measured on the CPU at this file's sizes, eager ``--method all`` lanes)."""
    pj, _ = ckpts
    seen = []

    def spy(**kw):
        seen.append(kw["tcfg"])
        return lambda models, base, gens: (None, [0.0] * len(gens))

    names = ("ensemble_fuse", "fanout_group_pass", "inner_gather", "inner_carry")
    argv = [a for a in _argv(pj, "--method", "all", "--inner_scan", "eager", "--eval_batch", "2", "--iter_num", "2")
            if a not in ("--train_aug", "--save_iter", "600")]  # the ensemble's own checkpoint rule
    with mock.patch.object(ee, "make_eval_program", spy):
        finetune.main(argv)
        finetune.main(argv + list(knobs))
    default, knobbed = ({k: getattr(t, k) for k in names} for t in seen)
    assert default == {k: getattr(ee.TransferCfg(), k) for k in names}
    given = dict(zip(knobs[::2], knobs[1::2]))
    assert {k: str(v) for k, v in knobbed.items() if f"--{k}" in given} == {k[2:]: v for k, v in given.items()}
    assert {k: v for k, v in knobbed.items() if f"--{k}" not in given} == {k: v for k, v in default.items()
                                                                              if f"--{k}" not in given}
