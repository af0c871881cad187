"""A run with the timed path broken underneath must come out not correct.
Each planted fault drives the whole harness but the look for a card, on the
CPU at a small size in float32 (where a sound run's gaps are far below the
cells' limits), through the cells' own limits:

* a step that returns its state unchanged (the scan hands back its input,
  the eager steps leave the parameters as they were);
* half of each minibatch left out of the inner loss, the mean taken over
  the rest;
* a state frozen after the first step (the scan's Adam and the eager
  loops' leave the parameters as they are from the second step on);
* the Adam bias corrections dropped (in the scan and in the eager loops);
* an answer altered where it is produced (each lane's scores shifted by a
  class);
* on a mesh, the exchange between the shards left out (every shard's answer
  taken from the first shard).
"""

import contextlib
import math
from unittest import mock

import pytest
import torch
from torch.utils import _pytree as pytree

from portbench import run
from portbench.tests.conftest import SMALL
from portbench.tests.test_portbench_harness import _throwaway_root

F32 = {**SMALL, "extra_flags": ["--dtype", "float32", "--inner_param_dtype", "float32"]}


@contextlib.contextmanager
def state_unchanged():
    from mft_tpu_torch.kernels import fused_inner_scan as fis
    from mft_tpu_torch.train import inner_loop

    with mock.patch.object(fis, "fused_inner_scan_lanes", lambda p0, *a, **k: p0), \
            mock.patch.object(inner_loop, "_step", lambda loops, losses: None):
        yield


@contextlib.contextmanager
def half_batch():
    """The second half of each minibatch weighted 0, the loss the mean
    over the rest: in the scan's entry and in the eager steps' loss."""
    from mft_tpu_torch.kernels import fused_inner_scan as fis
    from mft_tpu_torch.train import eval_engine

    own_scan, own_ce = fis.fused_inner_scan_lanes, eval_engine.ce_loss

    def halve(w):
        w = w.clone()
        w[..., (w.shape[-1] + 1) // 2 :] = 0.0
        return w

    def scan(p0, bank, bank_y, idx, w, **kw):
        return own_scan(p0, bank, bank_y, idx, halve(w), **kw)

    def ce(logits, labels, weights=None):
        if weights is None:
            weights = torch.ones(labels.shape[-1], device=logits.device)
        return own_ce(logits, labels, halve(weights))

    with mock.patch.object(fis, "fused_inner_scan_lanes", scan), mock.patch.object(eval_engine, "ce_loss", ce):
        yield


@contextlib.contextmanager
def _eager_adam(change):
    """The eager loops' Adam (either state dtype) with step ``t``'s updates
    passed through ``change(t, updates)``."""
    from mft_tpu_torch.train import optimizers as opt

    def wrap(make):
        def made(*a, **kw):
            tx = make(*a, **kw)

            def update(grads, state, params):
                updates, new = tx.update(grads, state, params)
                return change(new["t"], updates), new

            return opt.Optimizer(tx.init, update)

        return made

    with mock.patch.object(opt, "torch_adam", wrap(opt.torch_adam)), \
            mock.patch.object(opt, "torch_adam_lowmem", wrap(opt.torch_adam_lowmem)):
        yield


@contextlib.contextmanager
def frozen_after_first_step():
    from mft_tpu_torch.kernels import fused_inner_scan as fis

    own = fis.adam_update_reference

    def update(p, mu, nu, g, t, lr, **kw):
        return (p, mu, nu) if t > 1 else own(p, mu, nu, g, t, lr, **kw)

    first_only = lambda t, u: u if t == 1 else pytree.tree_map(torch.zeros_like, u)
    with mock.patch.object(fis, "adam_update_reference", update), _eager_adam(first_only):
        yield


@contextlib.contextmanager
def bias_correction_dropped():
    from mft_tpu_torch.kernels import fused_inner_scan as fis

    uncorrected = lambda t, u: pytree.tree_map(lambda x: x * ((1 - 0.9**t) / math.sqrt(1 - 0.999**t)), u)
    with mock.patch.object(fis, "bias_corrections", lambda t, b1=0.9, b2=0.999: (1.0, 1.0)), \
            _eager_adam(uncorrected):
        yield


@contextlib.contextmanager
def answer_altered():
    from mft_tpu_torch.train import eval_engine

    own = eval_engine.make_eval_program

    def make(**kw):
        program = own(**kw)

        def altered(*a, **k):
            scores, accs = program(*a, **k)
            return scores.roll(1, dims=-1), accs

        return altered

    with mock.patch.object(eval_engine, "make_eval_program", make):
        yield


@contextlib.contextmanager
def exchange_left_out():
    from mft_tpu_torch.parallel import mesh

    own = mesh.ShardPool.map

    def first_only(self, messages):
        answers = own(self, messages)
        return [answers[0]] * len(answers)

    with mock.patch.object(mesh.ShardPool, "map", first_only):
        yield


CELLS = ["dampnet.5shot.e20", "all.5shot.e20"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("plant", [state_unchanged, half_batch, frozen_after_first_step, bias_correction_dropped,
                                   answer_altered])
def test_a_broken_step_is_not_correct(plant, cell):
    res = run.run_cell(cell, 2**31 + 5, 1.0, False, device="cpu", overrides=F32, plant=plant)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_run_is_correct(cell):
    res = run.run_cell(cell, 2**31 + 5, 1.0, False, device="cpu", overrides=F32)
    assert res["correct"], res["checks"]


def test_the_mesh_without_its_exchange_is_not_correct(tmp_path):
    root = _throwaway_root(tmp_path)
    res = run.run_cell("dampnet.tiny.mesh2", 2**31 + 99, 1.0, False, device="cpu", mesh_devices=["cpu", "cpu"],
                       root=root, overrides={"extra_flags": F32["extra_flags"]}, plant=exchange_left_out)
    assert not res["correct"], res["checks"]
