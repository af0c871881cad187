"""Inner-loop adaptation engine (port of ``mft_tpu/train/inner_loop.py``).

Every adaptation loop has one shape: for E epochs, a fresh permutation of a
fixed bank, walked in minibatches whose last one may be short, one optimizer
step per minibatch.  The schedule is precomputed as static ``[T, B]`` index
and weight tensors: the ragged last minibatch is padded with bank row 0 at
weight 0, so every step has the same shapes (no host sync, and the loop can
later be captured as one CUDA graph).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree


class InnerLoopCfg(NamedTuple):
    epochs: int
    batch_size: int
    bank_size: int

    @property
    def steps_per_epoch(self) -> int:
        return math.ceil(self.bank_size / self.batch_size)

    @property
    def n_steps(self) -> int:
        return self.epochs * self.steps_per_epoch

    @property
    def padded(self) -> int:
        return self.steps_per_epoch * self.batch_size


def schedule_from_perms(perms: torch.Tensor, cfg: InnerLoopCfg, device="cpu"):
    """``(idx [T, B] int64, w [T, B] f32)`` from explicit per-epoch
    permutations ``[epochs, bank_size]``; pad rows gather row 0 at weight 0
    (inner_loop.py:63-66)."""
    perms = torch.as_tensor(perms, dtype=torch.int64)
    if tuple(perms.shape) != (cfg.epochs, cfg.bank_size):
        raise ValueError(f"perms shape {tuple(perms.shape)} != {(cfg.epochs, cfg.bank_size)}")
    pad = cfg.padded - cfg.bank_size
    if pad:
        perms = torch.nn.functional.pad(perms, (0, pad))
    idx = perms.reshape(cfg.n_steps, cfg.batch_size)
    pos = torch.arange(cfg.padded).reshape(cfg.steps_per_epoch, cfg.batch_size)
    w = (pos < cfg.bank_size).to(torch.float32).repeat(cfg.epochs, 1)
    return idx.to(device), w.to(device)


def minibatch_schedule(gen: torch.Generator, cfg: InnerLoopCfg, device="cpu"):
    """The schedule of fresh per-epoch permutations drawn from ``gen``."""
    perms = torch.stack([torch.randperm(cfg.bank_size, generator=gen) for _ in range(cfg.epochs)])
    return schedule_from_perms(perms, cfg, device)


def inner_fit(loss_fn: Callable, params, tx, gen: Optional[torch.Generator], cfg: InnerLoopCfg,
              schedule=None, device="cpu"):
    """Run the adaptation loop; returns the adapted parameter tree.

    ``loss_fn(params, idx, w) -> scalar`` gathers its own bank rows by
    ``idx``.  ``schedule``: explicit ``(idx, w)`` overriding the draw from
    ``gen``.  The incoming tree is not modified."""
    if cfg.epochs == 0:
        return params
    idx_all, w_all = schedule if schedule is not None else minibatch_schedule(gen, cfg, device)
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach() for p in leaves]
    state = tx.init(pytree.tree_unflatten(leaves, spec))
    for t in range(idx_all.shape[0]):
        live = [p.requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(pytree.tree_unflatten(live, spec), idx_all[t], w_all[t])
            grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            frozen = pytree.tree_unflatten([p.detach() for p in live], spec)
            updates, state = tx.update(pytree.tree_unflatten(list(grads), spec), state, frozen)
            leaves = [p.detach() + u.to(p.dtype) for p, u in zip(live, pytree.tree_leaves(updates))]
    return pytree.tree_unflatten(leaves, spec)


def inner_fit_carry(loss_fn: Callable, params, carry, tx, gen: Optional[torch.Generator], cfg: InnerLoopCfg,
                    schedule=None, device="cpu"):
    """:func:`inner_fit` with a carry that is threaded through the steps but
    not optimized, detached each step (inner_loop.py:198-233).

    ``loss_fn(params, carry, idx, w) -> (scalar, new_carry)``.  The meta
    fine-tune's ``minibatch`` BN mode carries the whole running-stat tree
    through it, as every train-mode inner forward of the reference updates
    the adapted copy's stats (gnnnet.py:158-187).  Returns
    ``(adapted_params, final_carry)``."""
    if cfg.epochs == 0:
        return params, carry
    idx_all, w_all = schedule if schedule is not None else minibatch_schedule(gen, cfg, device)
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach() for p in leaves]
    state = tx.init(pytree.tree_unflatten(leaves, spec))
    for t in range(idx_all.shape[0]):
        live = [p.requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, new_carry = loss_fn(pytree.tree_unflatten(live, spec), carry, idx_all[t], w_all[t])
            grads = torch.autograd.grad(loss, live)
        carry = pytree.tree_map(torch.Tensor.detach, new_carry)
        with torch.no_grad():
            frozen = pytree.tree_unflatten([p.detach() for p in live], spec)
            updates, state = tx.update(pytree.tree_unflatten(list(grads), spec), state, frozen)
            leaves = [p.detach() + u.to(p.dtype) for p, u in zip(live, pytree.tree_leaves(updates))]
    return pytree.tree_unflatten(leaves, spec), carry


def fo_maml_reattach(meta_params, adapted_params):
    """First-order MAML plumbing (inner_loop.py:287-299): a tree equal to
    ``adapted_params`` whose gradient reaches ``meta_params`` with an
    identity Jacobian, ``m + (a - m).detach()``.  The outer loss is taken at
    the adapted point and its gradient lands on the meta-initialization, as
    the reference's ``MAML_update`` leaves only the outer step on it
    (gnnnet.py:90-103,183-187; train.py:49-58)."""
    return pytree.tree_map(lambda m, a: m + (a - m).detach(), meta_params, adapted_params)
