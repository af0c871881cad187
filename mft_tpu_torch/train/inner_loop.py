"""Inner-loop adaptation engine (port of ``mft_tpu/train/inner_loop.py``).

Every adaptation loop has one shape: for E epochs, a fresh permutation of a
fixed bank, walked in minibatches whose last one may be short, one optimizer
step per minibatch.  The schedule is precomputed as static ``[T, B]`` index
and weight tensors: the ragged last minibatch is padded with bank row 0 at
weight 0, so every step has the same shapes (no host sync, and the loop can
later be captured as one CUDA graph).

Episode lanes: :func:`inner_fit` also runs ``L`` independent loops in one,
with parameters and optimizer state carrying a leading ``[L]``, a schedule
``idx [L, T, B]`` (one permutation stream per lane, :func:`lane_schedule`)
and ``w [T, B]`` (shared: the padding depends only on the position).  The
loss is the sum of the lanes' losses, so each lane's gradient is its own
loss's, exactly; the optimizers are elementwise on the stacked leaves.
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


def lane_schedule(gens, cfg: InnerLoopCfg, device="cpu"):
    """The schedules of ``L`` lanes, each drawn from its own generator as
    :func:`minibatch_schedule` draws it: ``(idx [L, T, B], w [T, B])``."""
    scheds = [minibatch_schedule(g, cfg, device) for g in gens]
    return torch.stack([i for i, _ in scheds]), scheds[0][1]


def stack_schedules(schedules):
    """Per-lane explicit ``(idx [T, B], w [T, B])`` schedules -> one lane
    schedule ``(idx [L, T, B], w [T, B])``; the lanes' weights must agree."""
    idx = torch.stack([torch.as_tensor(i) for i, _ in schedules])
    w = torch.as_tensor(schedules[0][1])
    if any(not torch.equal(torch.as_tensor(wl), w) for _, wl in schedules[1:]):
        raise ValueError("the lanes' schedules pad different positions; lanes share one weight schedule")
    return idx, w


class _Loop:
    """One adaptation loop's parameters and optimizer state between steps."""

    def __init__(self, params, tx):
        self.tx = tx
        leaves, self.spec = pytree.tree_flatten(params)
        self.leaves = [p.detach() for p in leaves]
        self.state = tx.init(pytree.tree_unflatten(self.leaves, self.spec))

    def result(self):
        return pytree.tree_unflatten(self.leaves, self.spec)


def _grads(loss, leaves):
    """``d loss / d leaves``, zeros for a leaf the loss does not reach (as
    under ``jax.grad``): ResNet10_FW's noise strengths, which its eval and
    the meta fine-tune run without noise, ride the adapted block unused."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _step(loops, loss_ofs):
    """One optimizer step of each loop: ``loss_ofs[i](params) -> scalar or
    [L]``; one autodiff pass takes the gradient of all losses' sum, so
    each loop (and lane) gets its own loss's gradient."""
    lives = [[p.requires_grad_(True) for p in lp.leaves] for lp in loops]
    with torch.enable_grad():
        losses = [f(pytree.tree_unflatten(live, lp.spec)) for lp, live, f in zip(loops, lives, loss_ofs)]
        losses = [v if v.dim() == 0 else v.sum() for v in losses]
        loss = sum(losses[1:], losses[0])
        flat = [p for live in lives for p in live]
        grads = iter(_grads(loss, flat))
    with torch.no_grad():
        for lp, live in zip(loops, lives):
            g = pytree.tree_unflatten([next(grads) for _ in live], lp.spec)
            frozen = pytree.tree_unflatten([p.detach() for p in live], lp.spec)
            updates, lp.state = lp.tx.update(g, lp.state, frozen)
            lp.leaves = [p.detach() + u.to(p.dtype) for p, u in zip(live, pytree.tree_leaves(updates))]


def _schedule_of(gen, cfg: InnerLoopCfg, schedule, device):
    if schedule is not None:
        return schedule
    if isinstance(gen, (list, tuple)):
        return lane_schedule(gen, cfg, device)
    return minibatch_schedule(gen, cfg, device)


def _at(loss_fn, idx, w, t: int):
    """Step ``t``'s loss of a schedule (``idx [T, B]`` or ``[L, T, B]``)."""
    return lambda p: loss_fn(p, idx.select(-2, t), w[t])


def inner_fit(loss_fn: Callable, params, tx, gen, cfg: InnerLoopCfg, schedule=None, device="cpu"):
    """Run the adaptation loop; returns the adapted parameter tree.

    ``loss_fn(params, idx, w)`` gathers its own bank rows by ``idx`` and
    returns a scalar, or with lanes the ``[L]`` per-lane losses (summed).
    ``gen``: a generator, or a list of ``L`` (one per lane); ``schedule``:
    explicit ``(idx, w)`` overriding the draw.  The incoming tree is not
    modified."""
    if cfg.epochs == 0:
        return params
    idx, w = _schedule_of(gen, cfg, schedule, device)
    loop = _Loop(params, tx)
    for t in range(w.shape[0]):
        _step([loop], [_at(loss_fn, idx, w, t)])
    return loop.result()


def inner_fit_pair(loss_a: Callable, params_a, tx_a, gen_a, cfg_a: InnerLoopCfg, loss_b: Callable, params_b, tx_b,
                   gen_b, cfg_b: InnerLoopCfg, *, schedule_a=None, schedule_b=None, device="cpu"):
    """Two independent adaptation loops stepped together
    (inner_loop.py:130-195): while both have steps left, one autodiff pass
    takes the gradient of both losses' sum (each loop's gradient is its own
    loss's, exactly), then the longer loop runs on alone.  Numerically
    :func:`inner_fit` on each loop; the ensemble's linear member (100 steps)
    rides the GNN member's first 100 of 500.  Schedules are drawn ``a`` then
    ``b`` unless given.  Returns ``(adapted_a, adapted_b)``."""
    if cfg_a.epochs == 0 or cfg_b.epochs == 0:
        return (inner_fit(loss_a, params_a, tx_a, gen_a, cfg_a, schedule_a, device),
                inner_fit(loss_b, params_b, tx_b, gen_b, cfg_b, schedule_b, device))
    ia, wa = _schedule_of(gen_a, cfg_a, schedule_a, device)
    ib, wb = _schedule_of(gen_b, cfg_b, schedule_b, device)
    a, b = _Loop(params_a, tx_a), _Loop(params_b, tx_b)
    both = min(wa.shape[0], wb.shape[0])
    for t in range(both):
        _step([a, b], [_at(loss_a, ia, wa, t), _at(loss_b, ib, wb, t)])
    for loop, loss_fn, idx, w in ((a, loss_a, ia, wa), (b, loss_b, ib, wb)):
        for t in range(both, w.shape[0]):
            _step([loop], [_at(loss_fn, idx, w, t)])
    return a.result(), b.result()


def inner_fit_epochwise(loss_fn: Callable, params, tx, gens, cfg: InnerLoopCfg, banks: dict, perms=None):
    """:func:`inner_fit` with the gather hoisted out of the steps
    (inner_loop.py:236-284): each epoch permutes the bank once and every
    step slices a contiguous minibatch.  ``banks``: a dict of lane-stacked
    tensors ``[L, bank_size, ...]``; ``gens``: one generator per lane, each
    drawing its epochs' permutations in :func:`minibatch_schedule`'s order,
    so the steps see the rows the per-step gather sees (``perms [L, epochs,
    bank_size]``: explicit ones instead).  ``loss_fn(params, chunk, w) ->
    [L]`` receives the step's rows ``{k: [L, B, ...]}``."""
    if cfg.epochs == 0:
        return params
    if perms is None:
        perms = torch.stack([torch.stack([torch.randperm(cfg.bank_size, generator=g) for _ in range(cfg.epochs)])
                             for g in gens])
    dev = next(iter(banks.values())).device
    perms = torch.as_tensor(perms, dtype=torch.int64)
    _, w = schedule_from_perms(perms[0], cfg, dev)
    perms = torch.nn.functional.pad(perms, (0, cfg.padded - cfg.bank_size)).to(dev)
    lanes = torch.arange(perms.shape[0], device=dev)[:, None]
    bs, loop = cfg.batch_size, _Loop(params, tx)
    for e in range(cfg.epochs):
        bank_e = {k: v[lanes, perms[:, e]] for k, v in banks.items()}  # one gather an epoch
        for t in range(cfg.steps_per_epoch):
            chunk = {k: v[:, t * bs : (t + 1) * bs] for k, v in bank_e.items()}
            _step([loop], [lambda p, c=chunk, wt=w[t]: loss_fn(p, c, wt)])
    return loop.result()


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
            grads = _grads(loss, live)
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
