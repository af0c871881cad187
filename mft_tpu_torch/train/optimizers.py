"""Optimizers with torch-exact update semantics, as pure functions on trees
(port of ``mft_tpu/train/optimizers.py``).

Each optimizer is an ``(init, update)`` pair in the optax shape:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; the inner loop adds the updates to the parameters.  Trees are
dicts / lists of tensors.  ``torch.optim`` is not used because its state
lives inside a module and cannot carry bf16 moments with f32 math.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def torch_adam(lr: float, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """torch.optim.Adam: L2 weight decay added to the gradient before the
    moment updates; moments in the parameters' dtype."""

    def init(params):
        z = lambda p: torch.zeros_like(p)
        return {"mu": pytree.tree_map(z, params), "nu": pytree.tree_map(z, params), "t": 0}

    def update(grads, state, params):
        if weight_decay:
            grads = pytree.tree_map(lambda g, p: g + weight_decay * p, grads, params)
        t = state["t"] + 1
        mu = pytree.tree_map(lambda m, g: (1 - b1) * g + b1 * m, state["mu"], grads)
        nu = pytree.tree_map(lambda v, g: (1 - b2) * g.square() + b2 * v, state["nu"], grads)
        c1, c2 = 1 - b1**t, 1 - b2**t
        updates = pytree.tree_map(lambda m, v: -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)), mu, nu)
        return updates, {"mu": mu, "nu": nu, "t": t}

    return Optimizer(init, update)


def torch_adam_lowmem(lr: float, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8, state_dtype=torch.bfloat16):
    """torch-Adam with both moments STORED in ``state_dtype`` (bf16 by
    default); every step's math runs in f32 and the update rounds to the
    parameter dtype."""

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=state_dtype)
        return {"mu": pytree.tree_map(z, params), "nu": pytree.tree_map(z, params), "t": 0}

    def update(grads, state, params):
        if weight_decay:
            grads = pytree.tree_map(lambda g, p: g + weight_decay * p, grads, params)
        t = state["t"] + 1
        mu = pytree.tree_map(lambda m, g: (b1 * m.float() + (1 - b1) * g.float()).to(state_dtype), state["mu"], grads)
        nu = pytree.tree_map(lambda v, g: (b2 * v.float() + (1 - b2) * g.float().square()).to(state_dtype), state["nu"], grads)
        c1, c2 = 1.0 - b1**t, 1.0 - b2**t

        def upd(m, v, g):
            mh = m.float() / c1
            vh = v.float() / c2
            return (-lr * mh / (torch.sqrt(vh) + eps)).to(g.dtype)

        updates = pytree.tree_map(upd, mu, nu, grads)
        return updates, {"mu": mu, "nu": nu, "t": t}

    return Optimizer(init, update)


def torch_sgd(lr: float, momentum: float = 0.0, dampening: float = 0.0, weight_decay: float = 0.0):
    """torch.optim.SGD: ``g <- grad + wd*p``; ``buf <- g`` on the first step,
    ``mu*buf + (1-damp)*g`` afterwards; ``p <- p - lr*buf``."""

    def init(params):
        return {"buf": pytree.tree_map(torch.zeros_like, params), "started": False}

    def update(grads, state, params):
        if weight_decay:
            grads = pytree.tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum == 0.0:
            return pytree.tree_map(lambda g: -lr * g, grads), state
        if state["started"]:
            buf = pytree.tree_map(lambda b, g: momentum * b + (1.0 - dampening) * g, state["buf"], grads)
        else:
            buf = grads
        return pytree.tree_map(lambda b: -lr * b, buf), {"buf": buf, "started": True}

    return Optimizer(init, update)


def reference_probe_sgd(lr: float = 0.01):
    """The linear probe's optimizer (meta_template.py:166, baselinefinetune.py;
    DampNet's set_forward_adaptation_full): SGD with momentum 0.9, dampening
    0.9 and weight decay 0.001."""
    return torch_sgd(lr, momentum=0.9, dampening=0.9, weight_decay=0.001)


def grouped(transforms: dict, labels: dict):
    """Per-subtree optimizers (the reference's separate delta_opt /
    classifier_opt, finetune.py:109,124).  ``labels`` maps each top-level
    key of the parameter dict to a key of ``transforms``."""

    def init(params):
        return {k: transforms[labels[k]].init(params[k]) for k in params}

    def update(grads, state, params):
        updates, new_state = {}, {}
        for k in params:
            updates[k], new_state[k] = transforms[labels[k]].update(grads[k], state[k], params[k])
        return updates, new_state

    return Optimizer(init, update)
