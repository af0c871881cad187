"""One episode of the eval, as the reference's ``finetune.py`` runs it
(``--method all``: the linear member and the GNN member, their softmaxes
summed) or as ``finetune_50.py`` runs DampNet's live composition
(``dampnet_full_class``, ``--dampnet_eval finetune``), in stages:

* :func:`draws`: the episode's random numbers, in the order the port takes
  them from the episode's generator: the linear head's init (``rand(n_way,
  feat)``, ``rand(n_way)``; ``feat`` the last stage's width), the linear
  schedule (a ``randperm`` of the support an epoch), each augmented
  replica's nine uniforms an image, then the GNN (or DampNet) schedule (a
  ``randperm`` of the bank an epoch);
* :func:`support_bank`: the frozen trunk's features of the support bank
  (the clean support three times, then ``gen_examples`` augmented
  replicas), batch statistics per replica; the linear member takes the
  clean support alone;
* :func:`adapt`: ``epochs`` of batch-5 torch-Adam steps on the final block
  (the linear member's head beside it, with weight decay), the parameters
  carried in the run's precision; the GNN
  member's inner loss is the cross-entropy of the raw features as
  logits (reference finetune.py:286-291);
* :func:`scores_from_state`: the clean episode embedded by the adapted
  backbone (batch statistics over the episode) and scored by each member's
  head, the softmaxes summed.

:func:`run_episode` runs them all.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.images import augmented_view, clean_view
from portbench.reference.nets import DampNetRecovery, GnnNetHead, Precision, ResNet, linear


def adapting_members(cell: dict) -> list:
    """``(member, model)`` pairs that adapt a block, in run order."""
    if cell["method"] == "all":
        return [("linear", "baseline"), ("gnn", "gnn")]
    if cell["method"] == "dampnet_full_class":
        return [("dampnet", "dampnet")]
    raise ValueError(f"the reference evaluates --method all and dampnet_full_class, not {cell['method']!r}")


def backbone(sd: dict, cell: dict, prec: Precision) -> ResNet:
    """The backbone of state dict ``sd`` in the cell's shape
    (``stage_sizes``, ``widths``)."""
    return ResNet(sd, prec, cell["stage_sizes"], cell["widths"])


def draws(gen: torch.Generator, cell: dict) -> dict:
    """Every random number of the episode, drawn in the port's order."""
    n_way, support = cell["n_way"], cell["n_way"] * cell["n_shot"]
    out = {}
    if cell["method"] == "all":
        feat = cell["widths"][-1]
        bound = 1.0 / math.sqrt(feat)
        out["head0"] = {"w": (torch.rand((n_way, feat), generator=gen) * 2.0 - 1.0) * bound,
                        "b": (torch.rand((n_way,), generator=gen) * 2.0 - 1.0) * bound}
        out["linear_perms"] = [torch.randperm(support, generator=gen) for _ in range(cell["linear_epochs"])]
    out["augment"] = [torch.rand((support, 9), generator=gen) for _ in range(cell["gen_examples"])]
    span = (cell["gen_examples"] + 3) * support
    out["bank_perms"] = [torch.randperm(span, generator=gen) for _ in range(cell["fine_tune_epoch"])]
    return out


def steps_of(perms: list, batch: int) -> list:
    """Each step's bank rows: every permutation cut in batches (every span
    the benchmark runs is a multiple of the batch)."""
    if len(perms[0]) % batch:
        raise ValueError(f"a bank of {len(perms[0])} rows does not cut into batches of {batch}")
    return [p[i : i + batch] for p in perms for i in range(0, len(p), batch)]


class Episode:
    """One episode's images, views and labels on the device."""

    def __init__(self, images_u8: torch.Tensor, cell: dict):
        self.cell = cell
        n_way, n_shot = cell["n_way"], cell["n_shot"]
        views = clean_view(images_u8, cell["image_size"])  # [n_way, s+q, 3, S, S]
        self.views = views.reshape((-1,) + tuple(views.shape[2:]))
        self.support_u8 = images_u8[:, :n_shot].reshape((-1,) + tuple(images_u8.shape[2:]))
        self.support_views = views[:, :n_shot].reshape((-1,) + tuple(views.shape[2:]))
        self.y_support = torch.arange(n_way, device=images_u8.device).repeat_interleave(n_shot)
        self.y_bank = self.y_support.repeat(cell["gen_examples"] + 3)


def support_bank(net: ResNet, ep: Episode, d: dict, member: str) -> torch.Tensor:
    """The member's bank of trunk features: the clean support's (the linear
    member), or ``[clean x3, augmented replicas]``, each replica's batch
    statistics its own."""
    with torch.no_grad():
        clean = net.trunk(ep.support_views)
        if member == "linear":
            return clean
        groups = [clean, clean, clean]
        for u in d["augment"]:
            groups.append(net.trunk(augmented_view(ep.support_u8, u, ep.cell["augment"], ep.cell["image_size"])))
    return torch.cat(groups)


def start_state(net: ResNet, d: dict, member: str, device) -> tuple:
    """The member's starting ``(block, head)``: the final block as loaded
    and, for the linear member, the drawn head."""
    head = {k: v.to(device) for k, v in d["head0"].items()} if member == "linear" else None
    return net.block_params(net.final_index), head


def labels_of(ep: Episode, member: str) -> torch.Tensor:
    return ep.y_support if member == "linear" else ep.y_bank


def member_steps(d: dict, member: str, batch: int) -> list:
    return steps_of(d["linear_perms"] if member == "linear" else d["bank_perms"], batch)


def adapt(net: ResNet, bank, labels, steps, block0: dict, head0=None, *, lr: float, head_wd: float = 0.0,
          first_grads: dict | None = None) -> tuple:
    """torch-Adam on ``block0`` (and ``head0``) over ``steps``; returns the
    adapted ``(block, head)``.  The parameters are carried in the net's
    precision: rounded by it after every step (float8 for the control, as
    the port carries them in bfloat16).  ``first_grads``: filled with the
    norm of each leaf's gradient at the first step (the head's as
    ``head.<k>``)."""
    block = {k: v.detach().float().clone().requires_grad_(True) for k, v in block0.items()}
    groups = [{"params": list(block.values()), "lr": lr}]
    head = None
    if head0 is not None:
        head = {k: v.detach().float().clone().requires_grad_(True) for k, v in head0.items()}
        groups.append({"params": list(head.values()), "lr": lr, "weight_decay": head_wd})
    opt = torch.optim.Adam(groups, lr=lr, foreach=True)
    bank = bank.float()
    for rows in steps:
        rows = rows.to(bank.device)
        feats = net.final(block, bank[rows])
        logits = feats if head is None else linear(net.prec, feats, head["w"], head["b"])
        loss = F.cross_entropy(logits, labels[rows])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if first_grads is not None and not first_grads:
            first_grads.update({k: float(v.grad.norm()) for k, v in block.items()})
            if head is not None:
                first_grads.update({f"head.{k}": float(v.grad.norm()) for k, v in head.items()})
        opt.step()
        if net.prec.name != "float32":
            with torch.no_grad():
                for group in groups:
                    for v in group["params"]:
                        v.copy_(net.prec(v))
    return ({k: v.detach() for k, v in block.items()},
            None if head is None else {k: v.detach() for k, v in head.items()})


def member_scores(models: dict, ep: Episode, member: str, block: dict, head, prec: Precision) -> torch.Tensor:
    """One member's softmax scores ``[n_way * n_query, n_way]`` from its
    adapted ``block`` (and ``head``)."""
    cell = ep.cell
    n_way, n_shot, n_query = cell["n_way"], cell["n_shot"], cell["n_query"]
    model = {"linear": "baseline", "gnn": "gnn", "dampnet": "dampnet"}[member]
    net = backbone(models[model], cell, prec)
    block = {k: v.float() for k, v in block.items()}
    with torch.no_grad():
        feats = net.final(block, net.trunk(ep.views)).reshape(n_way, n_shot + n_query, -1)
        if member == "linear":
            q = feats[:, n_shot:].reshape(n_way * n_query, -1)
            return torch.softmax(linear(prec, q, head["w"].float(), head["b"].float()), dim=-1)
        if member == "dampnet":
            feats = DampNetRecovery(models[model], prec).recover(feats, n_shot, models["proto_mean"],
                                                                 models["proto_std"])
        return torch.softmax(GnnNetHead(models[model], prec).scores(feats, n_way, n_shot, n_query), dim=-1)


def scores_from_state(models: dict, ep: Episode, state: dict, prec: Precision) -> torch.Tensor:
    """The episode's scores from every member's adapted ``(block, head)``
    (``state[member]``), the members' softmaxes summed."""
    return sum(member_scores(models, ep, member, *state[member], prec) for member, _ in adapting_members(ep.cell))


def run_episode(models: dict, images_u8: torch.Tensor, gen: torch.Generator, cell: dict,
                precision: str = "float32") -> dict:
    """The whole episode: ``{"scores", "state": {member: (block, head)},
    "start": {member: (block, head)}, "first_grads": {member: {leaf:
    norm}}, "banks": {member: bank}, "draws"}``.  ``models``:
    ``{"baseline": sd, "gnn": sd}`` (``all``) or ``{"dampnet": sd,
    "proto_mean": t, "proto_std": t}``."""
    prec = Precision(precision)
    ep = Episode(images_u8, cell)
    d = draws(gen, cell)
    state, start, grads, banks = {}, {}, {}, {}
    for member, model in adapting_members(cell):
        net = backbone(models[model], cell, prec)
        banks[member] = support_bank(net, ep, d, member)
        start[member] = start_state(net, d, member, images_u8.device)
        grads[member] = {}
        state[member] = adapt(net, banks[member], labels_of(ep, member), member_steps(d, member, cell["batch"]),
                              *start[member], lr=cell["lr"], head_wd=cell.get("head_wd", 0.0),
                              first_grads=grads[member])
    return {"scores": scores_from_state(models, ep, state, prec), "state": state, "start": start,
            "first_grads": grads, "banks": banks, "draws": d, "episode": ep}
