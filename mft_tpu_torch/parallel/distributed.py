"""Data-parallel training and eval over processes (counterpart of the
multi-host half of ``mft_tpu/parallel/mesh.py:17-23`` and of the
per-process feeding of the JAX dry run, ``make_array_from_process_local_data``).

The episode axis ``E`` of a training step is the data-parallel axis, as
the JAX package's ``P("data")`` sharding makes it: rank ``r`` of a world of
``W`` processes holds the contiguous slice :func:`episode_slice` of the
global batch, in global order, and feeds only those episodes.  Every rank
holds the whole parameter tree (:func:`broadcast_tree` makes rank 0's the
start); after the backward, the gradients are summed over the ranks in one
flat bucket (:func:`all_reduce_tree`), so every rank applies the same
update and the trees stay bit-equal (:func:`tree_checksum`).  The steps of
``train/steps.py`` take the process group as their ``group`` argument.

One process a card: ``nccl`` on ``cuda:<rank>``, ``gloo`` on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def init_process_group(rank: int, world: int, init_method: str, device: str = "cuda") -> torch.device:
    """Join the world as ``rank`` (``init_method``: ``tcp://127.0.0.1:<port>``)
    and return this rank's device: ``cuda:<rank>`` (made the current card
    before anything launches on it) with ``nccl``, or the CPU with ``gloo``.
    There is no fallback from one backend to the other: a failed ``nccl``
    init raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: a cuda rank needs a card; pass device='cpu' for gloo")
        dev = torch.device("cuda", rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, rank=rank, world_size=world, device_id=dev)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    else:
        raise ValueError(f"init_process_group: no backend for device {device!r}")
    return dev


def rank_world(group=None) -> tuple:
    """``(rank, world)`` of this process in ``group`` (``(0, 1)`` without one)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def episode_slice(rank: int, world: int, n_episodes: int) -> slice:
    """Rank ``rank``'s contiguous share of ``n_episodes`` in global order.
    Refuses a batch the world does not divide, as ``P("data")`` sharding
    refuses an axis its mesh does not divide."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    if n_episodes % world:
        raise ValueError(f"{n_episodes} episodes do not split evenly over {world} ranks")
    per = n_episodes // world
    return slice(rank * per, (rank + 1) * per)


def _buckets(leaves):
    """Leaf indices grouped by (dtype, device): one flat bucket each."""
    out = {}
    for i, t in enumerate(leaves):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out.values()


def _bucketed(tree, collective):
    """``collective(flat)`` on one flat copy of each dtype's leaves; returns
    the tree of the results (the input tree is left as it was)."""
    leaves, spec = pytree.tree_flatten(tree)
    out = list(leaves)
    for idx in _buckets(leaves):
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        collective(flat)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return pytree.tree_unflatten(out, spec)


def broadcast_tree(tree, src: int = 0, group=None):
    """Rank ``src``'s tree on every rank (a new tree; every leaf a tensor)."""
    if group is None:
        return tree
    return _bucketed(tree, lambda flat: dist.broadcast(flat, src=dist.get_global_rank(group, src), group=group))


def all_reduce_tree(tree, group=None):
    """The sum over the ranks of each leaf, as one flat bucket a dtype; the
    tree as it is without a group.  Every rank gets the same bits back.
    The steps weigh each rank's mean by its share of the batch first, so
    the sum is the global batch's mean."""
    if group is None:
        return tree
    return _bucketed(tree, lambda flat: dist.all_reduce(flat, group=group))


def all_gather_episodes(x: torch.Tensor, group=None) -> torch.Tensor:
    """``[E_local, ...]`` of every rank -> ``[E, ...]`` in global episode
    order (rank 0's episodes first).  Gloo has no all-gather of CUDA
    tensors, so under gloo a CUDA tensor goes through the CPU."""
    if group is None:
        return x
    _, world = rank_world(group)
    via_cpu = x.is_cuda and dist.get_backend(group) == "gloo"
    local = (x.detach().cpu() if via_cpu else x.detach()).contiguous()
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=group)
    out = torch.cat(parts)
    return out.to(x.device) if via_cpu else out


def tree_checksum(tree) -> float:
    """``sum |leaf|`` over the tree in f64 on the CPU: equal on every rank
    whose tree is bit-equal, and a cheap fingerprint for the dry run."""
    return float(sum(t.detach().double().abs().sum().cpu() for t in pytree.tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))
