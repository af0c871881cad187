"""Training checkpoints in the reference's layout and in the JAX package's
(counterpart of ``mft_tpu/utils/checkpoint.py``).

``<ckpt_dir>/<epoch>.tar`` holds ``{'epoch', 'state'}`` as the reference's
train.py saves it (train.py:46-58): ``state`` is the reference state dict
(``convert.to_state_dict``), which ``convert.load_tar``, the port's eval and
the reference read.  The port adds one key, ``'adam'``: the driver's Adam
state (step count, and both moments keyed by their parameter's path), so
that ``--start_epoch`` resumes the optimizer as the JAX driver does
(cli/train.py:120-139).  A file without it (one the reference or
``mft_tpu.cli.export_ckpt`` wrote) resumes with a fresh Adam.  A DampNet
file adds one more, ``'damp_state'``: the prototypes, the rolling stores and
their count, which the reference keeps as plain attributes outside its state
dict.  A DampNet file without it loads with a fresh state (``initialized``
False), as ``mft_tpu.cli.import_ckpt`` rebuilds one (:89-114).  The
reference ignores both extra keys.

``<ckpt_dir>/<epoch>.ckpt`` is the JAX package's file: the flax state dict
of ``{"epoch", "params", "stats", "opt_state"[, "damp_state"]}`` (NHWC/HWIO
trees), read and written by ``utils/flax_msgpack.py`` without flax.
:func:`load_checkpoint` reads either (by the extension) into the same
tuple; :func:`save_flax_checkpoint` writes the JAX layout, which the JAX
package's ``load_checkpoint`` restores with its driver's template.  The
resolution helpers find ``.ckpt`` files where a directory has no ``.tar``
for that epoch; where both exist, the ``.tar`` wins.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mft_tpu_torch.convert import (adam_from_state_dict, adam_to_state_dict, damp_state_from_jax, damp_state_to_jax,
                                   from_jax, from_state_dict, sorted_state_dict, to_jax, to_state_dict)
from mft_tpu_torch.utils import flax_msgpack


def keyed(tree) -> dict:
    """A tree's leaves keyed by their path (``pytree.keystr``)."""
    return {pytree.keystr(path): leaf for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def _fill(template, flat: dict, device):
    """The tree of ``template``'s structure with its leaves from ``flat``."""
    paths, spec = pytree.tree_flatten_with_path(template)
    missing = [pytree.keystr(p) for p, _ in paths if pytree.keystr(p) not in flat]
    if missing:
        raise KeyError(f"the checkpoint's Adam state has no moment for {missing[:3]}")
    return pytree.tree_unflatten([flat[pytree.keystr(p)].to(device=device, dtype=t.dtype) for p, t in paths], spec)


def save_checkpoint(ckpt_dir: str, epoch: int, params, stats, opt_state=None, damp_state=None, *,
                    name: Optional[str] = None) -> str:
    """Write ``<ckpt_dir>/<epoch>.tar`` (or ``<ckpt_dir>/<name>``) through a
    temporary file, so a cut run leaves no half-written checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name or f"{epoch}.tar")
    blob = {"epoch": int(epoch), "state": to_state_dict(params, stats)}
    if opt_state is not None:
        cpu = lambda t: {k: v.detach().cpu() for k, v in keyed(t).items()}
        blob["adam"] = {"t": int(opt_state["t"]), "mu": cpu(opt_state["mu"]), "nu": cpu(opt_state["nu"])}
    if damp_state is not None:
        blob["damp_state"] = {k: v.detach().cpu() for k, v in damp_state.items()}
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(path: str, bcfg, opt_template, *, device="cpu", damp_template=None):
    """``(epoch, params, stats, opt_state)`` from a ``.tar`` or a JAX
    ``.ckpt``; ``opt_state`` takes ``opt_template``'s structure (the
    driver's fresh ``tx.init``) and is ``opt_template`` itself when the file
    holds no Adam state (or ``opt_template`` is None).  With
    ``damp_template`` (a DampNet model's fresh state) a fifth item follows:
    the file's ``damp_state``, or ``damp_template`` itself when the file
    holds none.  Either file's weights go through the reference state dict's
    mapping for ``bcfg``, which refuses a tensor it cannot place."""
    epoch, sd, adam, damp = read_checkpoint(path)
    params, stats = from_state_dict(sd, bcfg, device=device)
    out = (epoch, params, stats, restore_adam(opt_template, adam, device))
    if damp_template is None:
        return out
    return out + (restore_damp_state(damp, damp_template, path, device),)


def read_checkpoint(path: str):
    """``(epoch, reference state dict, Adam state or None, damp_state or
    None)`` of a ``.tar`` or a JAX ``.ckpt`` (by the extension), the Adam
    state as a ``.tar`` keeps it (``{"t", "mu", "nu"}``, moments keyed by
    path), all on the CPU."""
    if path.endswith(".ckpt"):
        return _read_flax(path)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or "state" not in blob:
        raise ValueError(f"{path} is not a reference checkpoint (expected {{'epoch', 'state'}})")
    return int(blob.get("epoch", 0)), blob["state"], blob.get("adam"), blob.get("damp_state")


def restore_adam(template, saved, device="cpu"):
    """``saved`` (:func:`read_checkpoint`'s Adam state) in ``template``'s
    structure on ``device``; ``template`` itself when either is None."""
    if saved is None or template is None:
        return template
    return {"mu": _fill(template["mu"], saved["mu"], device), "nu": _fill(template["nu"], saved["nu"], device),
            "t": int(saved["t"])}


def _read_flax(path: str):
    """A JAX ``.ckpt`` -> ``(epoch, reference state dict, Adam state keyed
    as in a .tar or None, damp_state or None)``."""
    raw = flax_msgpack.read(path)
    missing = [k for k in ("params", "stats") if not isinstance(raw, dict) or k not in raw]
    if missing:
        raise ValueError(f"{path} is not a JAX checkpoint: it has no {missing}")
    params, stats = from_jax(flax_msgpack.listify(raw["params"]), flax_msgpack.listify(raw["stats"]))
    adam = None
    if raw.get("opt_state"):
        a = adam_from_state_dict(raw["opt_state"])
        adam = {"t": a["t"], "mu": keyed(a["mu"]), "nu": keyed(a["nu"])}
    damp = damp_state_from_jax(raw["damp_state"]) if "damp_state" in raw else None
    return int(np.asarray(raw.get("epoch", 0))), to_state_dict(params, stats), adam, damp


def save_flax_checkpoint(ckpt_dir: str, epoch: int, params, stats, opt_state=None, damp_state=None, *,
                         name: Optional[str] = None) -> str:
    """Write ``<ckpt_dir>/<epoch>.ckpt`` (or ``<ckpt_dir>/<name>``) in the
    JAX package's layout: ``{"damp_state"?, "epoch", "opt_state", "params",
    "stats"}`` with NHWC/HWIO leaves, as its ``save_checkpoint`` writes them.
    Without ``opt_state`` a fresh Adam state is written (``freeze_masked``
    where the model has frozen leaves, as the JAX driver's template has)."""
    from mft_tpu_torch.models.backbone import fwt_trainable_mask
    from mft_tpu_torch.train import optimizers as opt

    if opt_state is None:
        tx = opt.torch_adam(1e-3)
        mask = fwt_trainable_mask(params)
        if not all(pytree.tree_leaves(mask)):
            tx = opt.freeze_masked(tx, mask)
        opt_state = tx.init(params)
    params_np, stats_np = to_jax(params, stats)
    tree = {"epoch": np.asarray(int(epoch)), "opt_state": adam_to_state_dict(opt_state, params_np),
            "params": sorted_state_dict(params_np), "stats": sorted_state_dict(stats_np)}
    if damp_state is not None:
        tree = {"damp_state": sorted_state_dict(damp_state_to_jax(damp_state)), **tree}
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name or f"{epoch}.ckpt")
    with open(path + ".tmp", "wb") as f:
        flax_msgpack.write(f, tree)
    os.replace(path + ".tmp", path)
    return path


def restore_damp_state(saved, template: dict, path: str, device="cpu") -> dict:
    """``saved`` checked against ``template`` (a fresh state of the variant)
    and cast to its dtypes on ``device``; ``template`` itself when None."""
    if saved is None:
        return template
    if set(saved) != set(template) or any(tuple(saved[k].shape) != tuple(v.shape) for k, v in template.items()):
        raise ValueError(f"{path}: its damp_state {({k: tuple(v.shape) for k, v in saved.items()})} is not this "
                         f"DampNet variant's {({k: tuple(v.shape) for k, v in template.items()})}")
    return {k: saved[k].to(device=device, dtype=v.dtype) for k, v in template.items()}


def _either(ckpt_dir: str, stem: str) -> str:
    """``<stem>.tar``, or ``<stem>.ckpt`` when only that exists."""
    tar, flax = os.path.join(ckpt_dir, f"{stem}.tar"), os.path.join(ckpt_dir, f"{stem}.ckpt")
    return flax if not os.path.isfile(tar) and os.path.isfile(flax) else tar


def get_assigned_file(ckpt_dir: str, num: int) -> str:
    """io_utils.py:49-51: ``<num>.tar``, or the JAX ``<num>.ckpt`` where the
    directory has no ``.tar`` of that epoch (the ``.tar`` wins where both
    exist)."""
    return _either(ckpt_dir, str(num))


def get_resume_file(ckpt_dir: str) -> Optional[str]:
    """The latest numeric epoch of ``<epoch>.tar`` and ``<epoch>.ckpt``
    files (io_utils.py:53-62), its ``.tar`` where both exist, or None."""
    epochs = [int(m.group(1)) for f in glob.glob(os.path.join(ckpt_dir, "*"))
              if (m := re.fullmatch(r"(\d+)\.(tar|ckpt)", os.path.basename(f)))]
    return _either(ckpt_dir, str(max(epochs))) if epochs else None


def get_best_file(ckpt_dir: str) -> Optional[str]:
    """``best_model.tar`` (or ``best_model.ckpt``) if present, else the
    latest (io_utils.py:64-69)."""
    best = _either(ckpt_dir, "best_model")
    return best if os.path.isfile(best) else get_resume_file(ckpt_dir)
