"""Training checkpoints in the reference's layout (counterpart of
``mft_tpu/utils/checkpoint.py``).

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
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from mft_tpu_torch.convert import from_state_dict, to_state_dict


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


def save_checkpoint(ckpt_dir: str, epoch: int, params, stats, opt_state=None, damp_state=None) -> str:
    """Write ``<ckpt_dir>/<epoch>.tar`` (through a temporary file, so a cut
    run leaves no half-written checkpoint)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{epoch}.tar")
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
    """``(epoch, params, stats, opt_state)`` from a ``.tar``; ``opt_state``
    takes ``opt_template``'s structure (the driver's fresh ``tx.init``) and
    is ``opt_template`` itself when the file holds no Adam state (or
    ``opt_template`` is None).  With ``damp_template`` (a DampNet model's
    fresh state) a fifth item follows: the file's ``damp_state``, or
    ``damp_template`` itself when the file holds none."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or "state" not in blob:
        raise ValueError(f"{path} is not a reference checkpoint (expected {{'epoch', 'state'}})")
    params, stats = from_state_dict(blob["state"], bcfg, device=device)
    opt_state = opt_template
    if "adam" in blob and opt_template is not None:
        a = blob["adam"]
        opt_state = {"mu": _fill(opt_template["mu"], a["mu"], device), "nu": _fill(opt_template["nu"], a["nu"], device),
                     "t": int(a["t"])}
    out = (int(blob.get("epoch", 0)), params, stats, opt_state)
    if damp_template is None:
        return out
    return out + (_damp_state(blob.get("damp_state"), damp_template, path, device),)


def _damp_state(saved, template: dict, path: str, device) -> dict:
    if saved is None:
        return template
    if set(saved) != set(template) or any(tuple(saved[k].shape) != tuple(v.shape) for k, v in template.items()):
        raise ValueError(f"{path}: its damp_state {({k: tuple(v.shape) for k, v in saved.items()})} is not this "
                         f"DampNet variant's {({k: tuple(v.shape) for k, v in template.items()})}")
    return {k: saved[k].to(device=device, dtype=v.dtype) for k, v in template.items()}


def get_assigned_file(ckpt_dir: str, num: int) -> str:
    """io_utils.py:49-51."""
    return os.path.join(ckpt_dir, f"{num}.tar")


def get_resume_file(ckpt_dir: str) -> Optional[str]:
    """Latest numeric ``<epoch>.tar`` (io_utils.py:53-62), or None."""
    epochs = [int(m.group(1)) for f in glob.glob(os.path.join(ckpt_dir, "*.tar"))
              if (m := re.fullmatch(r"(\d+)\.tar", os.path.basename(f)))]
    return os.path.join(ckpt_dir, f"{max(epochs)}.tar") if epochs else None


def get_best_file(ckpt_dir: str) -> Optional[str]:
    """``best_model.tar`` if present, else the latest (io_utils.py:64-69)."""
    best = os.path.join(ckpt_dir, "best_model.tar")
    return best if os.path.isfile(best) else get_resume_file(ckpt_dir)
