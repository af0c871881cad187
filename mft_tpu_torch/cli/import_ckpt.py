"""Checkpoint importer of the port (counterpart of ``mft_tpu/cli/import_ckpt.py``):
reference ``.tar`` or JAX ``.ckpt`` files -> the port's ``<epoch>.tar``.

Each input is a ``torch.save({'epoch', 'state'})`` file of the reference
(train.py:48,58) or a ``<epoch>.ckpt`` the JAX package wrote; the output is
the port's checkpoint (``utils/checkpoint.py``: the reference state dict
plus ``'adam'`` and, for DampNet, ``'damp_state'``) in the same
epoch-numbered layout, so the port's drivers pick it up with the flags they
would use on a run trained here.

* From a reference ``.tar`` the Adam state is fresh (ResNet10_FW's noise
  strengths frozen by ``freeze_masked``, as the training driver has them),
  as the reference's own resume re-creates its optimizer
  (train.py:196-205); a DampNet file's ``damp_state`` is fresh too (its
  prototypes are plain attributes in the reference, never in its state
  dict).
* From a ``.ckpt`` (or a ``.tar`` the port wrote) the file's Adam moments,
  step count and ``damp_state`` come across.

The three DampNet variants share their state-dict keys, so a DampNet file
needs its ``--method``.  ``best_model.{tar,ckpt}`` becomes ``best_model.tar``.

Examples::

    python -m mft_tpu_torch.cli.import_ckpt logs/checkpoints/miniImageNet/ResNet10_gnnnet_aug_5way_5shot/600.ckpt \\
        --model ResNet10 --out_dir /data/ckpt/ResNet10_gnnnet_aug_5way_5shot
    python -m mft_tpu_torch.cli.import_ckpt jax_run/ --model ResNet10 \\
        --dataset miniImageNet --method gnnnet --train_aug --n_way 5 --n_shot 5
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from torch.utils import _pytree as pytree

from mft_tpu_torch import config as cfg_mod
from mft_tpu_torch.convert import from_state_dict
from mft_tpu_torch.methods import dampnet as dn
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.train import optimizers as opt
from mft_tpu_torch.utils import checkpoint as ckpt

DAMPNET_METHODS = ("dampnet", "dampnet_full", "dampnet_full_class")


def _sources(srcs):
    """The files to import: the arguments, or every ``.tar`` and ``.ckpt``
    of one directory."""
    if len(srcs) == 1 and os.path.isdir(srcs[0]):
        return sorted(glob.glob(os.path.join(srcs[0], "*.tar")) + glob.glob(os.path.join(srcs[0], "*.ckpt")))
    return srcs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="+", help=".tar or .ckpt checkpoint file(s), or one directory of them")
    ap.add_argument("--model", default="ResNet10", choices=sorted(bb.MODEL_REGISTRY))
    ap.add_argument("--out_dir", default=None, help="destination checkpoint directory")
    ap.add_argument("--dataset", default=None,
                    help="with --method: derive the standard checkpoint dir instead of --out_dir")
    ap.add_argument("--method", default="gnnnet")
    ap.add_argument("--train_aug", action="store_true")
    ap.add_argument("--n_way", type=int, default=5)
    ap.add_argument("--n_shot", type=int, default=5)
    ap.add_argument("--paths_json", default=None)
    ap.add_argument("--loose", action="store_true",
                    help="import the mapped subset of a .tar even if some tensors are unmapped")
    a = ap.parse_args(argv)

    if a.out_dir:
        out_dir = a.out_dir
    elif a.dataset:
        out_dir = cfg_mod.checkpoint_dir(cfg_mod.Paths.load(a.paths_json), a.dataset, a.model, a.method,
                                         train_aug=a.train_aug,
                                         n_way=a.n_way if a.method not in ("baseline", "baseline++") else None,
                                         n_shot=a.n_shot)
    else:
        ap.error("give either --out_dir or --dataset (to derive the standard layout)")
    srcs = _sources(a.src)
    if not srcs:
        print(f"no .tar or .ckpt checkpoints under {a.src[0]}", file=sys.stderr)
        return 2

    bcfg = bb.MODEL_REGISTRY[a.model]()
    for src in srcs:
        epoch, sd, adam, damp = ckpt.read_checkpoint(src)
        params, stats = from_state_dict(sd, bcfg, strict=not a.loose)
        # the training driver's optimizer: FWT noise strengths frozen (cli/train.py)
        tx = opt.torch_adam(1e-3)
        trainable = bb.fwt_trainable_mask(params)
        if not all(pytree.tree_leaves(trainable)):
            tx = opt.freeze_masked(tx, trainable)
        opt_state, damp_state = ckpt.restore_adam(tx.init(params), adam), None
        if "W_R" in params:
            # the three variants share their state-dict keys, so the variant
            # cannot be read off the tensors: the user names it
            if a.method not in DAMPNET_METHODS:
                ap.error(
                    f"{src} is a DampNet checkpoint (has recovery-net tensors) but "
                    f"--method is {a.method!r}; the three DampNet variants share "
                    "identical state-dict keys, so pass the correct --method "
                    "(dampnet | dampnet_full | dampnet_full_class) explicitly"
                )
            dcfg = dn.method_cfg(a.method, int(params["layer3"]["b"].shape[0]), a.n_way, a.n_shot)
            damp_state = ckpt.restore_damp_state(damp, dn.fresh_state(dcfg), src)
        name = "best_model.tar" if os.path.splitext(os.path.basename(src))[0] == "best_model" else None
        path = ckpt.save_checkpoint(out_dir, epoch, params, stats, opt_state, damp_state, name=name)
        parts = sorted(k for k in params if k != "feature")
        print(f"{src} -> {path} (epoch {epoch}, feature + {'/'.join(parts) if parts else 'no head'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
