"""Checkpoint exporter of the port (counterpart of ``mft_tpu/cli/export_ckpt.py``):
the port's ``.tar`` or a JAX ``.ckpt`` -> a reference ``.tar``.

The output is ``torch.save({'epoch', 'state': model.state_dict()})``, the
file the reference loads directly (train.py:196-205, finetune.py:60-64): the
port's ``'adam'`` and ``'damp_state'`` keys are left out, and the weights go
through the state-dict mapping of ``--model``, which refuses a tensor it
cannot place.

Example::

    python -m mft_tpu_torch.cli.export_ckpt logs/checkpoints/miniImageNet/ResNet10_gnnnet_aug_5way_5shot/600.ckpt \\
        --model ResNet10 --out ref_ckpts/600.tar
"""

from __future__ import annotations

import argparse
import os
import sys

from mft_tpu_torch.convert import save_tar, to_state_dict
from mft_tpu_torch.models import backbone as bb
from mft_tpu_torch.utils import checkpoint as ckpt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="+", help=".tar or .ckpt checkpoint file(s)")
    ap.add_argument("--model", default="ResNet10", choices=sorted(bb.MODEL_REGISTRY))
    ap.add_argument("--out", default=None,
                    help="output .tar (single src) or directory (default: alongside src)")
    a = ap.parse_args(argv)

    bcfg = bb.MODEL_REGISTRY[a.model]()
    if len(a.src) > 1 and a.out and not os.path.isdir(a.out):
        ap.error("--out must be a directory when exporting multiple checkpoints")
    for src in a.src:
        epoch, params, stats, _ = ckpt.load_checkpoint(src, bcfg, None)
        sd = to_state_dict(params, stats)
        base = os.path.splitext(os.path.basename(src))[0] + ".tar"
        if a.out is None:
            dst = os.path.join(os.path.dirname(src) or ".", base)
        elif os.path.isdir(a.out):
            dst = os.path.join(a.out, base)
        else:
            dst = a.out
        if os.path.abspath(dst) == os.path.abspath(src):
            ap.error(f"{src} would be overwritten by its own export: give --out")
        save_tar(dst, epoch, sd)
        print(f"{src} -> {dst} (epoch {epoch}, {len(sd)} tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
