"""50-shot training driver of the port (counterpart of
``mft_tpu/cli/train_50.py``; reference train_50.py).

The reference specializes the compressed GnnNet head (gnnnet_copy: support
embeddings pair-averaged after the projector, 130-node graphs) and a
``save_freq`` of 10 (train_50.py:41-66, 153-157).  ``cli/train.py`` selects
that head at ``--n_shot >= 50``; this wrapper pins ``--n_shot 50`` and
``--save_freq 10`` unless the caller gave them, and delegates.

Run: ``python -m mft_tpu_torch.cli.train_50 --method gnnnet --train_aug
--use_pallas --dataset miniImageNet --stop_epoch 400``
"""

from __future__ import annotations

import sys

from mft_tpu_torch.cli import train as train_cli


def main(argv=None, **kw):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--n_shot") for a in argv):
        argv += ["--n_shot", "50"]
    if not any(a.startswith("--save_freq") for a in argv):
        argv += ["--save_freq", "10"]  # train_50.py:53,66
    return train_cli.main(argv, **kw)


if __name__ == "__main__":
    main()
