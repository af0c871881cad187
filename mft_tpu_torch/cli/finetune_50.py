"""50-shot cross-domain eval of the port (counterpart of
``mft_tpu/cli/finetune_50.py``; reference finetune_50.py).

The reference's 50-shot driver differs from finetune.py in the GnnNet head
it imports: gnnnet_copy, whose support embeddings are pair-averaged after
the projector, so a 50-shot graph has 5 * (25 + 1) = 130 nodes
(finetune_50.py:20).  ``cli/finetune.py`` selects that head at
``--n_shot >= 50``; this wrapper pins ``--n_shot 50`` unless the caller
gave one, and delegates.

Run: ``python -m mft_tpu_torch.cli.finetune_50 --method all --use_pallas
--inner_scan fused --test_dataset CropDisease --fine_tune_epoch 5 --gen_examples 17``
"""

from __future__ import annotations

import sys

from mft_tpu_torch.cli import finetune as finetune_cli


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--n_shot") for a in argv):
        argv += ["--n_shot", "50"]
    return finetune_cli.main(argv)


if __name__ == "__main__":
    main()
