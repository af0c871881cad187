"""mft_tpu_torch — the PyTorch/CUDA port of mft_tpu for one NVIDIA H100.

A second package beside the JAX one: same sub-package names (``ops``,
``core``, ``models``, ``methods``, ``train``, ``data``, ``cli``), written in
PyTorch idiom (NCHW activations, OIHW conv weights, ``[out, in]`` linear
weights, explicit ``device`` and ``torch.Generator`` everywhere).  The TPU's
Pallas kernels become hand-written Hopper kernels under ``kernels/``.

It imports nothing of ``jax`` or ``mft_tpu``; the tests hold it against the
JAX package on shared numpy inputs.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default) raises
    when no card is present instead of quietly running on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU"
        )
    return dev
