"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``).

Each kernel module keeps a ``LAUNCHES`` count that its wrapper bumps where
it launches the kernel, so a run can show which kernels its path went
through.
"""

from __future__ import annotations

from mft_tpu_torch.kernels import edge_mlp, fused_inner_scan

#: kernel name -> module holding its wrapper and LAUNCHES count
MODULES = {"edge_abs_diff_matmul": edge_mlp, "fused_inner_scan": fused_inner_scan}


def launch_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in MODULES.items()}


def reset_launch_counts() -> None:
    for mod in MODULES.values():
        mod.LAUNCHES = 0
