"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point, so it compiles with
``nvcc -shared`` in seconds (no PyTorch headers) into
``mft_tpu_torch/_build/lib<name>-<hash>.so``; the hash covers the source and
the flags, so an edited kernel rebuilds.  Nothing here runs at import time:
the tests import every module on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
]
#: every kernel source of the package
SOURCES = ("edge_mlp", "fused_inner_scan")

_loaded: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every stale source, one ``nvcc`` per source, all started
    together.  Returns ``{name: compiler log}`` (``-Xptxas -v`` prints
    registers, shared memory and spills).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if needed)."""
    if name not in _loaded:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
