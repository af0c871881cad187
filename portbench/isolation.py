"""What the benchmark may not load: JAX and the JAX package, in the process
that runs a cell (compared by whole top-level module names, since the
port's ``mft_tpu_torch`` begins with ``mft_tpu``), and anything of the port
in the reference's sources."""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "mft_tpu")
REFERENCE_FORBIDDEN = FORBIDDEN + ("mft_tpu_torch",)


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def reference_imports(root: str | None = None) -> dict:
    """``{file: [forbidden top-level names it imports]}`` over the
    reference's sources (the ``portbench/reference`` package)."""
    root = root or os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference")
    bad = {}
    for name in sorted(os.listdir(root)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(root, name)) as f:
            tree = ast.parse(f.read(), name)
        found = set()
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                mods = [node.module]
            found |= {m.split(".")[0] for m in mods} & set(REFERENCE_FORBIDDEN)
        if found:
            bad[name] = sorted(found)
    return bad


def check(where: str) -> list:
    """Problems found ``where`` (empty when none): forbidden modules loaded,
    or a reference source importing the port or JAX."""
    problems = [f"{where}: module {m!r} is loaded" for m in loaded_forbidden()]
    problems += [f"{where}: portbench/reference/{f} imports {m}" for f, m in reference_imports().items()]
    return problems
