"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: ``mft_tpu_torch`` is not ``mft_tpu``), and the reference
loads nothing of the port."""

import subprocess
import sys

from portbench import isolation
from portbench.tests.conftest import ROOT


def test_forbidden_names_compared_whole():
    assert isolation.loaded_forbidden(["mft_tpu_torch.cli.finetune", "torch", "numpy"]) == []
    assert isolation.loaded_forbidden(["mft_tpu.cli", "jax._src.core", "jaxlib", "flax"]) == ["flax", "jax", "jaxlib",
                                                                                              "mft_tpu"]


def test_reference_sources_import_nothing_of_the_port():
    assert isolation.reference_imports() == {}


def test_reference_scan_sees_a_forbidden_import(tmp_path):
    (tmp_path / "bad.py").write_text("import numpy\nfrom mft_tpu_torch.models import backbone\nimport jax.numpy\n")
    assert isolation.reference_imports(str(tmp_path)) == {"bad.py": ["jax", "mft_tpu_torch"]}


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, env={"PATH": "/usr/bin:/bin"})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("import portbench.reference.episode, portbench.check")
    assert not loaded & {"mft_tpu_torch", "mft_tpu", "jax", "jaxlib", "flax"}


def test_harness_and_port_load_no_jax():
    loaded = _loaded_after("import portbench.run, portbench.calibrate, portbench.worker\n"
                           "import mft_tpu_torch.cli.finetune, mft_tpu_torch.convert")
    assert "mft_tpu_torch" in loaded
    assert not loaded & {"mft_tpu", "jax", "jaxlib", "flax"}
    assert isolation.check("now") == [] or all("is loaded" in p for p in isolation.check("now"))
