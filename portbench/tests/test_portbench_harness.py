"""The harness is driven by data: a cell, its traffic and its limits are
files that it finds by name, so a cell added as files runs with no edit to
the code; and the window, the logger and the result's layout."""

import json
import shutil

import pytest

from portbench import run
from portbench.tests.conftest import ROOT, SMALL


def test_every_cell_of_the_benchmark_resolves():
    bench = run.load_json(ROOT, "BENCHMARK.json")
    for w in bench["workloads"]:
        files = run.load_cell(w["name"])
        assert files["config"]["name"] == w["config"]
        assert [m["name"] for m in files["end_to_end"]] == ["eval_episodes_per_s", "setup_s"]
        assert files["per_layer"] and set(files["limits"])


def _throwaway_root(tmp_path):
    """A copy of the benchmark with one more cell, its traffic file and its
    limits: the DampNet configuration over a mesh of two shards."""
    root = tmp_path / "root"
    shutil.copytree(ROOT + "/portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(open(ROOT + "/BENCHMARK.json").read())
    bench["workloads"].append({"name": "dampnet.tiny.mesh2", "config": "resnet10_dampnet_full_class",
                               "traffic": "tiny.mesh2", "chips": 1, "why": "a throwaway cell of the tests"})
    for m in bench["per_layer"]:
        if m["name"] in ("mfu.eval", "driver.outside_batch_share"):
            m["workloads"].append("dampnet.tiny.mesh2")
    bench["per_layer"].append({"name": "mesh.gather_ms", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "episode mesh", "moves": "eval_episodes_per_s",
                               "workloads": ["dampnet.tiny.mesh2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((root / "portbench/traffic/5shot.e20.json").read_text())
    traffic.update(SMALL, mesh=True)
    (root / "portbench/traffic/tiny.mesh2.json").write_text(json.dumps(traffic))
    shutil.copy(root / "portbench/limits/dampnet.5shot.e20.json", root / "portbench/limits/dampnet.tiny.mesh2.json")
    return str(root)


def test_a_cell_added_as_files_is_found(tmp_path):
    root = _throwaway_root(tmp_path)
    files = run.load_cell("dampnet.tiny.mesh2", root)
    assert files["traffic"]["mesh"] and files["traffic"]["image_size"] == 32
    assert {m["name"] for m in files["per_layer"]} == {"mfu.eval", "mesh.gather_ms", "driver.outside_batch_share"}


def test_the_window_closes_on_the_first_batch_end_past_the_seconds(monkeypatch):
    t = iter([0.0, 10.0, 15.0, 20.5, 30.0, 99.0])
    monkeypatch.setattr(run.time, "perf_counter", lambda: next(t))
    calls = []
    clock = run.BatchClock(4, 20.0, 1, lambda: calls.append("close"), lambda: calls.append("done"))
    for i in range(0, 16, 4):
        clock._write({"kind": "episode", "index": i, "acc": 0.0})
        clock._write({"kind": "episode", "index": i + 1, "acc": 0.0})  # not a batch's first: no stamp
    with pytest.raises(run.WindowClosed):
        clock._write({"kind": "episode", "index": 16, "acc": 0.0})
    assert clock.window_batches == 3 and clock.window_seconds == 20.5 and calls == ["close", "done"]


def test_a_throwaway_mesh_cell_runs_on_the_cpu(tmp_path):
    """The added cell through the whole harness: two shard workers on the
    CPU, the window, the reference's check, the metrics read from files."""
    root = _throwaway_root(tmp_path)
    res = run.run_cell("dampnet.tiny.mesh2", 2**31 + 99, 1.0, True, device="cpu", mesh_devices=["cpu", "cpu"],
                       root=root, overrides={"extra_flags": ["--dtype", "float32", "--inner_param_dtype", "float32"]})
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] % 4 == 0 and res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["metrics"]) == {"mfu.eval", "mesh.gather_ms", "driver.outside_batch_share"}
    assert len(res["checks"]["episodes_checked"]["value"]) == 2  # one of each shard
