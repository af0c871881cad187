"""The harness is driven by data: a cell, its traffic and its limits are
files that it finds by name, so a cell added as files runs with no edit to
the code; and the window, the logger and the result's layout."""

import json
import pathlib
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


#: the per-layer readers that read the fused scan, which an eager cell does not run
SCAN_METRICS = ("fused_inner_scan_roofline", "phase.scan_grid_steps")


def add_resnet34_cell(root, cell: str, traffic_name: str, traffic: dict | None = None) -> dict:
    """Adds to the benchmark at ``root`` (``BENCHMARK.json`` and ``portbench/``)
    a ResNet34 ``--method all`` cell, as JSON files and entries alone: the
    configuration ``resnet34_gnnnet_all`` (He et al. 2016's 3-4-6-3 stages
    at the published widths, the eager inner loops: the scan takes no
    identity-shortcut block), the traffic ``traffic_name`` (written where
    ``traffic`` is given), the limits of ``all.5shot.e20``, and the cell in
    every per-layer metric of ``all.5shot.e20`` but the scan's.  Returns the
    configuration."""
    root = pathlib.Path(root)
    config = json.loads((root / "portbench/configs/resnet10_gnnnet_all.json").read_text())
    config = {k: v for k, v in config.items() if k != "scan"}
    flags = {"ResNet10": "ResNet34", "fused": "eager"}
    config.update(name="resnet34_gnnnet_all", model="ResNet34", stage_sizes=[3, 4, 6, 3],
                  flags=[flags.get(f, f) for f in config["flags"]],
                  models={m: ["resnet" if p == "resnet10" else p for p in parts] for m, parts in config["models"].items()},
                  source="He et al. 2016, arXiv:1512.03385, Table 1 (ResNet34); arXiv:2005.10544, finetune.py --method all")
    (root / "portbench/configs/resnet34_gnnnet_all.json").write_text(json.dumps(config))
    if traffic is not None:
        (root / f"portbench/traffic/{traffic_name}.json").write_text(json.dumps(traffic))
    shutil.copy(root / "portbench/limits/all.5shot.e20.json", root / f"portbench/limits/{cell}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": "resnet34_gnnnet_all", "traffic": traffic_name, "chips": 1,
                               "why": "a throwaway ResNet34 cell"})
    for m in bench["per_layer"]:
        if "all.5shot.e20" in m["workloads"] and m["name"] not in SCAN_METRICS:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return config


def _resnet34_root(tmp_path) -> tuple:
    """A copy of the benchmark with a ResNet34 cell at the small size."""
    root = tmp_path / "root"
    shutil.copytree(ROOT + "/portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT + "/BENCHMARK.json", root / "BENCHMARK.json")
    traffic = {**json.loads((root / "portbench/traffic/5shot.e20.json").read_text()), **SMALL}
    config = add_resnet34_cell(root, "all34.tiny", "tiny", traffic)
    return str(root), config, traffic


@pytest.mark.parametrize("fault", [None, "state_unchanged"])
def test_a_throwaway_resnet34_cell_runs_on_the_cpu(tmp_path, monkeypatch, fault):
    """A ResNet34 cell added as JSON files alone runs through the whole
    harness: the weights, the reference and the FLOP count follow its
    configuration's backbone; the sound run is correct, and with the step
    that returns its state unchanged planted it is not."""
    from portbench import yardstick
    from portbench.tests import test_portbench_faults as faults

    root, config, traffic = _resnet34_root(tmp_path)
    seen = {}
    own = run._read_metric

    def read(name, ctx, base):
        seen["flops"] = ctx["flops_per_episode"]
        return own(name, ctx, base)

    monkeypatch.setattr(run, "_read_metric", read)
    res = run.run_cell("all34.tiny", 2**31 + 123, 1.0, fault is None, device="cpu", root=root,
                       overrides={"extra_flags": ["--dtype", "float32", "--inner_param_dtype", "float32"]},
                       plant=getattr(faults, fault) if fault else None)
    if fault:
        assert not res["correct"], res["checks"]
        return
    assert res["correct"], res["checks"]
    want = yardstick.episode_flops(config, traffic)
    resnet10 = yardstick.episode_flops({**config, "stage_sizes": [1, 1, 1, 1]}, traffic)
    assert seen["flops"] == want and want > 2 * resnet10
    assert "mfu.eval" in res["metrics"] and not set(res["metrics"]) & set(SCAN_METRICS)


def test_a_configuration_that_is_not_its_model_is_refused(tmp_path):
    """A configuration whose ``stage_sizes`` are not those of its
    ``--model`` would hold the port against another network: refused."""
    root, _, _ = _resnet34_root(tmp_path)
    path = pathlib.Path(root) / "portbench/configs/resnet34_gnnnet_all.json"
    config = json.loads(path.read_text())
    path.write_text(json.dumps({**config, "stage_sizes": [2, 2, 2, 2]}))
    with pytest.raises(ValueError, match="--model ResNet34 is stage_sizes \\[3, 4, 6, 3\\]"):
        run.prepare("all34.tiny", 2**31 + 124, device="cpu", root=root, models=False)
