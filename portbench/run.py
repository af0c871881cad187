"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the repo root.  The cell (``BENCHMARK.json``'s ``workloads``) names a
configuration (``portbench/configs/<config>.json``: the driver flags, the
models' state-dict parts, the reference's recipe) and a traffic mix
(``portbench/traffic/<traffic>.json``: episode geometry, lanes, dataset
size, whether the eval spans every card); its limits are
``portbench/limits/<cell>.json`` and its per-layer readers
``portbench/metrics/<metric>.py``.

One run: the dataset and the weights from ``--seed``; then one call of the
port's eval driver (``mft_tpu_torch.cli.finetune.evaluate``, the episode
stream, the lane batches and, on a mesh, the shard workers) on a practically
endless run of episodes.  The driver's ``logger`` hears each episode right
after its batch is synchronized, so the harness's logger stamps each batch's
end: the first batch is warm-up (``setup_s`` runs from the process's start
to its end), the window runs from there to the end of the first batch that
ends ``--seconds`` or later, and the logger then stops the loop (with
``--trace 1`` after ``PROFILE_BATCHES`` more batches under the profiler).
After the window the port's state is freed and the plain reference scores a
sample of the window's episodes again; the gaps decide ``correct``.

The last line of standard output is the result's JSON; the numbers compared,
with their limits, close both it (``checks``) and standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def process_start() -> float:
    """The process's start on the ``time.time`` clock (from ``/proc``;
    the first line of this module where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()

#: the lane batches of a ``--trace 1`` run that run under the profiler, after the window
PROFILE_BATCHES = 1


class WindowClosed(Exception):
    """Raised by :class:`BatchClock` to end the driver's episode loop."""


class BatchClock:
    """The driver's ``logger``: stamps the end of each global batch (the
    first episode of a batch is logged right after the batch is
    synchronized), closes the window at the first batch end ``seconds``
    after the warm-up batch's, then lets ``profile_batches`` more batches
    run (``on_close`` before them, ``on_done`` after) and stops the loop."""

    def __init__(self, global_batch: int, seconds: float, profile_batches: int = 0, on_close=None, on_done=None):
        self.global_batch, self.seconds, self.profile_batches = global_batch, seconds, profile_batches
        self.on_close, self.on_done = on_close, on_done
        self.ends, self.window_batches, self.traced_from = [], None, None

    def _write(self, record: dict) -> None:
        if record.get("kind") != "episode" or record["index"] % self.global_batch:
            return
        now = time.perf_counter()
        self.ends.append(now)
        k = len(self.ends) - 1
        if k == 0:
            return
        if self.window_batches is None:
            if now - self.ends[0] < self.seconds:
                return
            self.window_batches = k
            if self.profile_batches:
                self.on_close()
                self.traced_from = time.perf_counter()  # the profiler's start-up is no batch's
                return
            raise WindowClosed
        if k - self.window_batches >= self.profile_batches:
            self.on_done()
            raise WindowClosed

    @property
    def window_seconds(self) -> float:
        return self.ends[self.window_batches] - self.ends[0]


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and the per-layer metrics it reports."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    base = os.path.join(root, "portbench")
    return {"cell": cell, "config": load_json(base, "configs", cell["config"] + ".json"),
            "traffic": load_json(base, "traffic", cell["traffic"] + ".json"),
            "limits": load_json(base, "limits", name + ".json"), "end_to_end": bench["end_to_end"], "per_layer": per_layer,
            "base": base}


def reference_cell(config: dict, traffic: dict) -> dict:
    """What the reference needs to know of an episode: the configuration's
    recipe and backbone shape, the traffic's geometry."""
    from portbench import inputs

    keys = ("n_way", "n_shot", "n_query", "image_size", "gen_examples", "fine_tune_epoch", "augment")
    stage_sizes, widths = inputs.backbone_of(config)
    return {**config["reference"], **{k: traffic[k] for k in keys}, "stage_sizes": stage_sizes, "widths": widths}


def program_argv(config: dict, traffic: dict, seed: int, device: str, iter_num: int) -> list:
    """The driver's flags: the configuration's, the traffic's geometry, then
    ``extra_flags`` (a test's, which win)."""
    geometry = [("--test_n_way", "n_way"), ("--n_shot", "n_shot"), ("--n_query", "n_query"),
                ("--image_size", "image_size"), ("--gen_examples", "gen_examples"),
                ("--fine_tune_epoch", "fine_tune_epoch"), ("--eval_batch", "eval_batch")]
    return (config["flags"] + [str(v) for flag, key in geometry for v in (flag, traffic[key])]
            + ["--test_dataset", traffic["test_dataset"], "--device", device, "--seed", str(seed), "--iter_num",
               str(iter_num)] + traffic.get("extra_flags", []))


def program_models(sd_models: dict, config: dict, bcfg, device) -> dict:
    """The port's model trees from the benchmark's state dicts, through the
    port's state-dict forms (``convert.from_state_dict``, the path a
    reference ``.tar`` takes), each from its own copy of the tensors."""
    import torch

    from mft_tpu_torch import convert

    out = {}
    for name in config["models"]:
        p, s = convert.from_state_dict({k: v.clone() for k, v in sd_models[name].items()}, bcfg, device=device)
        if name == "baseline":
            out[name] = (p["feature"], s)
        elif name == "gnn":
            out[name] = (p["feature"], s, {"fc": p["fc"], "gnn": p["gnn"]})
        elif name == "dampnet":
            state = {"proto_mean": sd_models["proto_mean"].clone().to(device),
                     "proto_std": sd_models["proto_std"].clone().to(device),
                     "initialized": torch.ones((), dtype=torch.bool, device=device)}
            out[name] = (p["feature"], s, {k: v for k, v in p.items() if k != "feature"}, state)
        else:
            raise ValueError(f"unknown model {name!r} in the configuration")
    return out


def _evaluate_frame(tb, code):
    while tb is not None:
        if tb.tb_frame.f_code is code:
            return tb.tb_frame.f_locals
        tb = tb.tb_next
    raise RuntimeError("the eval driver's loop was stopped outside evaluate(); its episodes cannot be read")


def _read_metric(name: str, ctx: dict, base: str = HERE):
    """Metric ``name``'s reading, by ``<base>/metrics/<name>.py``'s ``read(ctx)``
    (None: nothing to read in this run)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", os.path.join(base, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Prepared:
    """One seed's set-up of a cell: the driver's parsed flags and configs,
    the dataset and its manifest, the benchmark's state dicts and the port's
    models made from them."""


def prepare(name: str, seed: int, *, device: str = "cuda", mesh_devices=None, overrides: dict | None = None,
            root: str = ROOT, models: bool = True) -> Prepared:
    """Everything a run of cell ``name`` hands to the port and to the
    reference.  ``device``/``mesh_devices``/``overrides`` (keys of the
    traffic file) let the tests drive a cell on the CPU at a small size."""
    import numpy as np
    import torch

    from mft_tpu_torch import config as cfg_mod
    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.data import registry
    from mft_tpu_torch.data.manifests import Manifest
    from mft_tpu_torch.methods import dampnet as dn
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.models import backbone as bb
    from portbench import inputs

    p = Prepared()
    p.files = load_cell(name, root)
    p.config, p.limits = p.files["config"], p.files["limits"]
    p.traffic = {**p.files["traffic"], **(overrides or {})}
    mesh = p.traffic["mesh"]
    p.dev = torch.device(device if (mesh or device == "cpu") else f"{device}:0")
    p.mesh_devices = mesh_devices
    p.lanes = p.traffic["eval_batch"]
    p.n_shards = (len(mesh_devices) if mesh_devices
                  else (torch.cuda.device_count() if mesh and p.dev.type == "cuda" else 1))
    p.global_batch = p.lanes * p.n_shards
    a = cfg_mod.parse_finetune_args(program_argv(p.config, p.traffic, seed, str(p.dev), p.global_batch * 100_000))
    # as the driver's main() sets up its eval
    if p.dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
    np.random.seed(a.seed % 2**32)
    p.a = a
    p.spec = EpisodeSpec(a.test_n_way, a.n_shot, a.n_query if a.n_query > 0 else 15)
    p.bcfg = bb.MODEL_REGISTRY[a.model]()._replace(compute_dtype=a.dtype)
    stated, port = inputs.backbone_of(p.config), (tuple(p.bcfg.stage_sizes), tuple(p.bcfg.widths))
    if stated != port:
        raise ValueError(f"configuration {p.config['name']!r} states stage_sizes {list(stated[0])}, widths "
                         f"{list(stated[1])}, but its --model {a.model} is stage_sizes {list(port[0])}, widths "
                         f"{list(port[1])}: the port would run another network than the reference")
    p.gcfg = gn.GnnNetCfg(feat_dim=p.bcfg.feat_dim, n_way=a.test_n_way, n_support=a.n_shot,
                          support_compress=2 if a.n_shot >= 50 else 1, use_pallas=a.use_pallas)
    p.dcfg = dn.method_cfg(a.method, p.bcfg.feat_dim, a.test_n_way, a.n_shot) if a.method.startswith("dampnet") else None
    p.aug_cfg = registry.get(a.test_dataset).eval_aug._replace(image_size=a.image_size)
    p.images, p.labels = inputs.make_dataset(seed, p.traffic["data"])
    p.n_classes = p.traffic["data"]["classes"]
    p.manifest = Manifest(list(p.images), p.labels, p.n_classes)
    p.weights_dev = p.dev if p.dev.type == "cuda" else torch.device("cpu")
    if p.weights_dev.type == "cuda" and p.weights_dev.index is None:
        p.weights_dev = torch.device("cuda:0")
    p.sd_models = inputs.make_models(seed, p.config, a.test_n_way, p.weights_dev)
    p.models = program_models(p.sd_models, p.config, p.bcfg, p.weights_dev) if models else None
    p.ref_cell = reference_cell(p.config, p.traffic)
    p.seed = seed
    return p


def evaluate(p: Prepared, logger, keep_scores: bool = True):
    """The port's eval driver on ``p``, its worker set-up on a mesh wrapped
    by :func:`portbench.worker.shard_worker` for the call's length."""
    from mft_tpu_torch.cli import finetune
    from portbench import worker

    own = finetune._shard_worker
    finetune._shard_worker = worker.shard_worker
    try:
        return finetune.evaluate(p.a, p.models, p.manifest, aug_cfg=p.aug_cfg, bcfg=p.bcfg, gcfg=p.gcfg, spec=p.spec,
                                 device=p.dev, dcfg=p.dcfg, logger=logger, mesh_devices=p.mesh_devices,
                                 keep_scores=keep_scores)
    finally:
        finetune._shard_worker = own


def free_program(p: Prepared) -> None:
    """Drop the port's models and caches before the reference runs."""
    import torch

    p.models = None
    gc.collect()
    if p.dev.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, plant=None, **kw) -> dict:
    """One run of cell ``name``; returns the result's dict (with ``checks``
    last).  ``kw``: :func:`prepare`'s; ``plant``, a context manager factory,
    breaks the port under the run and its check (the tests' planted
    faults)."""
    import contextlib

    import torch

    from mft_tpu_torch.cli import finetune
    from portbench import check, worker, yardstick

    p = prepare(name, seed, **kw)
    traffic, dev, global_batch = p.traffic, p.dev, p.global_batch
    stack = contextlib.ExitStack()
    run_dir = tempfile.mkdtemp(prefix="portbench-run-")
    os.environ[worker.RUN_DIR_ENV] = run_dir
    prof = {}

    def start_profile():
        if p.n_shards > 1:
            open(os.path.join(run_dir, "profile"), "w").close()
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof["p"] = profile(activities=acts)
        prof["p"].start()

    def stop_profile():
        if "p" in prof:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            prof["p"].stop()

    clock = BatchClock(global_batch, seconds, PROFILE_BATCHES if trace else 0, start_profile, stop_profile)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if plant:
        stack.enter_context(plant())
    try:
        evaluate(p, clock)
        raise RuntimeError("the eval ran all its episodes before the window closed")
    except WindowClosed as stop:
        loop = _evaluate_frame(stop.__traceback__, finetune.evaluate.__code__)
        scores, batch_seconds = list(loop["scores"]), list(loop["batch_seconds"])
        shard_seconds = [list(s) for s in loop["shard_seconds"]]
        del loop, stop
    forbidden = isolation_problems("after the window")

    wb = clock.window_batches
    window_s = clock.window_seconds
    window_eps = wb * global_batch
    setup_s = clock.ends[0] - time.perf_counter() + time.time() - process_start()
    peaks = [load_json(run_dir, f)["peak"] for f in os.listdir(run_dir) if f.startswith("peak-")]
    if p.n_shards > 1:
        memory_peak = max(peaks, default=0)
    else:
        memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = yardstick.trace_summary(prof.pop("p")) if "p" in prof else None
    workers = [load_json(run_dir, f) for f in sorted(os.listdir(run_dir)) if f.startswith("trace-")]
    shutil.rmtree(run_dir, ignore_errors=True)
    os.environ.pop(worker.RUN_DIR_ENV, None)

    batch, picks = check.sample(seed, wb, p.n_shards, p.lanes, check.CHECK_EPISODES)
    readings, episodes = check.verify(p, scores, batch, picks)
    stack.close()  # a planted fault stays in the port until its state is checked
    free_program(p)
    window_scores = torch.stack(scores[global_batch : global_batch * (wb + 1)])
    failed = int((~torch.isfinite(window_scores)).flatten(1).any(dim=1).sum())
    checks = {k: {"value": readings[k], "limit": v["limit"]} for k, v in p.limits.items()}
    correct = not forbidden and failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    checks["episodes_checked"] = {"value": episodes, "limit": "drawn from the seed"}
    if forbidden:
        checks["forbidden_modules"] = {"value": forbidden, "limit": []}

    ctx = {"config": p.config, "traffic": traffic, "cards": p.n_shards, "lanes": p.lanes,
           "global_batch": global_batch, "window_seconds": window_s, "window_batches": wb,
           "window_episodes": window_eps, "batch_seconds": batch_seconds[1 : wb + 1],
           "shard_seconds": shard_seconds[1 : wb + 1], "trace": summary,
           "profiled_batches": PROFILE_BATCHES if summary else 0,
           "profiled_episodes": PROFILE_BATCHES * global_batch if summary else 0,
           "flops_per_episode": yardstick.episode_flops(p.config, traffic), "yardstick": yardstick}
    metrics = {}
    if not trace:
        values = {"eval_episodes_per_s": window_eps / window_s, "setup_s": setup_s}
        for m in p.files["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in p.files["per_layer"]:
            v = _read_metric(m["name"], ctx, p.files["base"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": p.n_shards if dev.type == "cuda" else 0, "memory_peak_bytes": int(memory_peak),
                   "power_limit": power_limit() if dev.type == "cuda" else "n/a"}
    result = {"correct": bool(correct), "attempted": window_eps, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace:
        if summary is not None:
            device_info["busy_s"] = summary["busy_us"] / 1e6
            device_info["window_s"] = clock.ends[wb + PROFILE_BATCHES] - clock.traced_from
            result["breakdown"] = yardstick.breakdown(summary)
        elif workers:
            device_info["busy_s"] = sum(w["busy_us"] for w in workers) / 1e6 / len(workers)
            device_info["window_s"] = sum(w["seconds"] for w in workers) / len(workers)
            result["breakdown"] = workers[0]["breakdown"]
    result["checks"] = checks
    return result


def isolation_problems(where: str) -> list:
    from portbench import isolation

    return isolation.check(where)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    problems = isolation_problems("at start-up")
    if problems:
        print("\n".join(problems), file=sys.stderr)
        return 3
    spec_files = load_cell(args.workload)
    import torch

    chips = spec_files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    forbidden = isolation_problems("after the window")
    if forbidden:
        print("\n".join(forbidden), file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
