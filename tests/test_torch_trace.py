"""The eval's span recorder (``mft_tpu_torch/utils/metrics.py``: ``span``,
``count``, ``eval_batch``, ``eval_batches``) on the CPU:

* spans nest, name their parent and their lane batch, and open profiler
  ranges whose start and end lie within 1 ms of the span's on the
  profiler's own clock;
* a span or counter outside a lane batch, or in another thread, is kept
  nowhere;
* ``adapt.lane_steps`` counts each lane's step once: the eager loops
  (``inner_fit``, ``inner_fit_pair``, ``inner_fit_epochwise``) and the fused
  scan's plain CPU route; ``scan.grid_steps`` counts the scan's step
  programs run one after another, each lane's step on the CPU route, and
  its reader ``phase.scan_grid_steps`` divides the window's by its episodes;
* the driver's ``evaluate``: its ``eval:batch`` spans tile the loop, each
  holds its waits, stack, run and report, ``batch_seconds`` are the
  ``eval:run`` spans, and ``episodes_per_sec`` is the rate after the first
  batch;
* the benchmark's cells through ``portbench.run.run_cell`` with
  ``--trace 1`` at a small size: the readers of the recorder report, and
  the counters read the traffic's steps an episode.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mft_tpu_torch.kernels import fused_inner_scan as tfis
from mft_tpu_torch.train import inner_loop as til
from mft_tpu_torch.train import optimizers as topt
from mft_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_name(batch):
    return {s.name: s for s in batch.spans}


def test_spans_nest_with_their_parents_and_batch():
    with metrics.eval_batch(0, 3) as b:
        with metrics.span("probe:outer") as outer:
            with metrics.span("probe:inner") as inner:
                metrics.count("probe.n", 2)
            metrics.count("probe.n", 3)
    spans = _by_name(b)
    assert [s.name for s in b.spans] == ["probe:inner", "probe:outer", "eval:batch"]  # in closing order
    assert (inner.parent, outer.parent, spans["eval:batch"].parent) == ("probe:outer", "eval:batch", None)
    assert inner.batch == outer.batch == 0
    assert b.start_ns <= outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns <= b.end_ns
    assert b.totals["probe:inner"] == inner.end_ns - inner.start_ns and b.totals["eval:batch"] == b.end_ns - b.start_ns
    assert b.counters == {"probe.n": 5} and (b.index, b.episodes) == (0, 3)
    assert metrics.eval_batches() == [b]


def test_spans_outside_a_batch_or_in_another_thread_are_dropped():
    with metrics.span("probe:before"):
        metrics.count("probe.n", 1)
    with metrics.eval_batch(0, 1) as b0:
        pass
    with metrics.eval_batch(1, 1) as b1:
        def elsewhere():
            with metrics.span("probe:thread"):
                metrics.count("probe.n", 7)

        t = threading.Thread(target=elsewhere)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    with metrics.span("probe:after"):
        metrics.count("probe.n", 1)
    assert metrics.eval_batches() == [b0, b1]
    assert [s.name for s in b1.spans] == ["eval:batch"] and b1.counters == {}
    with metrics.eval_batch(0, 1) as again:  # batch 0 starts a new call's record
        pass
    assert metrics.eval_batches() == [again]


def test_the_recorder_keeps_its_newest_batches():
    rec = metrics.Recorder(keep=3)
    for k in range(5):
        with rec.eval_batch(k, 1):
            rec.count("probe.n", k)
    assert [(b.index, b.counters["probe.n"]) for b in rec.eval_batches()] == [(2, 2), (3, 3), (4, 4)]


def test_a_span_lines_up_with_its_profiler_range():
    names = ("probe:a", "probe:b", "probe:c")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.eval_batch(0, 1) as b:
            for name in names:
                with metrics.span(name):
                    torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in names + ("eval:batch",)}
    spans = _by_name(b)
    assert set(events) == set(spans)
    for name, s in spans.items():
        e = events[name]
        assert abs(e.start_ns() - s.start_ns) < 1_000_000, name
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1_000_000, name


def _loss(feats, labels):
    """A lane-stacked linear model's per-lane masked CE over ``feats [L, n, f]``."""
    lanes = torch.arange(feats.shape[0])[:, None]

    def loss(p, idx, w):
        logits = torch.einsum("lbf,lfc->lbc", feats[lanes, idx], p["w"])
        ce = torch.nn.functional.cross_entropy(logits.flatten(0, 1), labels[idx].flatten(), reduction="none")
        return (ce.reshape(idx.shape) * w).sum(-1) / w.sum()

    return loss


def test_the_eager_loops_count_lane_steps():
    gen = torch.Generator().manual_seed(0)
    lanes, cfg, cfg2 = 3, til.InnerLoopCfg(2, 5, 7), til.InnerLoopCfg(1, 4, 7)
    feats, labels = torch.randn(lanes, 7, 4, generator=gen), torch.randint(0, 3, (7,), generator=gen)
    p0 = {"w": torch.zeros(lanes, 4, 3)}
    gens = [torch.Generator().manual_seed(i) for i in range(lanes)]
    loss = _loss(feats, labels)
    with metrics.eval_batch(0, lanes) as b:
        til.inner_fit(loss, p0, topt.torch_adam(0.01), gens, cfg)
    assert b.counters["adapt.lane_steps"] == lanes * cfg.n_steps == 12
    with metrics.eval_batch(0, lanes) as b:
        til.inner_fit_pair(loss, p0, topt.torch_adam(0.01), gens, cfg, loss, p0, topt.torch_adam(0.01), gens, cfg2)
    assert b.counters["adapt.lane_steps"] == lanes * (cfg.n_steps + cfg2.n_steps) == 18
    banks = {"x": feats, "y": labels.expand(lanes, -1)}
    chunk_loss = lambda p, c, w: (torch.nn.functional.cross_entropy(
        torch.einsum("lbf,lfc->lbc", c["x"], p["w"]).flatten(0, 1), c["y"].flatten(), reduction="none"
    ).reshape(c["y"].shape) * w).sum(-1)
    with metrics.eval_batch(0, lanes) as b:
        til.inner_fit_epochwise(chunk_loss, p0, topt.torch_adam(0.01), gens, cfg, banks)
    assert b.counters["adapt.lane_steps"] == lanes * cfg.n_steps


def test_the_scan_counts_lane_steps_on_its_cpu_route():
    geom = tfis.BlockGeom(h_in=4, c_in=16, c_out=32, stride=2, batch=5)
    gen = torch.Generator().manual_seed(0)
    lanes, cfg = 2, til.InnerLoopCfg(1, 5, 12)
    p0 = {k: (torch.randn((lanes,) + v, generator=gen) * 0.1).to(torch.bfloat16)
          for k, v in tfis.param_shapes(geom).items()}
    banks = torch.randn(lanes, 12, 4, 4, 16, generator=gen).to(torch.bfloat16)
    y = torch.randint(0, 3, (12,), generator=gen)
    idx, w = til.lane_schedule([torch.Generator().manual_seed(i) for i in range(lanes)], cfg)
    with metrics.eval_batch(0, lanes) as b:
        tfis.fused_inner_scan_lanes(p0, banks, y, idx, w, geom=geom, lr=0.01)
    assert b.counters == {"adapt.lane_steps": lanes * cfg.n_steps, "scan.grid_steps": lanes * cfg.n_steps}


@pytest.mark.parametrize("lanes", [1, 3])
def test_the_scan_counts_grid_steps_on_its_cpu_route(lanes):
    """The plain version runs the lanes in turn, so each lane's step is a
    step program of its own: L x T in the batch's record, added up over
    two calls, and nothing outside a batch."""
    geom = tfis.BlockGeom(h_in=4, c_in=16, c_out=32, stride=2, batch=5)
    gen = torch.Generator().manual_seed(1)
    cfg = til.InnerLoopCfg(1, 5, 10)
    p0 = {k: (torch.randn((lanes,) + v, generator=gen) * 0.1).to(torch.bfloat16)
          for k, v in tfis.param_shapes(geom).items()}
    banks = torch.randn(lanes, 10, 4, 4, 16, generator=gen).to(torch.bfloat16)
    y = torch.randint(0, 3, (10,), generator=gen)
    idx, w = til.lane_schedule([torch.Generator().manual_seed(i) for i in range(lanes)], cfg)
    tfis.fused_inner_scan_lanes(p0, banks, y, idx, w, geom=geom, lr=0.01)  # outside a batch: kept nowhere
    with metrics.eval_batch(0, lanes) as b:
        tfis.fused_inner_scan_lanes(p0, banks, y, idx, w, geom=geom, lr=0.01)
        tfis.fused_inner_scan_lanes(p0, banks, y, idx[:, :1], w[:1], geom=geom, lr=0.01)
    assert b.counters["scan.grid_steps"] == lanes * (cfg.n_steps + 1)
    assert metrics.eval_batches() == [b]


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", os.path.join(REPO, "portbench", "metrics",
                                                                                 name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_grid_steps_reader_on_batch_records():
    """``phase.scan_grid_steps``: the counter summed over batches 1 to
    ``window_batches`` (batch 0, the warm-up, and the batches after the
    window left out) over those batches' episodes; None with no counter in
    the window or fewer batches than the window holds."""
    read = _reader("phase.scan_grid_steps")
    for k, (episodes, steps) in enumerate([(20, 500), (20, 25), (20, 25), (7, 25), (20, 99)]):
        with metrics.eval_batch(k, episodes):
            metrics.count("scan.grid_steps", steps)
            metrics.count("adapt.lane_steps", 500 * episodes)
    assert read({"window_batches": 3}) == 75 / 47
    assert read({"window_batches": 2}) == 50 / 40
    assert read({"window_batches": 5}) is None  # the records hold batches 1 to 4 only
    with metrics.eval_batch(0, 20):
        pass
    with metrics.eval_batch(1, 20):
        metrics.count("adapt.lane_steps", 10_000)
    assert read({"window_batches": 1}) is None


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    import chip_smoke

    d = tmp_path_factory.mktemp("ckpts")
    return chip_smoke.write_checkpoints(torch, str(d))


def test_evaluate_tiles_its_loop_with_lane_batches(ckpts, capsys):
    from mft_tpu_torch.cli import finetune

    argv = ["--device", "cpu", "--method", "gnnnet", "--train_aug", "--save_iter", "600", "--use_pallas",
            "--inner_scan", "fused", "--test_dataset", "synthetic", "--image_size", "32", "--n_shot", "5", "--n_query",
            "1", "--gen_examples", "1", "--fine_tune_epoch", "1", "--iter_num", "5", "--eval_batch", "2", "--dtype",
            "float32", "--inner_param_dtype", "float32", "--paths_json", ckpts]
    res = finetune.main(argv)
    assert "episodes/sec = " in capsys.readouterr().out
    batches = metrics.eval_batches()
    assert [(b.index, b.episodes) for b in batches] == [(0, 2), (1, 2), (2, 1)]
    for b, prev in zip(batches[1:], batches):
        assert 0 <= b.start_ns - prev.end_ns < 10_000_000  # the loop's bookkeeping between batches
    for b, seconds in zip(batches, res.batch_seconds):
        spans = {s.name for s in b.spans}
        assert {"input:wait", "input:stack", "eval:run", "input:to_device", "eval:report", "adapt:gnn"} <= spans
        assert all(b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns for s in b.spans)
        assert sum(s.parent == "eval:batch" for s in b.spans if s.name == "input:wait") == b.episodes
        assert seconds == b.totals["eval:run"] / 1e9
        inside = sum(b.totals[n] for n in ("input:wait", "input:stack", "eval:run", "eval:report"))
        assert 0.9 * b.totals["eval:batch"] <= inside <= b.totals["eval:batch"]
        steps = 1 * (1 + 3) * 5 * 5 // 5  # an epoch over the bank of the clean support x3 and one replica
        assert b.counters["adapt.lane_steps"] == b.episodes * steps
    assert res.episodes_per_sec == 3 / ((batches[-1].end_ns - batches[0].end_ns) / 1e9)


#: a traced run of a cell at a small size (one shot and one query a class, one lane a batch, f32), in a fresh
#: interpreter: the benchmark refuses a process that has loaded JAX, as this suite's has
_CELL_RUN = """
import json, sys
import torch
torch.set_num_threads(1)
from portbench import run
from portbench.tests.conftest import SMALL
small = {**SMALL, "n_shot": 1, "n_query": 1, "eval_batch": 1, "extra_flags": ["--dtype", "float32", "--inner_param_dtype", "float32"]}
res = run.run_cell(sys.argv[1], 2**31 + 12345, 0.01, True, device="cpu", overrides=small)
print(json.dumps({"small": small, **res}))
"""


@pytest.mark.parametrize("cell", ["all.5shot.e20", "dampnet.5shot.e20"])
def test_the_benchmark_reads_the_recorder(cell):
    """The recorder's five metrics are read in a traced run of the cell,
    and the counters hold the traffic's steps an episode: the scan's epochs
    over its bank, and in ``adapt.lane_steps`` of ``all`` the linear
    member's 20 epochs over the clean support besides."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _CELL_RUN, cell], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    m, small = {k: v["value"] for k, v in res["metrics"].items()}, res["small"]
    assert {"input.wait_share", "input.stage_share", "phase.adapt_span_ms", "phase.adapt_lane_steps",
            "phase.scan_grid_steps"} <= set(m)
    assert 0 < m["input.wait_share"] + m["input.stage_share"] < 1 and m["phase.adapt_span_ms"] > 0
    shots = small["n_shot"] * 5
    steps = small["fine_tune_epoch"] * (small["gen_examples"] + 3) * shots // 5
    assert m["phase.scan_grid_steps"] == steps  # one lane a batch: the scan's steps, on the CPU lane by lane
    if cell.startswith("all"):
        steps += 20 * shots // 5
    assert m["phase.adapt_lane_steps"] == steps
