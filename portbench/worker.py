"""The mesh workers' side of a run.  The port's eval starts one worker
process a card (``parallel/mesh.py`` ``ShardPool``), which the parent's
profiler and memory counters cannot see.  The harness hands the pool
:func:`shard_worker` in place of the driver's own worker set-up; it runs
that set-up unchanged and wraps the lane-batch step it returns: after each
batch the worker writes its peak device memory, and once the parent has
created the run directory's ``profile`` file it profiles each further batch
and writes the trace's summary beside it."""

from __future__ import annotations

import json
import os
import time

#: the environment variable naming the run directory (inherited by the workers)
RUN_DIR_ENV = "PORTBENCH_RUN_DIR"


def _write(path: str, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def shard_worker(device, payload):
    import torch

    from mft_tpu_torch.cli import finetune
    from portbench import yardstick

    step = finetune._shard_worker(device, payload)
    run_dir = os.environ.get(RUN_DIR_ENV)
    if not run_dir:
        return step
    tag = str(device).replace(":", "")
    calls = [0]

    def traced(seeds):
        calls[0] += 1
        if not os.path.exists(os.path.join(run_dir, "profile")):
            out = step(seeds)
        else:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                out = step(seeds)
                seconds = time.perf_counter() - t0
            s = yardstick.trace_summary(prof)
            _write(os.path.join(run_dir, f"trace-{tag}-{calls[0]}.json"),
                   {"seconds": seconds, "busy_us": s["busy_us"], "breakdown": yardstick.breakdown(s)})
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        _write(os.path.join(run_dir, f"peak-{tag}.json"), {"peak": peak})
        return out

    return traced
