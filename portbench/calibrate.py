"""The readings that the limits of ``correct`` are set from, many seeds in
one process (the kernels built and warm once):

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,13 [--control] [--faults]

For each seed: the cell's dataset and weights, one global batch of the
port's eval at the cell's own size, and for the sample of its episodes that
a run would check (``check.sample``), the numbers of ``check.verify``
(the port against the float32 reference).  On the first of those episodes,
``--control`` reads the same numbers of the control (the reference with
every product's operands in float8, put in the port's place;
``check.control_readings``), and ``--faults`` those of each fault of
``FAULTS`` planted in the float32 reference put in the port's place.  One
JSON line a seed; ``--out`` appends them to a file too."""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from unittest import mock

import torch


@contextlib.contextmanager
def _steps_cut(keep):
    """Each adaptation runs only the first ``keep(n)`` of its ``n`` steps."""
    from portbench.reference import episode as ref

    own = ref.member_steps

    def cut(d, member, batch):
        steps = own(d, member, batch)
        return steps[: keep(len(steps))]

    with mock.patch.object(ref, "member_steps", cut):
        yield


class _AdamWithoutBiasCorrection(torch.optim.Adam):
    """torch-Adam with both bias corrections dropped: step ``t``'s rate is
    scaled by ``(1 - b1**t) / sqrt(1 - b2**t)``, which cancels them (eps
    aside)."""

    def step(self, closure=None):
        for group in self.param_groups:
            group.setdefault("base_lr", group["lr"])
            state = self.state.get(group["params"][0], {})
            t = 1 + int(state.get("step", 0))
            b1, b2 = group["betas"]
            group["lr"] = group["base_lr"] * (1 - b1**t) / math.sqrt(1 - b2**t)
        return super().step(closure)


@contextlib.contextmanager
def _bias_correction_dropped():
    with mock.patch.object(torch.optim, "Adam", _AdamWithoutBiasCorrection):
        yield


#: faults of the adaptation that act after its first step
FAULTS = {
    "frozen_after_step_1": lambda: _steps_cut(lambda n: 1),
    "half_the_steps": lambda: _steps_cut(lambda n: n // 2),
    "bias_correction_dropped": _bias_correction_dropped,
}


def calibrate(name: str, seed: int, control: bool, faults: bool = False, **kw) -> dict:
    from portbench import check, run

    t0 = time.perf_counter()
    p = run.prepare(name, seed, **kw)
    p.a.iter_num = p.global_batch
    res = run.evaluate(p, None)
    t1 = time.perf_counter()
    batch, picks = check.sample(seed, 1, p.n_shards, p.lanes, check.CHECK_EPISODES)
    readings, episodes = check.verify(p, res.scores, 0, picks)
    run.free_program(p)
    t2 = time.perf_counter()
    out = {"cell": name, "seed": seed, "episodes": episodes, "program": readings,
           "accs": [res.accs[i] for i in episodes], "program_s": t1 - t0, "check_s": t2 - t1}
    if control:
        out["control"] = check.control_readings(p, episodes[0])
        out["control_s"] = time.perf_counter() - t2
    if faults:
        out["faults"] = {f: check.control_readings(p, episodes[0], "float32", plant) for f, plant in FAULTS.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(calibrate(args.workload, seed, args.control, args.faults))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
