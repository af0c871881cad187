#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mft_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA card, ``nvcc`` (CUDA_HOME, default /usr/local/cuda) and nothing else
of the JAX package; it imports no ``jax``.  Phases, any failure exits
non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from ``mft_tpu_torch/kernels/csrc``
   (one nvcc per source, started together) and print the build seconds and
   the ptxas resource report;
3. hold every kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (random f32 inputs from a seeded
   generator), with the stated tolerance, and time both with CUDA events;
4. check the eval on the card against the same eval on the CPU at a small
   size (strict f32, few inner steps);
5. drive the main path through ``mft_tpu_torch.cli.finetune.main`` at full
   width — ``--method all --use_pallas``, ResNet10 at 224 px, 5-way 5-shot,
   15 queries, ``gen_examples=17``, ``fine_tune_epoch=5`` — on the
   synthetic dataset with seeded random checkpoints (baseline@400 and
   gnnnet_aug@600 ``.tar`` files), with every kernel launch count set to 0
   just before and read just after; then two episodes of the strict f32
   numerics (``--dtype float32 --inner_param_dtype float32``); then one
   more episode of the main path under
   ``torch.profiler`` to see the kernel's symbol on the device timeline and
   to print where the time goes (per eval phase, per kernel, idle share).

The line before the last is ``{"kernels": [...]}`` (per kernel: launches on
the main path, max error, kernel / plain / bound times); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
EPISODES = 3
#: f32 kernel vs f32 plain product: same math, other summation order
EDGE_REL_TOL = 1e-4
#: card vs CPU eval scores (softmax sums in [0, 2]), strict f32, no inner
#: steps: the same forward (trunk, BN, GNN with the edge kernel) on both
XDEV_TOL = 1e-4
#: H100 SXM published peaks (dense): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def edge_bound_ms(b, n, f, c):
    """Least time for one call: f32 operations (the product, the
    |x_i - x_j| edge values, the bias) over the f32 peak, or bytes (x, w,
    bias read once; out written once) over the memory rate."""
    flops = 2.0 * b * n * n * f * c + 2.0 * b * n * n * f + b * n * n * c
    nbytes = 4.0 * (b * n * f + c * f + c + b * n * n * c)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_edge_kernel(torch, dev):
    from mft_tpu_torch.kernels import edge_mlp

    # 5-shot main path: B = 15 query graphs of N = 30 nodes, the three
    # Wcompute widths F; plus the 50-shot N = 130 graph
    cases = [(15, 30, 133, 192), (15, 30, 181, 192), (15, 30, 229, 192), (15, 130, 229, 192)]
    gen = torch.Generator(device=dev).manual_seed(0)
    worst_abs, main = 0.0, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for b, n, f, c in cases:
        x = torch.randn((b, n, f), generator=gen, device=dev)
        w = torch.randn((c, f), generator=gen, device=dev) * 0.05
        bias = torch.randn((c,), generator=gen, device=dev)
        before = edge_mlp.LAUNCHES
        out = edge_mlp.edge_abs_diff_matmul(x, w, bias)
        if edge_mlp.LAUNCHES != before + 1:
            fail("edge_abs_diff_matmul did not launch its kernel on a CUDA tensor")
        ref = edge_mlp.edge_abs_diff_matmul_reference(x, w, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"edge kernel produced non-finite values at {(b, n, f, c)}")
        abs_err = float((out - ref).abs().max())
        rel_err = abs_err / max(float(ref.abs().max()), 1e-30)
        ms = cuda_time_ms(lambda: edge_mlp.edge_abs_diff_matmul(x, w, bias))
        plain_ms = cuda_time_ms(lambda: edge_mlp.edge_abs_diff_matmul_reference(x, w, bias))
        bms, by = edge_bound_ms(b, n, f, c)
        print(f"edge_abs_diff_matmul B={b} N={n} F={f} C={c}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
              f"(tol rel {EDGE_REL_TOL:g})")
        print(f"edge_abs_diff_matmul B={b} N={n} F={f} C={c}: kernel_ms={ms:.5f}")
        print(f"edge_abs_diff_matmul B={b} N={n} F={f} C={c}: plain_ms={plain_ms:.5f}")
        print(f"edge_abs_diff_matmul B={b} N={n} F={f} C={c}: bound_ms={bms:.5f} ({by})")
        if not rel_err <= EDGE_REL_TOL:
            fail(f"edge kernel disagrees with its plain version at {(b, n, f, c)}: rel {rel_err:.3e}")
        worst_abs = max(worst_abs, abs_err)
        if n == 30:  # one episode's three launches
            main["ms"] += ms
            main["plain_ms"] += plain_ms
            main["bound_ms"] += bms
            bound_by.add(by)
    return {
        "name": "edge_abs_diff_matmul",
        "route": "cuda",
        "source": "mft_tpu_torch/kernels/csrc/edge_mlp.cu",
        "replaces": "mft_tpu/ops/pallas/edge_mlp.py:61",
        "max_abs_err": worst_abs,
        # the times are one episode's three calls (F = 133, 181, 229) summed
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": bound_by.pop() if len(bound_by) == 1 else "operations",
        "library_ms": None,  # no single PyTorch call computes |x_i - x_j| @ W
    }


def phase_cross_device(torch, dev):
    """One small strict-f32 episode on the card (edge kernel on) and on the
    CPU (plain version), same weights, draws and schedule.  Without inner
    steps the scores must agree to XDEV_TOL; with one epoch of each member
    the argmax must agree (a few Adam steps amplify rounding, since each
    first step moves every weight by about lr whatever the gradient's size)."""
    import numpy as np

    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.models import backbone as bb
    from mft_tpu_torch.ops.augment import AugmentCfg
    from mft_tpu_torch.train import eval_engine as ee

    spec = EpisodeSpec(5, 5, 3)
    bcfg = bb.resnet10()
    gcfg = gn.GnnNetCfg(use_pallas=True)
    aug = AugmentCfg(image_size=32)
    g = torch.Generator().manual_seed(1)
    bp, bs = bb.init_backbone(g, bcfg)
    gp, gs = bb.init_backbone(g, bcfg)
    head = gn.init_head(g, gcfg)
    images = np.random.RandomState(2).randint(0, 256, (5, 8, 36, 36, 3), dtype=np.uint8)
    to = lambda t, d: {k: to(v, d) for k, v in t.items()} if isinstance(t, dict) else (
        [to(v, d) for v in t] if isinstance(t, list) else t.to(d))
    for epochs in (0, 1):
        tcfg = ee.TransferCfg(fine_tune_epochs=epochs, linear_epochs=epochs, opt_state_dtype="float32")
        program = ee.make_eval_program(method="all", bcfg=bcfg, gcfg=gcfg, spec=spec, tcfg=tcfg, aug_cfg=aug,
                                       gen_examples=1)
        scores = {}
        for d in ("cpu", dev):
            models = {"baseline": (to(bp, d), to(bs, d)), "gnn": (to(gp, d), to(gs, d), to(head, d))}
            base = torch.from_numpy(images).to(d).permute(0, 1, 4, 2, 3)
            scores[d], _ = program(models, base, torch.Generator().manual_seed(3))
        diff = float((scores[dev].cpu() - scores["cpu"]).abs().max())
        agree = bool((scores[dev].cpu().argmax(1) == scores["cpu"].argmax(1)).all())
        print(f"card vs CPU eval (32 px, f32, {epochs} inner epochs): max |d scores| = {diff:.3e}, argmax agree = {agree}")
        if not agree or (epochs == 0 and not diff <= XDEV_TOL):
            fail(f"card eval disagrees with the CPU eval at {epochs} inner epochs (tol {XDEV_TOL:g} without steps)")


def write_checkpoints(torch, save_dir):
    """Seeded random baseline@400 and gnnnet_aug@600 in the reference .tar layout."""
    from mft_tpu_torch import config as cfg_mod
    from mft_tpu_torch.convert import save_tar, to_state_dict
    from mft_tpu_torch.methods import gnnnet as gn
    from mft_tpu_torch.models import backbone as bb

    paths = cfg_mod.Paths(save_dir=save_dir)
    g = torch.Generator().manual_seed(0)
    bcfg = bb.resnet10()
    p, s = bb.init_backbone(g, bcfg)
    d = cfg_mod.checkpoint_dir(paths, "miniImageNet", "ResNet10", "baseline", train_aug=False)
    os.makedirs(d)
    save_tar(os.path.join(d, "400.tar"), 400, to_state_dict({"feature": p}, s))
    p, s = bb.init_backbone(g, bcfg)
    head = gn.init_head(g, gn.GnnNetCfg())
    d = cfg_mod.checkpoint_dir(paths, "miniImageNet", "ResNet10", "gnnnet", train_aug=True, n_way=5, n_shot=5)
    os.makedirs(d)
    save_tar(os.path.join(d, "600.tar"), 600, to_state_dict({"feature": p, **head}, s))
    pj = os.path.join(save_dir, "paths.json")
    with open(pj, "w") as f:
        json.dump({"save_dir": save_dir}, f)
    return pj


def drive(finetune, label: str, argv, episodes: int) -> float:
    """``episodes`` episodes through the eval driver; checks the accuracies
    and returns the mean seconds per episode after the first (warm-up)."""
    res = finetune.main(argv + ["--iter_num", str(episodes)])
    accs = [float(v) for v in res.accs]
    if len(accs) != episodes or not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in accs):
        fail(f"{label} accuracies out of range: {accs}")
    steady = res.seconds[1:] or res.seconds
    print(f"{label}: {episodes} episodes, accs {accs}, seconds per episode "
          f"{[round(t, 3) for t in res.seconds]} (first includes warm-up)")
    print(f"{label} steady seconds/episode = {sum(steady) / len(steady):.4f}")
    return sum(steady) / len(steady)


def phase_profile(torch, finetune, argv, steady_s: float):
    """One more main-path episode under ``torch.profiler``: the edge
    kernel's symbol must be on the device timeline.  Prints where the time
    goes: each eval phase's host and device milliseconds (the
    ``<phase>:<member>`` ranges of train/eval_engine.py), the kernels with
    the most device time, and the device's idle share, which is 1 - (device
    kernel time of the profiled episode) / (steady seconds per episode
    without the profiler; the profiler itself slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mft_tpu_torch.train.eval_engine import PHASES

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = finetune.main(argv + ["--iter_num", "1"])
    events = prof.key_averages()
    # device activity (kernels, copies, sets), without the device-side copies
    # of the record_function ranges
    on_device = [e for e in events if e.device_type != DeviceType.CPU and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in on_device)
    if busy_us == 0:
        fail("the profiler recorded no device time, so it cannot show the edge kernel on the main path")
    edge_us = sum(e.self_device_time_total for e in on_device if "edge_abs_diff_matmul_kernel" in e.key)
    if edge_us == 0:
        fail("the profiler traced device kernels but not the edge kernel")
    print(f"profiler: edge kernel on the device timeline, {edge_us / 1e3:.4f} ms device time in one episode")
    print(f"profiler: episode {res.seconds[0]:.3f} s under the profiler, {steady_s:.3f} s without; "
          f"device time {busy_us / 1e6:.4f} s; idle share {1.0 - busy_us / 1e6 / steady_s:.4f}")
    ranges = [e for e in events if e.device_type == DeviceType.CPU and e.key.split(":")[0] in PHASES]
    for e in sorted(ranges, key=lambda e: -e.cpu_time_total):
        print(f"profiler phase {e.key}: host {e.cpu_time_total / 1e3:.3f} ms, device {e.device_time_total / 1e3:.3f} ms")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profiler kernel {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d} calls  {e.key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import mft_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not beside chip_smoke.py ({e})")
    from mft_tpu_torch import kernels
    from mft_tpu_torch.cli import finetune
    from mft_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for {list(build.SOURCES)} "
          f"({'cached' if not logs else 'compiled ' + ', '.join(logs)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"[{name}] {line.strip()}")

    # 3. every kernel against its plain version
    rows = [phase_edge_kernel(torch, dev)]

    # 4. the eval on the card against the eval on the CPU
    phase_cross_device(torch, dev)

    # 5. the main path at full width
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as save_dir:
        pj = write_checkpoints(torch, save_dir)
        argv = ["--device", "cuda", "--method", "all", "--use_pallas", "--test_dataset", "synthetic",
                "--model", "ResNet10", "--image_size", "224", "--n_shot", "5", "--gen_examples", "17",
                "--fine_tune_epoch", "5", "--paths_json", pj]
        kernels.reset_launch_counts()
        steady = drive(finetune, "main path", argv, EPISODES)
        counts = kernels.launch_counts()
        print(f"main path kernel launches: {counts}")
        for row in rows:
            row["launches"] = counts[row["name"]]
            if row["launches"] == 0:
                fail(f"kernel {row['name']} was never launched on the main path")

        # the strict-parity numerics at the same width
        drive(finetune, "strict f32 path", argv + ["--dtype", "float32", "--inner_param_dtype", "float32"], 2)
        phase_profile(torch, finetune, argv, steady)

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: row[k] for k in order} for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
