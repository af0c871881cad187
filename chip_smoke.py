#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mft_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (``--kernels-only`` stops after phase 3).  It needs a
CUDA card, ``nvcc`` (CUDA_HOME, default /usr/local/cuda) and nothing else
of the JAX package; it imports no ``jax``.  Phases, any failure exits
non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from ``mft_tpu_torch/kernels/csrc``
   (one nvcc per source, started together) and print the build seconds and
   the ptxas resource report;
3. hold every kernel against its plain PyTorch version on the card at the
   shapes the main path gives it (random inputs from a seeded generator),
   with the stated tolerance, and time both: the GNN edge kernel (the main
   path's three widths, the 50-shot graph and ragged shapes; device time by
   the profiler beside the wrapper's CUDA-event time, the function's bound
   beside the work of its tensor-core route and the f32 bound, the kernel
   against the plain emulation of its own three-term split, a planted
   one-term bf16 fault, the HGMMA count of its library, cuBLAS's f32 product
   on the materialized edges as a yardstick), and the fused inner
   scan (one step's gradients, the update rule
   step by step on both lanes of a two-lane call, a 20-step scan with f32
   and bf16 carry on one and two lanes with planted faults beside it to
   show what its bound catches; each of the seven tensor-core products of a
   step alone against the plain product, timed beside the PyTorch
   convolution call, with a planted fault of its own; one step's gradients
   by the tensor-core route against the FMA route; the full 500-step scan
   with the host's enqueue time, the device time per kernel and the step's
   L2 traffic beside it);
4. check the eval on the card against the same eval on the CPU at a small
   size (strict f32 with the eager inner loop; then the fused scan on the
   card against its plain version on the CPU), few inner steps;
5. drive the main path through ``mft_tpu_torch.cli.finetune.main`` at full
   width — ``--method all --use_pallas --inner_scan fused``, ResNet10 at
   224 px, 5-way 5-shot, 15 queries, ``gen_examples=17``,
   ``fine_tune_epoch=5`` — on the synthetic dataset with seeded random
   checkpoints (baseline@400 and gnnnet_aug@600 ``.tar`` files), with every
   kernel launch count set to 0 just before and read just after; then two
   episodes with the eager inner loop (``--inner_scan eager``), so that the
   seconds per episode of both stand side by side from one host; then two
   episodes of the strict f32 numerics (``--dtype float32
   --inner_param_dtype float32``); then one more episode of the main path
   under ``torch.profiler`` to see both kernels' symbols on the device
   timeline and to print where the time goes (per eval phase, per kernel,
   idle share).

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
#: the edge kernel vs the plain emulation of its own arithmetic (the
#: three-term bf16 split, edge_abs_diff_matmul_split_reference), as a share
#: of the output's largest value: the same exact bf16 x bf16 products summed
#: in f32 in another order, read 5e-8 to 1.4e-6 on an H100; a kernel that
#: drops or doubles a term is 1e-3 away
EDGE_SPLIT_TOL = 1e-5
#: card vs CPU eval scores (softmax sums in [0, 2]), strict f32, no inner
#: steps: the same forward (trunk, BN, GNN with the edge kernel) on both
XDEV_TOL = 1e-4
#: fused scan kernels vs their plain version, one step's gradients, as a
#: share of each tensor's largest gradient.  f32: the same f32 math in
#: another summation order.  bf16: y1, z1, the pooled features and every dy
#: round to bf16, and a last-bit difference in f32 before such a rounding
#: flips a bf16 ulp (2**-8 relative) of one value, which the products carry
#: on: every output channel of every tensor within FUSED_GRAD_TOL.  One
#: thing more can happen to a right bf16 kernel: a flipped ulp moves a
#: pre-activation across 0, the ReLU mask of that one (row, channel) flips
#: and adds or drops a whole term, which stays in that output channel of the
#: conv before it and of its BN.  So under bf16 at most
#: FUSED_GRAD_FLIP_CHANNELS output channels of a tensor may exceed
#: FUSED_GRAD_TOL, and none FUSED_GRAD_FLIP_TOL (a wrong term of the
#: backward is an error of about 1 in every channel)
FUSED_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-3}
FUSED_GRAD_FLIP_CHANNELS = {"float32": 0, "bfloat16": 2}
FUSED_GRAD_FLIP_TOL = 5e-2
#: the update rule, elementwise, step by step: the scan after t + 1 steps
#: against the plain Adam update applied to the scan's own state after t
#: steps, with that step's gradients taken from the same kernels
#: (fused_step_grads) and the moments replayed from the earlier steps'.
#: Both sides see the same parameter and gradient bits, so they differ only
#: by the last bit of a division or of the bias correction: rtol 1e-5 in
#: f32; one bf16 ulp (rtol 2**-7) under a bf16 carry, where that last bit
#: can flip the final rounding or a stored moment's.  Share of elements of
#: every tensor that must agree at each of the first FUSED_REPLAY_STEPS steps,
#: on both lanes of a two-lane call (so a lane that read the other's bank,
#: schedule or moments fails here, element by element):
FUSED_REPLAY_RTOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
FUSED_REPLAY_SHARE = 0.999
FUSED_REPLAY_STEPS = 4
#: fused scan vs plain after 20 Adam steps, per tensor, as a share of the
#: distance the plain version moved.  At lr 0.01 on weights of about 0.02
#: every sign flip of a near-zero gradient is as large as the weight and
#: later steps amplify it, so two right trajectories part normwise.  How far
#: is measured in the same run: the plain version against itself with the
#: rows of every minibatch in reverse order (the same math in another
#: summation order).  The kernels may part from the plain version by at
#: most FUSED_SCAN_FLOOR_FACTOR times the worst tensor's share of that
#: floor, and never by more than FUSED_SCAN_CAP.  What such a bound can
#: catch is measured in the same run too: the plain version with a fault
#: planted through its arguments (FUSED_PLANTED_FAULTS) must part from the
#: right plain version by more than the bound, or the script fails
FUSED_SCAN_FLOOR_FACTOR = 2.5
FUSED_SCAN_CAP = 0.6
FUSED_PLANTED_FAULTS = ("moments left from another scan", "the other lane's bank")
#: one product of the fused scan's step, tensor-core kernel vs the plain f32
#: product of the same bf16 operands, as a share of the output's largest
#: value: both sides sum exact bf16 x bf16 products in f32, in another order
FUSED_PRODUCT_TOL = 1e-4
#: a fault the product check must catch: the plain weight gradient taken over
#: rows padded to the kernels' 64-row tiles with the dead rows (m >= 245) not
#: zero, which is what a kernel that did not mask them would compute
FUSED_PRODUCT_FAULT = "dead rows of the last 64-row tile not zero"
#: a short scan whose launches all fit the CUDA launch queue, so that the
#: host's time inside the C call is the enqueue alone
FUSED_ENQUEUE_STEPS = 60
#: H100 SXM published peaks (dense): f32 outside the tensor cores, bf16 in
#: the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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


def device_us(fn, iters: int = 20) -> dict:
    """Device time per call of ``fn`` as ``torch.profiler`` sees it: kernel
    name -> microseconds, and "total".  Free of the host's launch cost, which
    a CUDA-event time of a short kernel behind a Python wrapper is not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(3):  # the first trace of a process can come back empty
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.self_device_time_total / iters for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and e.self_device_time_total > 0}
        if out:
            break
    else:
        fail("the profiler recorded no device time for a kernel in three traces")
    out["total"] = sum(out.values())
    return out


def short_name(key: str) -> str:
    """A kernel's profiler key without return type, namespaces and parameter list."""
    name = key.replace("(anonymous namespace)::", "").replace("void ", "")
    depth = 0
    for i, ch in enumerate(name):  # cut at the "(" that opens the parameter list
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i][-70:]
    return name[-70:]


def report_build(name: str, log: str, build_dir):
    """The ptxas resource report of one source in short (the template
    instantiations make it long): kernels compiled, most registers, any
    spill; the whole log goes to ``build_<name>.log`` beside the library."""
    import re

    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"[{name}] ptxas: {len(regs)} kernels, at most {max(regs, default=0)} registers, "
          f"{sum(1 for v in spills if v)} with spills")
    for line in [line for line in log.splitlines() if "warning" in line.lower()][:6]:
        print(f"[{name}] {line.strip()[:200]}")
    with open(os.path.join(build_dir, f"build_{name}.log"), "w") as f:
        f.write(log)


def edge_bound_ms(b, n, f, c, route: str = "function"):
    """Least time for one call: bytes (x, w, bias read once; out written
    once) over the memory rate, or operations over their peak.
    ``"function"``, the bound the kernel is held to: the one product
    ``|x_i - x_j| @ W`` over the real F at the bf16 tensor-core peak, the
    least work any route does.  ``"bf16x3"``, what the kernel's route does
    (a diagnostic): three bf16 products (hi*hi, hi*lo, lo*hi) with F padded
    to the wgmma's depth of 16.  ``"f32"``: the product, the edge values and
    the bias as f32 FMAs on the CUDA cores.  Returns (ms, what binds it)."""
    if route == "function":
        flops, peak = 2.0 * b * n * n * f * c, PEAK_BF16_FLOPS
    elif route == "bf16x3":
        flops, peak = 3 * 2.0 * b * n * n * (-(-f // 16) * 16) * c, PEAK_BF16_FLOPS
    else:
        flops, peak = 2.0 * b * n * n * f * c + 2.0 * b * n * n * f + b * n * n * c, PEAK_F32_FLOPS
    nbytes = 4.0 * (b * n * f + c * f + c + b * n * n * c)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sass_count(lib, op: str) -> int:
    """Lines of the built library's SASS (cuobjdump from the CUDA toolkit) that hold ``op``."""
    from mft_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=False)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed on {lib}: {res.stderr.strip()[:300]}")
    return sum(op in line for line in res.stdout.splitlines())


#: 5-shot main path: B = 15 query graphs of N = 30 nodes, the three Wcompute
#: widths F, C = 192 (one episode's three calls)
EDGE_MAIN = ((15, 30, 133, 192), (15, 30, 181, 192), (15, 30, 229, 192))
#: besides: the 50-shot N = 130 graph; rows not a multiple of 64 with C and F
#: under one tile; F a multiple of 64; one graph; the three-query graph of
#: phase 4
EDGE_OTHER = ((15, 130, 229, 192), (3, 7, 5, 8), (15, 30, 128, 192), (1, 30, 229, 192), (3, 30, 133, 192))
#: a fault the edge check must catch: one bf16 product, the split's lo terms
#: dropped (emulated in plain torch on the card)
EDGE_FAULT = "one bf16 product, lo terms dropped"


def phase_edge_kernel(torch, dev):
    """The edge kernel against its f32 plain version at EDGE_MAIN and
    EDGE_OTHER and against the plain emulation of its own split, with device
    times (profiler) beside the wrapper's CUDA-event time, the function's
    bound beside the route's work and the f32 bound, the plain version,
    cuBLAS's f32 product on the materialized edges (yardstick only), the
    planted one-term fault, and the HGMMA count of the built library."""
    from mft_tpu_torch.kernels import build, edge_mlp

    hgmma = sass_count(build.lib_path("edge_mlp"), "HGMMA")
    print(f"edge_mlp library: {hgmma} HGMMA instructions in its SASS (tensor-core products)")
    if hgmma <= 0:
        fail("the edge kernel's library has no HGMMA instruction: its products do not run on the tensor cores")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst_abs, main = 0.0, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = {"bytes": 0.0, "operations": 0.0}  # the main calls' bounds, summed by what binds each
    for b, n, f, c in EDGE_MAIN + EDGE_OTHER:
        label = f"edge_abs_diff_matmul B={b} N={n} F={f} C={c}"
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
        scale = max(float(ref.abs().max()), 1e-30)
        abs_err = float((out - ref).abs().max())
        rel_err = abs_err / scale
        emul = float((out - edge_mlp.edge_abs_diff_matmul_split_reference(x, w, bias)).abs().max()) / scale
        print(f"{label}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} (tol rel {EDGE_REL_TOL:g}); against "
              f"the plain emulation of its three-term split {emul:.3e} (tol {EDGE_SPLIT_TOL:g})")
        if not rel_err <= EDGE_REL_TOL:
            fail(f"edge kernel disagrees with its plain version at {(b, n, f, c)}: rel {rel_err:.3e}")
        if not emul <= EDGE_SPLIT_TOL:
            fail(f"edge kernel departs from its stated three-term arithmetic at {(b, n, f, c)}: {emul:.3e}")
        worst_abs = max(worst_abs, abs_err)
        if (b, n, f, c) in EDGE_MAIN:  # the planted fault, on the same inputs
            one = edge_mlp.edge_abs_diff_matmul_split_reference(x, w, bias, terms=1)
            reading = float((one - ref).abs().max()) / scale
            caught = reading > EDGE_REL_TOL
            print(f"{label}: plain version with a planted fault ({EDGE_FAULT}): {reading:.3e} against "
                  f"{EDGE_REL_TOL:g}: {'caught' if caught else 'passes'}; the kernel {rel_err:.3e}")
            if not caught:
                fail(f"the edge check does not catch {EDGE_FAULT} at {(b, n, f, c)}")
        dev_us = device_us(lambda: edge_mlp.edge_abs_diff_matmul(x, w, bias))
        wrapper_ms = cuda_time_ms(lambda: edge_mlp.edge_abs_diff_matmul(x, w, bias))
        ms = dev_us["total"] * 1e-3
        bms, by = edge_bound_ms(b, n, f, c)
        x3_bms, x3_by = edge_bound_ms(b, n, f, c, route="bf16x3")
        f32_bms, f32_by = edge_bound_ms(b, n, f, c, route="f32")
        print(f"{label}: kernel device_ms={ms:.5f} ("
              + ", ".join(f"{short_name(k)} {v:.2f} us" for k, v in dev_us.items() if k != "total")
              + f"); wrapper's time by CUDA events {wrapper_ms:.5f} ms (host launch cost included)")
        print(f"{label}: bound_ms={bms:.5f} ({by}; one product over F at the bf16 tensor-core peak, or bytes); "
              f"the route's three bf16 products over F padded to 16 {x3_bms:.5f} ({x3_by}); f32 CUDA-core bound "
              f"{f32_bms:.5f} ({f32_by}); the kernel takes {ms / bms:.2f} x its bound")
        if n == 130 or (b, n, f, c) in EDGE_MAIN:
            plain_us = device_us(lambda: edge_mlp.edge_abs_diff_matmul_reference(x, w, bias))["total"]
            e = (x[:, :, None, :] - x[:, None, :, :]).abs()
            cublas_us = device_us(lambda: torch.matmul(e, w.t()))["total"]
            del e
            print(f"{label}: plain device_ms={plain_us * 1e-3:.5f} (by CUDA events "
                  f"{cuda_time_ms(lambda: edge_mlp.edge_abs_diff_matmul_reference(x, w, bias)):.5f}); yardstick: "
                  f"cuBLAS f32 product alone on the materialized edges (torch.matmul, TF32 off) "
                  f"{cublas_us * 1e-3:.5f} ms on the device")
            if (b, n, f, c) in EDGE_MAIN:  # one episode's three launches
                main["ms"] += ms
                main["plain_ms"] += plain_us * 1e-3
                main["bound_ms"] += bms
                bound_by[by] += bms
    print(f"edge_abs_diff_matmul, one episode's three calls: device {main['ms']:.5f} ms, plain {main['plain_ms']:.5f} "
          f"ms, bound {main['bound_ms']:.5f} ms ({bound_by['bytes']:.5f} of it by bytes, {bound_by['operations']:.5f} "
          f"by operations), the route's three products "
          f"{sum(edge_bound_ms(*case, route='bf16x3')[0] for case in EDGE_MAIN):.5f} ms, f32 CUDA-core bound "
          f"{sum(edge_bound_ms(*case, route='f32')[0] for case in EDGE_MAIN):.5f} ms")
    return {
        "name": "edge_abs_diff_matmul",
        "route": "cuda",
        "source": "mft_tpu_torch/kernels/csrc/edge_mlp.cu",
        "replaces": "mft_tpu/ops/pallas/edge_mlp.py:61",
        "max_abs_err": worst_abs,
        # one episode's three calls (F = 133, 181, 229) summed, device time
        # (W's split pass and the product kernel); plain likewise
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": max(bound_by, key=bound_by.get),
        "library_ms": None,  # no single PyTorch call computes |x_i - x_j| @ W
    }


def fused_bound(geom, n_steps: int, carry_bytes: int, bank_bytes: int):
    """Least times for an ``n_steps`` scan of one lane, from the shapes.

    Operations: the products (forward: conv1, conv2, shortcut; backward:
    conv2's weight and input gradients, conv1's and the shortcut's weight
    gradients) over the bf16 tensor-core peak, and over the f32 CUDA-core
    peak that bounds a design without tensor cores.  Bytes the function
    must move: the parameters read once and written once, the bank rows
    that each step gathers, the schedule (idx int32, w f32) and the labels;
    the Adam moments start at zero and are no output, so they need not
    reach device memory at all.  For comparison, the traffic if parameters
    and both bf16 moments were read and written in device memory every step
    (no cache keeping the state).  Returns a dict of those figures."""
    r, ci, co, b = geom.rows, geom.c_in, geom.c_out, geom.batch
    fwd = 2.0 * r * co * (9 * ci + 9 * co + ci)
    bwd = 2.0 * r * co * (9 * co + 9 * co + 9 * ci + ci)
    n_params = 9 * ci * co + 9 * co * co + ci * co + 6 * co
    flops = (fwd + bwd) * n_steps
    nbytes = (2.0 * n_params * carry_bytes + float(n_steps) * b * geom.h_in * geom.h_in * ci * bank_bytes
              + n_steps * b * (4 + 4 + 4))
    state_bytes = float(n_params) * (2 * carry_bytes + 2 * 2 * 2) * n_steps
    return {"flops": flops, "bytes": nbytes, "ms_tc": flops / PEAK_BF16_FLOPS * 1e3,
            "ms_fma": flops / PEAK_F32_FLOPS * 1e3, "ms_bytes": nbytes / PEAK_BYTES * 1e3,
            "state_bytes": state_bytes, "ms_state": state_bytes / PEAK_BYTES * 1e3}


def fused_step_l2_bytes(geom) -> dict:
    """Bytes one step of the tensor-core design moves between L2 and the SMs,
    from the shapes and the kernels' tiling (csrc/fused_inner_scan.cu: 64 x 128
    output tiles fed by stages of 64 reduction elements, K split so that about
    128 blocks run; weight gradients in 128 x 128 tiles fed by stages of 32
    rows; bf16 operands, f32 partial sums and BN state)."""
    r, ci, co = geom.rows, geom.c_in, geom.c_out
    rc, m_tiles, n_tiles = r * co, -(-r // 64), co // 128

    def conv(k):  # operand stages read by every output tile, partial sums written
        kblocks = k // 64
        per_split = -(-kblocks // max(128 // (m_tiles * n_tiles), 1))
        splits = -(-kblocks // per_split)
        return m_tiles * n_tiles * kblocks * (64 + 128) * 64 * 2, splits * rc * 4

    c1, c2, sc = conv(9 * ci), conv(9 * co), (conv(ci)[0], rc * 4)  # the shortcut's K is not split
    products = c1[0] + sc[0] + 2 * c2[0]  # conv1, shortcut, conv2 and its input gradient
    parts = c1[1] + sc[1] + 2 * c2[1]
    wgrad = (9 * ci + 9 * co + ci) // 128 * n_tiles * -(-r // 32) * (128 + 128) * 32 * 2
    n_params = 9 * ci * co + 9 * co * co + ci * co + 6 * co
    adam = n_params * 12  # parameter and both moments, bf16, read and written
    # partial sums read back by the BN kernels; xhat x3, pre (f32) written and read; z1, dy x3 (bf16) written
    bn = parts + 2 * 4 * rc * 4 + 4 * rc * 2
    return {"products": products, "partial sums": parts, "weight gradients": wgrad, "Adam": adam, "BN": bn}


def l2_stream_rate(torch, dev, nbytes: int = 11 << 20) -> float:
    """Bytes per second of a device copy whose source and destination (22 MB
    together, the size of a lane's parameters and moments) stay in the 50 MB
    L2: the rate a streaming pass over L2-resident state can reach."""
    src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    # device time from the profiler: by CUDA events a 9 us copy reads as the host's launch rate
    return 2.0 * nbytes / (device_us(lambda: dst.copy_(src), iters=50)["total"] * 1e-6)


def conv_library_ms(torch, which, prod, geom):
    """Yardstick only: the one PyTorch call for the same convolution, bf16,
    channels-last; never called by the port."""
    import torch.nn.functional as F

    b, ci, co, s = geom.batch, geom.c_in, geom.c_out, geom.stride
    first = which.startswith("conv1") or which.startswith("conv_sc")
    k, pad = (1, 0) if which.startswith("conv_sc") else (3, 1)
    cin, stride = (ci, s) if first else (co, 1)
    nchw = lambda t: t.permute(0, 3, 1, 2)  # a channels-last view of the NHWC operand
    w4 = (prod["w"] if prod["w"] is not None else torch.zeros((k * k * cin, co), dtype=torch.bfloat16, device="cuda"))
    w4 = w4.reshape(k, k, cin, co).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    dy4 = None if prod["dy"] is None else nchw(prod["dy"].reshape(b, geom.h_out, geom.h_out, co))
    if which.endswith("_dw"):
        x4 = nchw(prod["x"])
        fn = lambda: torch.nn.grad.conv2d_weight(x4, w4.shape, dy4, stride=stride, padding=pad)
    elif which == "conv2_dx":
        fn = lambda: torch.nn.grad.conv2d_input((b, co, geom.h_out, geom.h_out), w4, dy4, stride=1, padding=1)
    else:
        x4 = nchw(prod["x"])
        fn = lambda: F.conv2d(x4, w4, stride=stride, padding=pad)
    return cuda_time_ms(fn), device_us(fn)["total"]


def phase_fused_products(torch, fis, geom, p_bf16, bank, bank_y, idx_t, w_t, failures):
    """Each of the seven products of a step alone, bf16, at the main path's
    shapes: the tensor-core kernel against the plain product of the same
    operands (those of the plain step), its time beside its operations bound
    and the PyTorch convolution call, and the planted fault."""
    f32 = {k: v.float() for k, v in p_bf16.items()}
    prods = fis.step_products_reference(f32, bank[idx_t], bank_y[idx_t], w_t, geom)
    r = geom.rows
    for which in fis.PRODUCTS:
        prod = prods[which]
        ops = [None if prod[k] is None else prod[k].contiguous() for k in ("w", "x", "dy")]
        got = fis.fused_product(which, *ops, geom)
        fma = fis.fused_product(which, *ops, geom, route="fma")
        torch.cuda.synchronize()
        scale = float(prod["out"].abs().max())
        err = float((got - prod["out"]).abs().max()) / scale
        err_fma = float((fma - prod["out"]).abs().max()) / scale
        flops = 2.0 * prod["out"].shape[0] * prod["out"].shape[1] * (r if which.endswith("_dw") else
                                                                 (prod["w"].shape[0]))
        us = cuda_time_ms(lambda: fis.fused_product(which, *ops, geom)) * 1e3
        us_fma = cuda_time_ms(lambda: fis.fused_product(which, *ops, geom, route="fma")) * 1e3
        dev = device_us(lambda: fis.fused_product(which, *ops, geom))
        dev_fma = device_us(lambda: fis.fused_product(which, *ops, geom, route="fma"))
        mma_us = sum(v for k, v in dev.items() if "_mma_kernel" in k)
        lib_ms, lib_dev_us = conv_library_ms(torch, which, prod, geom)
        bound_us = flops / PEAK_BF16_FLOPS * 1e6
        print(f"fused_product {which} bf16 library (one torch conv call, bf16 channels-last; yardstick only): "
              f"{lib_ms * 1e3:.2f} us by CUDA events, {lib_dev_us:.2f} us on the device")
        print(f"fused_product {which} bf16: tensor cores vs plain {err:.3e} of the output's max (tol "
              f"{FUSED_PRODUCT_TOL:g}), FMA route vs plain {err_fma:.3e}; on the device {mma_us:.2f} us in the product "
              f"kernel, {dev['total']:.2f} us with the sum of its K splits (FMA route {dev_fma['total']:.2f} us); "
              f"{flops / 1e9:.3f} GFLOP, bound {bound_us:.3f} us at the bf16 peak, {bound_us / mma_us:.4f} of the peak; "
              f"by CUDA events behind the Python wrapper {us:.2f} us (FMA route {us_fma:.2f} us)")
        if not (bool(torch.isfinite(got).all()) and err <= FUSED_PRODUCT_TOL and err_fma <= FUSED_PRODUCT_TOL):
            failures.append(f"product {which}")
        if which == "conv1_dw":  # the planted fault
            pieces = fis._patches3x3(fis._pad_hw(prod["x"]), geom.stride)
            pad = (r + 63) // 64 * 64 - r
            a = torch.cat([torch.cat([pc, torch.ones((pad, pc.shape[1]), dtype=pc.dtype, device=pc.device)])
                           for pc in pieces], dim=1)
            dy = torch.cat([prod["dy"], 1e-3 * torch.ones((pad, prod["dy"].shape[1]), dtype=prod["dy"].dtype,
                                                        device=prod["dy"].device)])
            faulty = fis._mm(a.t(), dy)
            reading = float((got - faulty).abs().max()) / scale
            caught = reading > FUSED_PRODUCT_TOL
            print(f"fused_product {which} bf16, plain version with a planted fault ({FUSED_PRODUCT_FAULT}; {pad} such "
                  f"rows): {reading:.3e} against {FUSED_PRODUCT_TOL:g}: {'caught' if caught else 'passes'}")
            if not caught:
                failures.append(f"the product check with {FUSED_PRODUCT_FAULT}")


#: other geometries the tensor-core kernels must take: stride 1, more rows
#: than one BN thread row (256), fewer rows than one 64-row tile, and a
#: shortcut weight (64 rows) smaller than a 128 x 128 weight-gradient tile
FUSED_OTHER_GEOMS = ((8, 64, 128, 1, 7), (6, 128, 256, 2, 3))


def phase_fused_other_geometries(torch, fis, dev, failures):
    """bf16 bank and carry at FUSED_OTHER_GEOMS: one step's gradients against
    the plain version (the bf16 rule), and two scan steps against the plain
    Adam update of the scan's own state and gradients (the replay rule)."""
    tol, allowed, rtol = FUSED_GRAD_TOL["bfloat16"], FUSED_GRAD_FLIP_CHANNELS["bfloat16"], FUSED_REPLAY_RTOL["bfloat16"]
    for dims in FUSED_OTHER_GEOMS:
        geom, span = fis.BlockGeom(*dims), 12
        gen = torch.Generator(device=dev).manual_seed(2)
        randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        p = {k: ((randn(*shape) * (2.0 / shape[0]) ** 0.5) if k.startswith("conv")
                 else (randn(*shape) * 0.1 + (1.0 if k.endswith("_s") else 0.0))).to(torch.bfloat16)
             for k, shape in fis.param_shapes(geom).items()}
        bank = torch.relu(randn(span, geom.h_in, geom.h_in, geom.c_in)).to(torch.bfloat16)
        bank_y = torch.arange(span, device=dev) % 3
        idx = torch.stack([torch.randperm(span, generator=torch.Generator().manual_seed(t))[:geom.batch]
                           for t in range(2)]).to(dev)
        w = torch.ones((2, geom.batch), device=dev)
        w[1, -1] = 0.0
        state, mu, nu = p, *({k: torch.zeros_like(v) for k, v in p.items()} for _ in range(2))
        for t in range(2):
            got, _ = fis.fused_step_grads(state, bank, bank_y, idx[t], w[t], geom=geom)
            want, _ = fis.step_grads_reference({k: v.float() for k, v in state.items()}, bank[idx[t]], bank_y[idx[t]],
                                               w[t], geom)
            errs = {k: (got[k] - want[k]).abs().reshape(-1, want[k].shape[-1]).amax(dim=0)
                    / want[k].abs().max().clamp(min=1e-30) for k in fis.PKEYS}
            worst = max(float(e.max()) for e in errs.values())
            over = max(int((e > tol).sum()) for e in errs.values())
            after = fis.fused_inner_scan(p, bank, bank_y, idx[: t + 1], w[: t + 1], geom=geom, lr=0.01)
            mine, mu, nu = fis.adam_update_reference(state, mu, nu, got, t + 1, 0.01)
            torch.cuda.synchronize()
            close = min(float(((after[k].float() - mine[k].float()).abs() <= 1e-7 + rtol * mine[k].float().abs())
                              .float().mean()) for k in fis.PKEYS)
            print(f"fused scan at {geom}, bf16, step {t + 1}: worst gradient error / max = {worst:.3e} (tol {tol:g}, "
                  f"most channels of a tensor above it {over}, allowed {allowed}); update vs the plain Adam update of "
                  f"its own state and gradients: share within rtol {rtol:g} >= {close:.5f}")
            if not (over <= allowed and worst <= FUSED_GRAD_FLIP_TOL and close >= FUSED_REPLAY_SHARE
                    and all(bool(torch.isfinite(v).all()) for v in after.values())):
                failures.append(f"{geom} step {t + 1}")
            state = after


def phase_fused_inner_scan(torch, dev):
    """The fused inner scan's kernels against the plain version on the card,
    at the main path's geometry (ResNet10's final block at 224 px: 14x14x256
    -> 7x7x512, minibatches of 5 out of a 500-row bank)."""
    from mft_tpu_torch.kernels import fused_inner_scan as fis
    from mft_tpu_torch.train.inner_loop import InnerLoopCfg, minibatch_schedule

    geom, span, lr = fis.BlockGeom(), 500, 0.01
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    shapes = fis.param_shapes(geom)
    p32 = {}
    for k, shape in shapes.items():
        if k.startswith("conv"):
            p32[k] = randn(2, *shape) * (2.0 / shape[0]) ** 0.5  # fan-in normal, as the backbone's init
        else:
            p32[k] = randn(2, *shape) * 0.1 + (1.0 if k.endswith("_s") else 0.0)
    banks32 = torch.relu(randn(2, span, geom.h_in, geom.h_in, geom.c_in))  # the trunk ends in a ReLU
    bank_y = torch.arange(span, device=dev) % 5
    idx, w = minibatch_schedule(torch.Generator().manual_seed(1), InnerLoopCfg(5, geom.batch, span), dev)
    idx2 = torch.stack([idx, torch.flip(idx, dims=(0,))])  # lane 1 walks the schedule backwards
    w_masked = w.clone()
    w_masked[3, -2:] = 0.0  # one ragged minibatch among the checked steps
    lane = lambda tree, l: {k: v[l] for k, v in tree.items()}
    f32 = lambda tree: {k: v.float() for k, v in tree.items()}
    failures, worst_abs = [], 0.0

    # a geometry the kernels do not take is refused before any launch
    bad = fis.BlockGeom(6, 8, 16, 2, 2)
    before = fis.LAUNCHES
    try:
        fis.fused_inner_scan({k: randn(*shape) for k, shape in fis.param_shapes(bad).items()}, randn(4, 6, 6, 8),
                             bank_y[:4], idx[:1, :2] % 4, w[:1, :2], geom=bad, lr=lr)
        failures.append(f"{bad} was not refused")
    except ValueError as e:
        print(f"fused_inner_scan refuses {bad}: {str(e)[:60]}...")
    if fis.LAUNCHES != before:
        failures.append("a refused call counted as a launch")

    def grad_errors(got, want):
        """Per tensor, per output channel (the last axis): largest error as a
        share of the tensor's largest gradient."""
        return {k: (got[k] - want[k]).abs().reshape(-1, want[k].shape[-1]).amax(dim=0)
                / want[k].abs().max().clamp(min=1e-30) for k in fis.PKEYS}

    def check_step_grads(name, label, p_at, t):
        """fused_step_grads against the plain version at the parameters
        ``p_at`` on lane 0's minibatch ``t``; beside it, for scale, the plain
        version against itself with the minibatch's rows in reverse order."""
        i, wt = idx[t], w_masked[t]
        got, loss = fis.fused_step_grads(p_at, banks[0], bank_y, i, wt, geom=geom)
        torch.cuda.synchronize()
        want, want_loss = fis.step_grads_reference(f32(p_at), banks[0][i], bank_y[i], wt, geom)
        ri = torch.flip(i, dims=(0,))
        other, _ = fis.step_grads_reference(f32(p_at), banks[0][ri], bank_y[ri], torch.flip(wt, dims=(0,)), geom)
        errs, own = grad_errors(got, want), max(float(e.max()) for e in grad_errors(other, want).values())
        finite = all(bool(torch.isfinite(v).all()) for v in got.values()) and bool(torch.isfinite(loss))
        tol, allowed = FUSED_GRAD_TOL[name], FUSED_GRAD_FLIP_CHANNELS[name]
        worst = max(float(e.max()) for e in errs.values())
        over = {k: torch.nonzero(e > tol).flatten().tolist() for k, e in errs.items() if bool((e > tol).any())}
        rest = max((float(e[e <= tol].max()) for e in errs.values() if bool((e <= tol).any())), default=float("nan"))
        print(f"fused_step_grads {name} {label}: loss {float(loss):.6f} vs plain {float(want_loss):.6f}; "
              f"worst gradient error / max = {worst:.3e}; output channels above tol {tol:g}: {over or 'none'} "
              f"(at most {allowed} per tensor, none above {FUSED_GRAD_FLIP_TOL:g}), the others' worst {rest:.3e}; "
              f"plain vs plain with the rows reversed {own:.3e}")
        if not finite or any(len(v) > allowed for v in over.values()) or (over and not worst <= FUSED_GRAD_FLIP_TOL) \
                or not abs(float(loss) - float(want_loss)) <= 1e-3 * abs(float(want_loss)):
            failures.append(f"step gradients {name} {label}")

    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        p = {k: v.to(dt) for k, v in p32.items()}
        banks = banks32.to(dt)
        zeros = lambda l: {k: torch.zeros_like(v[l], dtype=torch.bfloat16) for k, v in p.items()}
        # (a) one step's gradients, a full and a ragged minibatch
        check_step_grads(name, "step 0", lane(p, 0), 0)
        check_step_grads(name, "step 3 (ragged)", lane(p, 0), 3)

        # (b) the scan: the first steps on two lanes (kept for the replay
        # below), then 20 steps normwise on one lane and on two
        def plain_steps(pl, mu, nu, bank, idx_l, n_steps):
            """The plain scan step by step from any state (what
            fused_inner_scan_reference does from zero moments)."""
            for t in range(n_steps):
                g, _ = fis.step_grads_reference(f32(pl), bank[idx_l[t]], bank_y[idx_l[t]], w_masked[t], geom)
                pl, mu, nu = fis.adam_update_reference(pl, mu, nu, g, t + 1, lr)
            return pl, mu, nu

        moved_share = lambda a, b, start: {k: float((a[k].double() - b[k].double()).norm())
                                           / float((b[k].double() - start[k].double()).norm()) for k in fis.PKEYS}
        want20 = {l: fis.fused_inner_scan_reference(lane(p, l), banks[l], bank_y, idx2[l, :20], w_masked[:20],
                                                    geom=geom, lr=lr) for l in (0, 1)}
        tol20 = {}
        for l in (0, 1):  # plain vs plain with every minibatch's rows reversed: the floor, and the bound from it
            other = fis.fused_inner_scan_reference(lane(p, l), banks[l], bank_y, torch.flip(idx2[l, :20], dims=(1,)),
                                                   torch.flip(w_masked[:20], dims=(1,)), geom=geom, lr=lr)
            floor = max(moved_share(other, want20[l], lane(p, l)).values())
            tol20[l] = (floor, min(FUSED_SCAN_FLOOR_FACTOR * floor, FUSED_SCAN_CAP))
        states = {l: {0: lane(p, l)} for l in (0, 1)}  # lane -> steps -> that lane after a two-lane kernel scan
        for n_steps, lanes in [(n, 2) for n in range(1, FUSED_REPLAY_STEPS + 1)] + [(20, 1), (20, 2)]:
            before = fis.LAUNCHES
            got = fis.fused_inner_scan_lanes({k: v[:lanes] for k, v in p.items()}, banks[:lanes].contiguous(), bank_y,
                                             idx2[:lanes, :n_steps].contiguous(), w_masked[:n_steps], geom=geom, lr=lr)
            torch.cuda.synchronize()
            if fis.LAUNCHES != before + 1:
                fail("fused_inner_scan_lanes did not launch its kernels on CUDA tensors")
            for l in range(lanes):
                label = f"fused_inner_scan {name} carry, T={n_steps}, L={lanes} lane {l}"
                if not all(bool(torch.isfinite(v[l]).all()) for v in got.values()):
                    failures.append(f"{label}: not finite")
                if n_steps < 20:
                    states[l][n_steps] = lane(got, l)
                    continue
                worst_abs = max(worst_abs, max(float((got[k][l].float() - want20[l][k].float()).abs().max())
                                               for k in fis.PKEYS))
                rel = moved_share(lane(got, l), want20[l], lane(p, l))
                k_worst = max(rel, key=rel.get)
                floor, tol = tol20[l]
                print(f"{label}: worst |kernel - plain| / |plain - start| = {rel[k_worst]:.3e} ({k_worst}); "
                      f"plain vs plain in another summation order {floor:.3e}; tol {tol:.3e} "
                      f"(min of {FUSED_SCAN_FLOOR_FACTOR:g} x that and {FUSED_SCAN_CAP:g})")
                if not rel[k_worst] <= tol:
                    failures.append(label)
        # what that 20-step bound catches: the plain version of lane 1 with a fault planted through its arguments
        _, mu0, nu0 = plain_steps(lane(p, 0), zeros(0), zeros(0), banks[0], idx2[0], 20)
        planted = {"no fault": (zeros(1), zeros(1), banks[1]),
                   FUSED_PLANTED_FAULTS[0]: (mu0, nu0, banks[1]),
                   FUSED_PLANTED_FAULTS[1]: (zeros(1), zeros(1), banks[0])}
        for fault, (mu, nu, bank) in planted.items():
            faulty, _, _ = plain_steps(lane(p, 1), mu, nu, bank, idx2[1], 20)
            reading = max(moved_share(faulty, want20[1], lane(p, 1)).values())
            caught = reading > tol20[1][1]
            print(f"fused_inner_scan {name} carry, T=20, lane 1, plain version with a planted fault ({fault}): worst "
                  f"share {reading:.3e} against the bound {tol20[1][1]:.3e}: {'caught' if caught else 'passes'}")
            if caught == (fault == "no fault"):
                failures.append(f"the 20-step bound {name} with {fault}")
        # the update rule, step by step from the scan's own states, on both lanes
        rtol = FUSED_REPLAY_RTOL[name]
        for l in (0, 1):
            mu, nu = zeros(l), zeros(l)
            for t in range(FUSED_REPLAY_STEPS):
                g, _ = fis.fused_step_grads(states[l][t], banks[l], bank_y, idx2[l, t], w_masked[t], geom=geom)
                mine, mu, nu = fis.adam_update_reference(states[l][t], mu, nu, g, t + 1, lr)
                close = {k: float(((states[l][t + 1][k].float() - mine[k].float()).abs()
                                   <= 1e-7 + rtol * mine[k].float().abs()).float().mean()) for k in fis.PKEYS}
                k_worst = min(close, key=close.get)
                print(f"fused_inner_scan {name} carry, L=2 lane {l}, step {t + 1} vs the plain Adam update of its own "
                      f"state and gradients: share of elements within rtol {rtol:g} >= {close[k_worst]:.5f} "
                      f"({k_worst}) (at least {FUSED_REPLAY_SHARE:g})")
                if not close[k_worst] >= FUSED_REPLAY_SHARE:
                    failures.append(f"update rule {name} lane {l} step {t + 1}")
        # the gradients once more, where the plain 20-step scan ended: the
        # kernels on adapted weights, free of the two trajectories' parting
        check_step_grads(name, "after 20 plain steps", want20[0], 20)
    # (b2) the tensor-core route (a bf16 bank's own) on its own terms
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    banks = banks32.to(torch.bfloat16)
    phase_fused_products(torch, fis, geom, lane(p16, 0), banks[0], bank_y, idx[3], w_masked[3], failures)
    phase_fused_other_geometries(torch, fis, dev, failures)
    tol, allowed = FUSED_GRAD_TOL["bfloat16"], FUSED_GRAD_FLIP_CHANNELS["bfloat16"]
    for label, p_at in (("bf16 carry", lane(p16, 0)), ("f32 carry, bf16 bank", lane(p32, 0))):
        # one step's gradients by both routes on the card; the f32 carry also against the plain version
        tc, tc_loss = fis.fused_step_grads(p_at, banks[0], bank_y, idx[3], w_masked[3], geom=geom)
        fma, fma_loss = fis.fused_step_grads(p_at, banks[0], bank_y, idx[3], w_masked[3], geom=geom, route="fma")
        want, _ = fis.step_grads_reference(f32(p_at), banks[0][idx[3]], bank_y[idx[3]], w_masked[3], geom)
        torch.cuda.synchronize()
        for other_name, other in (("the FMA route", fma), ("the plain version", want)):
            errs = grad_errors(tc, other)
            worst = max(float(e.max()) for e in errs.values())
            over = {k: torch.nonzero(e > tol).flatten().tolist() for k, e in errs.items() if bool((e > tol).any())}
            print(f"fused_step_grads {label}, step 3 (ragged): tensor-core route vs {other_name}: worst gradient "
                  f"error / max = {worst:.3e}; output channels above tol {tol:g}: {over or 'none'} (at most {allowed} "
                  f"per tensor, none above {FUSED_GRAD_FLIP_TOL:g}); loss {float(tc_loss):.6f} vs FMA "
                  f"{float(fma_loss):.6f}")
            if any(len(v) > allowed for v in over.values()) or (over and not worst <= FUSED_GRAD_FLIP_TOL):
                failures.append(f"step gradients, tensor-core route vs {other_name}, {label}")
    if failures:
        fail("the fused inner scan disagrees with its plain version: " + ", ".join(failures))

    # (c) the full scan: 500 steps, bf16 carry and bank, one lane
    p = {k: v[0].to(torch.bfloat16) for k, v in p32.items()}
    bank = banks32[0].to(torch.bfloat16)
    n_steps = idx.shape[0]
    out = fis.fused_inner_scan(p, bank, bank_y, idx, w, geom=geom, lr=lr)
    torch.cuda.synchronize()
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape or out[k].dtype != torch.bfloat16 or not bool(torch.isfinite(out[k]).all()):
            fail(f"the {n_steps}-step scan's {k} is not a finite bfloat16 {shape}")
    ms = cuda_time_ms(lambda: fis.fused_inner_scan(p, bank, bank_y, idx, w, geom=geom, lr=lr), iters=3, warmup=1)
    plain_ms = cuda_time_ms(lambda: fis.fused_inner_scan_reference(p, bank, bank_y, idx, w, geom=geom, lr=lr),
                            iters=1, warmup=0)
    # where a step's device time goes, kernel by kernel (the profiler over a short scan)
    short = device_us(lambda: fis.fused_inner_scan(p, bank, bank_y, idx[:FUSED_ENQUEUE_STEPS], w[:FUSED_ENQUEUE_STEPS],
                                                   geom=geom, lr=lr), iters=2)
    per_kernel = sorted(((k, v / FUSED_ENQUEUE_STEPS) for k, v in short.items() if k != "total"), key=lambda kv: -kv[1])
    print(f"fused_inner_scan bf16 L=1, device us per step by kernel ({FUSED_ENQUEUE_STEPS}-step scans under the "
          f"profiler, {short['total'] / FUSED_ENQUEUE_STEPS:.2f} us in all): "
          + "; ".join(f"{v:.2f} {short_name(k)}" for k, v in per_kernel))
    b = fused_bound(geom, n_steps, 2, 2)
    bound_ms = max(b["ms_tc"], b["ms_bytes"])
    per_step = fis.kernels_per_step(torch.bfloat16)
    label = f"fused_inner_scan T={n_steps} bf16 L=1"
    # the host's share: seconds inside the C call (enqueue, no synchronise) beside the device's
    torch.cuda.synchronize()
    fis.fused_inner_scan(p, bank, bank_y, idx, w, geom=geom, lr=lr)
    host_full = fis.LAST_ENQUEUE_SECONDS
    torch.cuda.synchronize()
    fis.fused_inner_scan(p, bank, bank_y, idx[:FUSED_ENQUEUE_STEPS], w[:FUSED_ENQUEUE_STEPS], geom=geom, lr=lr)
    host_short = fis.LAST_ENQUEUE_SECONDS
    torch.cuda.synchronize()
    enqueue_us = host_short / FUSED_ENQUEUE_STEPS * 1e6
    print(f"{label}: host inside the C call {host_full * 1e3:.3f} ms for {n_steps} steps (the launch queue fills, so "
          f"this follows the device); {FUSED_ENQUEUE_STEPS} steps, which fit the queue: {host_short * 1e3:.3f} ms = "
          f"{enqueue_us:.2f} us per step to enqueue against {ms / n_steps * 1e3:.2f} us per step on the device: "
          f"enqueue / device = {enqueue_us / (ms / n_steps * 1e3):.3f}")
    print(f"{label}: kernel_ms={ms:.3f} ({ms / n_steps * 1e3:.1f} us per step, {per_step} device kernels per step, "
          f"{per_step * n_steps} per call)")
    print(f"{label}: plain_ms={plain_ms:.3f} (one run of all {n_steps} steps, no warm-up)")
    print(f"{label}: {b['flops'] / 1e12:.3f} TFLOP -> bf16 tensor cores {b['ms_tc']:.3f} ms; {b['bytes'] / 1e9:.4f} GB "
          f"that must move (parameters in and out, gathered bank rows, schedule) -> {b['ms_bytes']:.3f} ms; "
          f"bound_ms={bound_ms:.3f}; the kernels take {ms / bound_ms:.1f} x that")
    print(f"{label}: f32 FMA bound of this design {b['ms_fma']:.3f} ms; the kernels reach {b['ms_fma'] / ms:.3f} of it "
          f"({b['flops'] / ms / 1e9:.2f} TFLOP/s)")
    l2 = fused_step_l2_bytes(geom)
    rate = l2_stream_rate(torch, dev)
    l2_us = sum(l2.values()) / rate * 1e6
    print(f"{label}: L2 traffic of one step of this design, from the shapes and the tiling: "
          + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in l2.items())
          + f"; {sum(l2.values()) / 1e6:.1f} MB in all -> {l2_us:.1f} us a step, {l2_us * n_steps / 1e3:.3f} ms for "
          f"{n_steps} steps at {rate / 1e12:.3f} TB/s, the rate of a 22 MB device copy that stays in L2 (measured here)")
    print(f"{label}: if no cache kept the state, parameters and both moments in and out of device memory every step "
          f"would be {b['state_bytes'] / 1e9:.2f} GB, {b['ms_state']:.3f} ms (not the bound: the state fits L2)")
    return {
        "name": "fused_inner_scan",
        "route": "cuda",
        "source": "mft_tpu_torch/kernels/csrc/fused_inner_scan.cu",
        "replaces": "mft_tpu/ops/pallas/fused_inner_scan.py:386",
        "max_abs_err": worst_abs,  # adapted parameters after the 20-step scans, worst case
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if b["ms_tc"] >= b["ms_bytes"] else "bytes",
        "library_ms": None,  # no single PyTorch call computes a 500-step adaptation scan
    }


def phase_cross_device(torch, dev):
    """One small episode on the card (edge kernel on) and on the CPU (plain
    versions), same weights, draws and schedule: strict f32 with the eager
    inner loop, then bf16 Adam moments with the fused scan (its kernels on
    the card, its plain version on the CPU).  Without inner steps the
    scores must agree to XDEV_TOL; with one epoch of each member the argmax
    must agree (a few Adam steps amplify rounding, since each first step
    moves every weight by about lr whatever the gradient's size)."""
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
    for epochs, mode in ((0, "eager"), (1, "eager"), (0, "fused"), (1, "fused")):
        tcfg = ee.TransferCfg(fine_tune_epochs=epochs, linear_epochs=epochs, inner_scan=mode,
                              opt_state_dtype="float32" if mode == "eager" else "bfloat16")
        program = ee.make_eval_program(method="all", bcfg=bcfg, gcfg=gcfg, spec=spec, tcfg=tcfg, aug_cfg=aug,
                                       gen_examples=1)
        scores = {}
        for d in ("cpu", dev):
            models = {"baseline": (to(bp, d), to(bs, d)), "gnn": (to(gp, d), to(gs, d), to(head, d))}
            base = torch.from_numpy(images).to(d).permute(0, 1, 4, 2, 3)
            scores[d], _ = program(models, base, torch.Generator().manual_seed(3))
        diff = float((scores[dev].cpu() - scores["cpu"]).abs().max())
        agree = bool((scores[dev].cpu().argmax(1) == scores["cpu"].argmax(1)).all())
        print(f"card vs CPU eval (32 px, f32, {mode} inner loop, {epochs} inner epochs): max |d scores| = {diff:.3e}, "
              f"argmax agree = {agree}")
        if not agree or (epochs == 0 and not diff <= XDEV_TOL):
            fail(f"card eval ({mode}) disagrees with the CPU eval at {epochs} inner epochs (tol {XDEV_TOL:g} without steps)")


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


def phase_profile(torch, finetune, argv, steady_s: float, edge_per_episode: int):
    """One more main-path episode under ``torch.profiler``: the symbols of
    the edge kernel and of the fused scan's kernels must be on the device
    timeline.  Prints where the time
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
    edge = [e for e in on_device if "edge_abs_diff_matmul_kernel" in e.key]
    edge_us, edge_n = sum(e.self_device_time_total for e in edge), sum(e.count for e in edge)
    if edge_us == 0:
        fail("the profiler traced device kernels but not the edge kernel")
    if edge_n != edge_per_episode:
        fail(f"the profiled episode ran the edge kernel {edge_n} times, the main path {edge_per_episode} an episode")
    split_us = sum(e.self_device_time_total for e in on_device if "edge_split_w_kernel" in e.key)
    print(f"profiler: edge kernel on the device timeline, {edge_n} launches, {edge_us / 1e3:.4f} ms device time in "
          f"one episode (W's split passes {split_us / 1e3:.4f} ms besides)")
    scan_symbols = ("TagConv1ScFwd", "TagConv2Fwd", "TagConv2Dx", "TagDwAllAdam", "bn_fwd_kernel", "bn_bwd_kernel")
    scan_us = {sym: sum(e.self_device_time_total for e in on_device if sym in e.key) for sym in scan_symbols}
    if min(scan_us.values()) == 0:
        fail(f"the profiler traced device kernels but not every kernel of the fused scan: {scan_us}")
    print(f"profiler: fused scan kernels on the device timeline, {sum(scan_us.values()) / 1e3:.3f} ms device time in "
          f"one episode: " + ", ".join(f"{sym} {us / 1e3:.3f}" for sym, us in scan_us.items()))
    print(f"profiler: episode {res.seconds[0]:.3f} s under the profiler, {steady_s:.3f} s without; "
          f"device time {busy_us / 1e6:.4f} s; idle share {1.0 - busy_us / 1e6 / steady_s:.4f}")
    ranges = [e for e in events if e.device_type == DeviceType.CPU and e.key.split(":")[0] in PHASES]
    for e in sorted(ranges, key=lambda e: -e.cpu_time_total):
        print(f"profiler phase {e.key}: host {e.cpu_time_total / 1e3:.3f} ms, device {e.device_time_total / 1e3:.3f} ms")
    print(f"profiler: the fused scan's {sum(scan_us.values()) / 1e3:.3f} ms belong to adapt:gnn; the profiler does not "
          f"attribute kernels launched from the C loop to the range that encloses the call")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profiler kernel {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d} calls  {e.key[:110]}")


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
    from mft_tpu_torch.kernels import build, fused_inner_scan

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
        report_build(name, log, build.BUILD_DIR)

    # 3. every kernel against its plain version
    rows = [phase_edge_kernel(torch, dev), phase_fused_inner_scan(torch, dev)]
    if "--kernels-only" in sys.argv[1:]:  # for work on a kernel: stop after the checks against the plain versions
        print("kernels only: stopping before the eval phases")
        return

    # 4. the eval on the card against the eval on the CPU
    phase_cross_device(torch, dev)

    # 5. the main path at full width
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as save_dir:
        pj = write_checkpoints(torch, save_dir)
        common = ["--device", "cuda", "--method", "all", "--use_pallas", "--test_dataset", "synthetic",
                  "--model", "ResNet10", "--image_size", "224", "--n_shot", "5", "--gen_examples", "17",
                  "--fine_tune_epoch", "5", "--paths_json", pj]
        argv = common + ["--inner_scan", "fused"]
        kernels.reset_launch_counts()
        steady = drive(finetune, "main path (--inner_scan fused)", argv, EPISODES)
        counts = kernels.launch_counts()
        print(f"main path kernel launches: {counts} (fused_inner_scan: one call per episode, each enqueues "
              f"{fused_inner_scan.kernels_per_step(torch.bfloat16)} device kernels per inner step)")
        for row in rows:
            row["launches"] = counts[row["name"]]
            if row["launches"] == 0:
                fail(f"kernel {row['name']} was never launched on the main path")

        # the eager inner loop in the same call, on the same host
        eager = drive(finetune, "eager path (--inner_scan eager)", common + ["--inner_scan", "eager"], 2)
        print(f"seconds/episode fused {steady:.4f} vs eager {eager:.4f} (same call): eager / fused = {eager / steady:.3f}")
        # the strict-parity numerics at the same width
        drive(finetune, "strict f32 path", common + ["--dtype", "float32", "--inner_param_dtype", "float32"], 2)
        phase_profile(torch, finetune, argv, steady, counts["edge_abs_diff_matmul"] // EPISODES)

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: row[k] for k in order} for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
