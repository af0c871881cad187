"""The benchmark's frozen arithmetic: the card's peaks, the least times of
the two hand-written kernels (copies of ``chip_smoke.py``'s
``edge_bound_ms`` and ``fused_bound``), the model FLOPs of an episode
counted from the configuration's shapes, and the reduction of a profiler
trace (a copy of ``chip_smoke.py``'s ``trace_summary``, which reads the
kineto events without building the profiler's event tree).  Later changes
to the program do not change these."""

from __future__ import annotations

import bisect

#: H100 SXM published dense peaks
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

#: the eval's profiler ranges, ``<phase>:<member>``
PHASES = ("bank_fmap", "adapt", "embed", "score")


def edge_bound_ms(b: int, n: int, f: int, c: int, route: str = "function"):
    """Least time of one edge-op call ``|x_i - x_j| @ W + bias`` on ``[b, n,
    f]`` nodes and ``c`` channels: bytes (x, w, bias read once, the edge
    tensor written once) over the memory rate, or operations over their
    peak.  ``"function"``: the one product at the bf16 tensor-core peak, the
    least work any route does.  Returns ``(ms, what binds it)``."""
    if route == "function":
        flops, peak = 2.0 * b * n * n * f * c, PEAK_BF16_FLOPS
    elif route == "bf16x3":
        flops, peak = 3 * 2.0 * b * n * n * (-(-f // 16) * 16) * c, PEAK_BF16_FLOPS
    else:
        flops, peak = 2.0 * b * n * n * f * c + 2.0 * b * n * n * f + b * n * n * c, PEAK_F32_FLOPS
    nbytes = 4.0 * (b * n * f + c * f + c + b * n * n * c)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fused_bound(h_in: int, c_in: int, c_out: int, stride: int, batch: int, n_steps: int, carry_bytes: int,
                bank_bytes: int) -> dict:
    """Least times of an ``n_steps`` adaptation scan of one lane of the final
    block, from its shapes: the products (forward conv1, conv2, the 1x1
    shortcut; backward conv2's weight and input gradients, conv1's and the
    shortcut's weight gradients) over the bf16 peak, and the bytes the
    function must move (parameters read and written once, each step's bank
    rows, the schedule and labels) over the memory rate.  The block has the
    shortcut conv and its BN where ``c_in != c_out`` (the reference's rule);
    otherwise its shortcut is the identity, which costs nothing."""
    h_out = h_in // stride
    r, ci, co, b = batch * h_out * h_out, c_in, c_out, batch
    sc = ci if ci != co else 0  # the shortcut's input channels, 0 for the identity
    fwd = 2.0 * r * co * (9 * ci + 9 * co + sc)
    bwd = 2.0 * r * co * (9 * co + 9 * co + 9 * ci + sc)
    n_params = 9 * ci * co + 9 * co * co + sc * co + (6 if sc else 4) * co
    flops = (fwd + bwd) * n_steps
    nbytes = (2.0 * n_params * carry_bytes + float(n_steps) * b * h_in * h_in * ci * bank_bytes
              + n_steps * b * (4 + 4 + 4))
    return {"flops": flops, "bytes": nbytes, "params": n_params, "ms_tc": flops / PEAK_BF16_FLOPS * 1e3,
            "ms_bytes": nbytes / PEAK_BYTES * 1e3}


# --------------------------------------------------------------------------
# model FLOPs of an episode, from the shapes
# --------------------------------------------------------------------------


def _conv(h_out: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * h_out * h_out * c_out * c_in * k * k


def resnet_flops(image_size: int, widths=(64, 128, 256, 512), stage_sizes=(1, 1, 1, 1)) -> dict:
    """Forward FLOPs of one image through a ResNet of ``SimpleBlock`` units
    (ResNet10 by default; ResNet18 and ResNet34 by their ``stage_sizes``),
    every block counted: ``{"trunk", "final", "final_bwd"}``.  Block ``j``
    of stage ``i`` halves the resolution where ``i >= 1 and j == 0``, and has
    a 1x1 shortcut conv where its input and output widths differ.
    ``final_bwd`` is the final block's backward when its input is a
    constant (conv2's weight and input gradients, conv1's weight gradient
    and the shortcut's, where it has one)."""
    h = image_size // 2
    trunk = _conv(h, 3, widths[0], 7)
    h = (h + 1) // 2  # max pool
    blocks = []
    cin = widths[0]
    for i, (n, c) in enumerate(zip(stage_sizes, widths, strict=True)):
        for j in range(n):
            if i >= 1 and j == 0:
                h //= 2
            short = _conv(h, cin, c, 1) if cin != c else 0.0
            blocks.append((_conv(h, cin, c, 3) + _conv(h, c, c, 3) + short,
                           2 * _conv(h, c, c, 3) + _conv(h, cin, c, 3) + short))
            cin = c
    trunk += sum(fwd for fwd, _ in blocks[:-1])
    final, final_bwd = blocks[-1]
    return {"trunk": trunk, "final": final, "final_bwd": final_bwd}


def gnn_head_flops(n_graphs: int, n_way: int, n_support: int, proj: int, nf: int, feat: int, rows: int) -> float:
    """The GnnNet head of one episode: the projector on ``rows`` features,
    then ``n_graphs`` graphs of ``n_way * (n_support + 1)`` nodes through
    two ``Wcompute`` + ``Gconv`` layers and the last pair (edge MLP widths
    2nf, 2nf, nf, nf, 1)."""
    n = n_way * (n_support + 1)
    total = 2.0 * rows * feat * proj
    f = proj + n_way
    widths = (2 * nf, 2 * nf, nf, nf, 1)
    for layer in range(3):
        edges = n_graphs * n * n
        cin = f
        for w in widths:
            total += 2.0 * edges * cin * w
            cin = w
        total += 2.0 * n_graphs * n * n * 2 * f  # the graph products
        out = nf // 2 if layer < 2 else n_way
        total += 2.0 * n_graphs * n * 2 * f * out
        f += nf // 2
    return total


def episode_flops(config: dict, traffic: dict) -> float:
    """Model FLOPs of one episode of the configuration's eval, counted from
    its shapes (the backbone's ``stage_sizes`` and ``widths``, ResNet10's
    where it states none), whatever the program launches to compute them."""
    size = traffic["image_size"]
    n_way, n_shot, n_query = traffic["n_way"], traffic["n_shot"], traffic["n_query"]
    support, total = n_way * n_shot, n_way * (n_shot + n_query)
    r = resnet_flops(size, tuple(config.get("widths", (64, 128, 256, 512))),
                     tuple(config.get("stage_sizes", (1, 1, 1, 1))))
    full = r["trunk"] + r["final"]
    step = traffic["batch"] * (r["final"] + r["final_bwd"])
    bank_rows = (traffic["gen_examples"] + 3) * support
    flops = 0.0
    for member in config["members"]:
        if member == "linear":  # trunk on the clean support, the block and head trained on it
            steps = config["linear_epochs"] * support // traffic["batch"]
            flops += support * r["trunk"] + steps * step + total * full
        else:  # the trunk on the clean support and each augmented replica, the scan, the embed
            steps = traffic["fine_tune_epoch"] * bank_rows // traffic["batch"]
            flops += (traffic["gen_examples"] + 1) * support * r["trunk"] + steps * step + total * full
            head = config["head"]
            flops += gnn_head_flops(n_query, n_way, n_shot, head["proj"], head["nf"], head["feat"], total)
            if member == "dampnet":  # two NTNs (bilinear + linear) and two 3-layer MLPs
                d, k, h = head["feat"], head["ntn"], head["mlp"]
                flops += 2 * (2.0 * k * d * d + 2.0 * k * 2 * d) + 2 * 2.0 * (2 * k * h + h * h + h * d)
                flops += 2.0 * total * d
    return flops


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------


def trace_summary(prof, phases=PHASES) -> dict:
    """Sums over the raw trace of a profile (``prof.profiler.kineto_results``),
    without building the profiler's Python event tree: device busy
    microseconds (kernels, copies, sets), per kernel name ``(microseconds,
    calls)``, per range named ``<phase>:<member>`` its host microseconds and
    the device microseconds of the kernels that start inside its span on the
    device's timeline; besides, the device's idle gaps, each named by the
    host range (or none) that was open at its midpoint."""
    from torch.autograd import DeviceType

    host, spans, kernels, host_spans = {}, [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        ranged = e.is_user_annotation()
        phase = name.split(":")[0] in phases
        if e.device_type() == DeviceType.CPU:
            if ranged and phase:
                host[name] = host.get(name, 0.0) + e.duration_ns() / 1e3
                host_spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif phase:  # a range's annotation on the device's timeline
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif not ranged:
            kernels.append((e.start_ns(), e.duration_ns() / 1e3, name))
    spans.sort()
    starts = [sp[0] for sp in spans]
    device, by_name, busy = {}, {}, 0.0
    for start, us, name in kernels:
        busy += us
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, calls + 1)
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < spans[i][1]:
            device[spans[i][2]] = device.get(spans[i][2], 0.0) + us
    return {"busy_us": busy, "kernels": by_name, "host_us": host, "device_us": device,
            "idle_us": _idle_by_host_range(kernels, host_spans)}


def _idle_by_host_range(kernels, host_spans) -> dict:
    """Idle device microseconds between the first and the last kernel, each
    gap named by the host range open at its midpoint (``driver`` where none
    is: the driver's loop, the input, the answers' way back)."""
    if not kernels:
        return {}
    kernels = sorted(kernels)
    host_spans = sorted(host_spans)
    starts = [s[0] for s in host_spans]
    idle, end = {}, kernels[0][0] + kernels[0][1] * 1e3
    for start, us, _ in kernels[1:]:
        if start > end:
            mid = (start + end) / 2
            name = "driver"
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0:  # the innermost open range: the latest start whose span holds mid
                if host_spans[i][1] >= mid:
                    name = host_spans[i][2]
                    break
                i -= 1
            idle[name] = idle.get(name, 0.0) + (start - end) / 1e3
        end = max(end, start + us * 1e3)
    return idle


def breakdown(summary: dict, n: int = 10) -> dict:
    """The trace's ``device_ops`` (kernels with the most device seconds) and
    ``idle_gaps`` (idle device seconds by host range), ``n`` of each."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:n]
    gaps = sorted(summary["idle_us"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[name, us / 1e6] for name, (us, _) in ops],
            "idle_gaps": [[name, us / 1e6] for name, us in gaps]}
