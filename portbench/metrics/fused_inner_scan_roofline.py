"""The adaptation scan's share of its roofline, in percent: the least time
of the member's adaptation (every lane's ``epochs * bank / batch`` steps of
the final block's forward, backward and Adam, the larger of its operations
over the bf16 peak and its bytes over the memory rate; ``fused_bound``)
over the device time of the kernels inside the member's ``adapt:<member>``
range.  The work is counted from the shapes, so it reads alike whatever
computes it."""


def read(ctx):
    t, cfg, tr = ctx["trace"], ctx["config"], ctx["traffic"]
    if t is None or "scan" not in cfg:
        return None
    sc = cfg["scan"]
    us = t["device_us"].get(f"adapt:{sc['member']}", 0.0)
    if not us:
        return None
    rows = (tr["gen_examples"] + 3) * tr["n_way"] * tr["n_shot"]
    steps = tr["fine_tune_epoch"] * rows // sc["batch"]
    b = ctx["yardstick"].fused_bound(sc["h_in"], sc["c_in"], sc["c_out"], sc["stride"], sc["batch"], steps,
                                     sc["carry_bytes"], sc["bank_bytes"])
    least_ms = max(b["ms_tc"], b["ms_bytes"]) * ctx["profiled_episodes"]
    return 100.0 * least_ms / (us / 1e3)
