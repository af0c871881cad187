"""The GNN edge kernel's share of its roofline, in percent: the least time
of the batch's edge-op calls (one per ``Wcompute``, all the batch's graphs
in each; ``edge_bound_ms(..., "function")``: the one product at the bf16
peak or the bytes at the memory rate) over the device time of the kernels
named ``edge_abs_diff_matmul_kernel`` and its weight split
``edge_split_w_kernel``."""


def read(ctx):
    t, cfg, tr = ctx["trace"], ctx["config"], ctx["traffic"]
    if t is None or "edge" not in cfg:
        return None
    us = sum(v for k, (v, _) in t["kernels"].items()
             if "edge_abs_diff_matmul_kernel" in k or "edge_split_w_kernel" in k)
    if not us:
        return None
    e = cfg["edge"]
    graphs = ctx["lanes"] * tr["n_query"]
    least_ms = sum(ctx["yardstick"].edge_bound_ms(graphs, e["nodes"], f, e["channels"])[0] for f in e["features"])
    return 100.0 * least_ms * ctx["profiled_batches"] / (us / 1e3)
