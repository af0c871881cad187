"""The device's idle share: 1 - (device busy seconds of the profiled
batches) / (the same number of batches' seconds untraced, at the window's
mean seconds a batch, the time between batches included)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["profiled_batches"] or not t["busy_us"]:
        return None
    untraced = ctx["window_seconds"] / ctx["window_batches"] * ctx["profiled_batches"]
    return 1.0 - t["busy_us"] / 1e6 / untraced
