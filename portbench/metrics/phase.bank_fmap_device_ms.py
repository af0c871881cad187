"""Device milliseconds an episode of the kernels that start inside the
``bank_fmap:*`` ranges (the frozen trunk on the support bank's replicas) of
the profiled batches."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["profiled_episodes"]:
        return None
    us = sum(v for k, v in t["device_us"].items() if k.startswith("bank_fmap:"))
    return us / 1e3 / ctx["profiled_episodes"] if us else None
