"""Host milliseconds an episode inside the eval engine's ``adapt:*`` ranges
(both members' adaptation loops) of the profiled batches: where the eager
loops' Python shows."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["profiled_episodes"]:
        return None
    us = sum(v for k, v in t["host_us"].items() if k.startswith("adapt:"))
    return us / 1e3 / ctx["profiled_episodes"] if us else None
