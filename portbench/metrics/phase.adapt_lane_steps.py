"""Adaptation steps an episode that the port ran in the untraced window:
its ``adapt.lane_steps`` counter (each lane's step of the fused scan or of
an eager inner loop counts once) summed over the window's lane batches of
the port's batch records (``mft_tpu_torch.utils.metrics.eval_batches``),
batches 1 to ``window_batches``, over their episodes.  None where the port
keeps no such records or counter."""


def read(ctx):
    try:
        from mft_tpu_torch.utils.metrics import eval_batches
    except ImportError:
        return None
    window = [b for b in eval_batches() if 1 <= b.index <= ctx["window_batches"]]
    steps = sum(b.counters.get("adapt.lane_steps", 0) for b in window)
    if len(window) != ctx["window_batches"] or not steps:
        return None
    return steps / sum(b.episodes for b in window)
