"""Step programs of the fused scan an episode that the port ran one after
another in the untraced window: its ``scan.grid_steps`` counter (a step
whose grids cover every lane of the call counts once; where the lanes run
in turn, each lane's step counts once) summed over the window's lane
batches of the port's batch records
(``mft_tpu_torch.utils.metrics.eval_batches``), batches 1 to
``window_batches``, over their episodes.  None where the port keeps no such
records or counter."""


def read(ctx):
    try:
        from mft_tpu_torch.utils.metrics import eval_batches
    except ImportError:
        return None
    window = [b for b in eval_batches() if 1 <= b.index <= ctx["window_batches"]]
    steps = sum(b.counters.get("scan.grid_steps", 0) for b in window)
    if len(window) != ctx["window_batches"] or not steps:
        return None
    return steps / sum(b.episodes for b in window)
