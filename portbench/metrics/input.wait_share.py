"""The share of the window that the driver waited for its episodes: the
port's ``input:wait`` spans (``data/pipeline.py``: each wait of the eval
loop for the next decoded episode of the stream) summed over the window's
lane batches, over the window's seconds.  Read from the port's batch
records (``mft_tpu_torch.utils.metrics.eval_batches``) of the untraced
window, batches 1 to ``window_batches``; None where the port keeps no such
records or spans (a port without the recorder; a mesh, whose workers
wait)."""


def read(ctx):
    try:
        from mft_tpu_torch.utils.metrics import eval_batches
    except ImportError:
        return None
    window = [b for b in eval_batches() if 1 <= b.index <= ctx["window_batches"]]
    if len(window) != ctx["window_batches"] or not any("input:wait" in b.totals for b in window):
        return None
    return sum(b.totals.get("input:wait", 0) for b in window) / 1e9 / ctx["window_seconds"]
