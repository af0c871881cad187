"""The share of the window that the driver spent staging its episodes: the
port's ``input:stack`` spans (``cli/finetune.py``: the batch's episodes
stacked into one host array) and ``input:to_device`` spans (its copy to
the card and the layout's permute) summed over the window's lane batches,
over the window's seconds.  Read from the port's batch records
(``mft_tpu_torch.utils.metrics.eval_batches``) of the untraced window,
batches 1 to ``window_batches``; None where the port keeps no such records
or spans."""

NAMES = ("input:stack", "input:to_device")


def read(ctx):
    try:
        from mft_tpu_torch.utils.metrics import eval_batches
    except ImportError:
        return None
    window = [b for b in eval_batches() if 1 <= b.index <= ctx["window_batches"]]
    if len(window) != ctx["window_batches"] or not any(n in b.totals for b in window for n in NAMES):
        return None
    return sum(b.totals.get(n, 0) for b in window for n in NAMES) / 1e9 / ctx["window_seconds"]
