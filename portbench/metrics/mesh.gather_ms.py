"""The mesh's own cost of a global batch, in milliseconds: the mean over the
window's batches of the batch's seconds less its slowest shard's seconds in
its worker (``EvalResult.shard_seconds``): the dispatch, the answers' way
back and the gather.  Nothing to read off a mesh."""


def read(ctx):
    rows = [(b, max(s)) for b, s in zip(ctx["batch_seconds"], ctx["shard_seconds"]) if s]
    if not rows or ctx["cards"] < 2:
        return None
    return 1e3 * sum(b - s for b, s in rows) / len(rows)
