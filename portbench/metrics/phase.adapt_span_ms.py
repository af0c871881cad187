"""Host milliseconds an episode inside the eval engine's ``adapt:*`` spans
(both members' adaptation loops) of the untraced window: what
``phase.adapt_host_ms`` reads under the profiler, read without it from the
port's batch records (``mft_tpu_torch.utils.metrics.eval_batches``),
batches 1 to ``window_batches``.  None where the port keeps no such records
or spans (a port without the recorder; a mesh, whose workers adapt)."""


def read(ctx):
    try:
        from mft_tpu_torch.utils.metrics import eval_batches
    except ImportError:
        return None
    window = [b for b in eval_batches() if 1 <= b.index <= ctx["window_batches"]]
    ns = sum(v for b in window for k, v in b.totals.items() if k.startswith("adapt:"))
    if len(window) != ctx["window_batches"] or not ns:
        return None
    return ns / 1e6 / sum(b.episodes for b in window)
