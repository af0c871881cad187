"""The share of the window that no lane batch covered: 1 - (the driver's
own seconds of the window's batches, ``EvalResult.batch_seconds``) / (the
window's seconds).  What is left is the host's work between synchronized
batches: stacking the next episodes, the accuracies' prints and the logger,
and any wait for the episode stream."""


def read(ctx):
    if not ctx["batch_seconds"]:
        return None
    return 1.0 - sum(ctx["batch_seconds"]) / ctx["window_seconds"]
