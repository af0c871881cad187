"""Run logs (a copy of ``AverageMeter`` and ``MetricLogger`` from
``mft_tpu/utils/metrics.py``): the reference's stdout lines and the same
``train_log.jsonl`` / ``eval_log.jsonl`` records, so
``tools/run_reference_train_e2e.py``'s ``parse_losses`` reads the port's log
as it reads the JAX driver's; :func:`profile_trace`, the eval's
``--trace_dir``; and the eval's span recorder (:func:`span`, :func:`count`,
:func:`eval_batch`, :func:`eval_batches`).

The recorder is always on.  Each span is a ``torch.profiler.record_function``
range, so a profiler (``--trace_dir`` or any other) shows it, and is also
kept in memory with its start and end on the profiler's host clock
(``time.time_ns``, the clock of a kineto event's ``start_ns``), its parent
span and its lane batch: the spans and counters of the eval's lane batches
are readable without a profiler.  A span or counter outside an
:func:`eval_batch` (in this thread) is kept nowhere.  No span touches the
device.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from torch.profiler import record_function


class AverageMeter:
    """Running average (reference utils.py:17-32)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


@dataclass
class MetricLogger:
    """stdout prints (reference format) + optional JSONL file."""

    jsonl_path: Optional[str] = None
    print_freq: int = 10  # meta_template.py:59

    def log_train(self, epoch: int, batch: int, n_batches: int, avg_loss: float, **extra):
        if batch % self.print_freq == 0:
            print(f"Epoch {epoch:d} | Batch {batch:d}/{n_batches:d} | Loss {avg_loss:f}")
        self._write({"kind": "train", "epoch": epoch, "batch": batch, "loss": avg_loss, **extra})

    def log_eval(self, n_episodes: int, acc_mean: float, ci95: float, **extra):
        # reference meta_template.py:149 / finetune.py:682 format
        print("%d Test Acc = %4.2f%% +- %4.2f%%" % (n_episodes, acc_mean, ci95))
        self._write({"kind": "eval", "episodes": n_episodes, "acc_mean": acc_mean, "ci95": ci95, **extra})

    def _write(self, rec: dict):
        if self.jsonl_path:
            os.makedirs(os.path.dirname(self.jsonl_path) or ".", exist_ok=True)
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (host, and the card's kernels
    when CUDA is available) written as a Chrome trace to
    ``<trace_dir>/trace_<pid>.json``; a no-op without ``trace_dir`` (the
    counterpart of JAX ``metrics.py``'s ``jax.profiler`` context)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


class Span:
    """One range of :func:`span`: ``name``, ``start_ns`` and ``end_ns`` on
    the profiler's host clock, the enclosing span's name (``parent``, None
    at the top of its thread) and the lane batch it ran in (``batch``, its
    index, or None outside :func:`eval_batch`)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "batch", "_rf", "_recorder")

    def __init__(self, recorder: "Recorder", name: str):
        self._recorder, self.name = recorder, name
        self.start_ns = self.end_ns = self.parent = self.batch = None

    def __enter__(self) -> "Span":
        local = self._recorder._local
        self.parent = local.open[-1].name if local.open else None
        self.batch = None if local.batch is None else local.batch.index
        local.open.append(self)
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()  # inside the range, so the span lies within the profiler's event
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        local = self._recorder._local
        local.open.pop()
        if local.batch is not None:
            local.batch.spans.append(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class EvalBatch:
    """The record of one lane batch of the eval (:func:`eval_batch`): its
    index in the ``evaluate`` call and its episodes; its ``eval:batch``
    span's ``start_ns`` / ``end_ns``; every span that closed inside it, in
    closing order; ``totals``, the nanoseconds of its spans summed by name;
    and ``counters`` (:func:`count`)."""

    index: int
    episodes: int
    start_ns: int = 0
    end_ns: int = 0
    spans: list = field(default_factory=list)
    totals: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _ThreadState(threading.local):
    def __init__(self):
        self.open = []  # the spans open in this thread, innermost last
        self.batch = None  # the lane batch open in this thread


class Recorder:
    """Spans and counters of the eval's lane batches, kept for the newest
    ``evaluate`` call (batch 0 starts a call's record) and for at most
    ``keep`` batches of it, the newest."""

    def __init__(self, keep: int = 1024):
        self._local = _ThreadState()
        self._batches = collections.deque(maxlen=keep)

    def span(self, name: str) -> Span:
        """A context manager: ``name`` as a profiler range and as a span of
        the open lane batch."""
        return Span(self, name)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the open lane batch's counter ``name``."""
        b = self._local.batch
        if b is not None:
            b.counters[name] = b.counters.get(name, 0) + n

    @contextlib.contextmanager
    def eval_batch(self, index: int, episodes: int):
        """Lane batch ``index`` of ``episodes`` episodes: the span
        ``eval:batch``, and every span and counter inside it (in this
        thread) is the batch's.  Yields its :class:`EvalBatch`, whose times
        and totals are filled when it closes."""
        if index == 0:
            self._batches.clear()
        rec = EvalBatch(index, episodes)
        self._local.batch = rec
        try:
            with self.span("eval:batch") as whole:
                yield rec
        finally:
            self._local.batch = None
            rec.start_ns, rec.end_ns = whole.start_ns, whole.end_ns
            for s in rec.spans:
                rec.totals[s.name] = rec.totals.get(s.name, 0) + s.end_ns - s.start_ns
            self._batches.append(rec)

    def eval_batches(self) -> list:
        """The newest ``evaluate`` call's lane batches, oldest first."""
        return list(self._batches)


#: the process's recorder: the eval driver, the input stream, the eval engine and the kernels write to it
RECORDER = Recorder()
span, count, eval_batch, eval_batches = RECORDER.span, RECORDER.count, RECORDER.eval_batch, RECORDER.eval_batches
