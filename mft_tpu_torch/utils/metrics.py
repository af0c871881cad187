"""Run logs (a copy of ``AverageMeter`` and ``MetricLogger`` from
``mft_tpu/utils/metrics.py``): the reference's stdout lines and the same
``train_log.jsonl`` / ``eval_log.jsonl`` records, so
``tools/run_reference_train_e2e.py``'s ``parse_losses`` reads the port's log
as it reads the JAX driver's; and :func:`profile_trace`, the eval's
``--trace_dir``."""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass
from typing import Optional


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
