"""The episode mesh of the port's eval (counterpart of ``mft_tpu/parallel/mesh.py:35-63``).

The eval's episodes are independent, so they scale over devices along the
episode axis: the mesh is an ordered tuple of torch devices (the ``data``
axis; the JAX mesh's ``model`` axis has no user in the eval), and an
``[E, ...]`` lane batch splits into contiguous shards, one a device.  Each
shard runs in a worker process of its own (:class:`ShardPool`), so the
shards' host loops do not share one interpreter lock.  A caller may name a
device twice: two workers then share one card.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import traceback
from typing import Callable, Optional, Sequence

import torch


def make_mesh(devices: Optional[Sequence] = None) -> tuple:
    """The mesh over ``devices`` (torch devices or their names, in order,
    repeats allowed), by default every visible card; raises when there is
    none, rather than running on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card is visible; pass the devices (e.g. ['cpu']) explicitly")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def episode_sharding(n_shards: int, n_episodes: int, per_device: int) -> list:
    """Contiguous slices of ``n_episodes``, ``per_device`` to each of
    ``n_shards`` devices in order (the last one's may be short).  Refuses a
    batch that leaves a device with no episode, or does not fit."""
    if per_device < 1:
        raise ValueError(f"per_device must be at least 1, got {per_device}")
    slices = [slice(k * per_device, min((k + 1) * per_device, n_episodes)) for k in range(n_shards)]
    if n_episodes > n_shards * per_device or any(s.start >= s.stop for s in slices):
        raise ValueError(f"{n_episodes} episodes at {per_device} a device do not fill a mesh of {n_shards} "
                         "without an empty shard")
    return slices


def _serve(init: Callable, device: str, payload, inbox, outbox) -> None:
    """A shard's worker: ``step = init(device, payload)`` once, then
    ``step(*message)`` for each message until ``None``; every answer (or
    the traceback of a failure) goes back on ``outbox``."""
    try:
        step = init(torch.device(device), payload)
        outbox.put(("ok", None))
    except Exception:
        outbox.put(("error", traceback.format_exc()))
        return
    while (msg := inbox.get()) is not None:
        try:
            outbox.put(("ok", step(*msg)))
        except Exception:  # reported to the caller; the worker goes on serving
            outbox.put(("error", traceback.format_exc()))


class ShardPool:
    """One spawned worker process a device of ``mesh``, the k-th set up by
    ``init(device, payloads[k])`` (a module-level function; each payload is
    pickled to its worker).  :meth:`map` sends the k-th message to the k-th
    worker and returns the answers in shard order; a worker's failure, or
    its death, raises here.  A context manager: leaving it stops every
    worker."""

    def __init__(self, mesh: Sequence, init: Callable, payloads: Sequence):
        if len(payloads) != len(mesh):
            raise ValueError(f"{len(payloads)} payloads for a mesh of {len(mesh)}")
        ctx = mp.get_context("spawn")
        self._io = [(ctx.Queue(), ctx.Queue()) for _ in mesh]
        self._procs = [ctx.Process(target=_serve, args=(init, str(d), p, i, o), daemon=True)
                       for d, p, (i, o) in zip(mesh, payloads, self._io)]
        for p in self._procs:
            p.start()
        try:
            for k in range(len(mesh)):
                self._answer(k)  # set up
        except BaseException:
            self.close()
            raise

    def _answer(self, k: int):
        while True:
            try:
                status, value = self._io[k][1].get(timeout=1.0)
                break
            except queue.Empty:
                if not self._procs[k].is_alive():
                    raise RuntimeError(f"shard {k}'s worker exited with code {self._procs[k].exitcode}") from None
        if status != "ok":
            raise RuntimeError(f"shard {k}'s worker failed:\n{value}")
        return value

    def map(self, messages: Sequence[tuple]) -> list:
        if len(messages) > len(self._procs):
            raise ValueError(f"{len(messages)} messages for {len(self._procs)} workers")
        for k, msg in enumerate(messages):
            self._io[k][0].put(msg)
        answers, failures = [], []
        for k in range(len(messages)):  # every answer is read, so that none is left in a queue
            try:
                answers.append(self._answer(k))
            except RuntimeError as e:
                failures.append(e)
        if failures:
            raise failures[0]
        return answers

    def close(self) -> None:
        for p, (inbox, _) in zip(self._procs, self._io):
            if p.is_alive():
                inbox.put(None)
            inbox.cancel_join_thread()  # a dead worker's unread message must not hold this process at exit
        for p, (_, outbox) in zip(self._procs, self._io):
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
            outbox.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
