"""Host-side input pipeline: decode each image once, augment on the device
(port of ``mft_tpu/data/pipeline.py``: ``EpisodeStream``, ``BatchStream``,
``ReplayEpisodeStream``, ``ReplayBatchStream``).

Episodes come out as uint8 ``[n_way, n_support+n_query, base, base, 3]``
numpy arrays (the host layout); the eval moves them to the device and to
NCHW.  File items are decoded with PIL, imported at first use; in-memory
items (the synthetic and CIFAR datasets) need no decoder.  The JAX
package's native libjpeg decoder is not ported in this slice.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.data.manifests import Manifest
from mft_tpu_torch.data.sampler import EpisodicSampler


#: decode-pool width: 2x the cores, at most 16
WORKERS = max(1, min(16, 2 * (os.cpu_count() or 1)))
#: episodes decoded ahead of the one the device works on
PREFETCH = 2


def _resize_np(arr: np.ndarray, size: int) -> np.ndarray:
    """Nearest-ish resize for in-memory arrays (synthetic/CIFAR items)."""
    h, w = arr.shape[:2]
    yi = (np.arange(size) * (h / size)).astype(np.int64)
    xi = (np.arange(size) * (w / size)).astype(np.int64)
    return arr[yi][:, xi]


def decode_image(item, base_size: int) -> np.ndarray:
    """One manifest item -> uint8 ``[base, base, 3]``: the reference's
    aspect-squashing ``Resize([1.15s, 1.15s])`` at ``base = int(1.15*s)``."""
    if isinstance(item, np.ndarray):
        arr = item
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if arr.shape[0] != base_size or arr.shape[1] != base_size:
            arr = _resize_np(arr, base_size)
        return np.ascontiguousarray(arr)
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with Image.open(item) as im:
        # JPEG draft decode (libjpeg DCT scaling), as in the JAX package's
        # default host decode
        im.draft("RGB", (base_size, base_size))
        im = im.convert("RGB").resize((base_size, base_size), Image.BILINEAR)
        return np.asarray(im, np.uint8)


def _decode_many(items, base_size: int, pool: cf.Executor) -> np.ndarray:
    return np.stack(list(pool.map(lambda it: decode_image(it, base_size), items)))


class EpisodeStream:
    """Iterates decoded episodes ``(images, classes)``; a thread pool decodes
    and the next ``PREFETCH`` episodes load while the device works."""

    def __init__(self, manifest: Manifest, spec: EpisodeSpec, n_episodes: int, *, base_size: int = 256,
                 seed: int = 10):
        self.manifest = manifest
        self.spec = spec
        self.base_size = base_size
        self.sampler = EpisodicSampler(manifest.by_class(), spec, n_episodes, seed=seed)

    def _load(self, i: int, pool: cf.Executor):
        ep = self.sampler.episode(i)
        items = [self.manifest.items[j] for j in ep.items.reshape(-1)]
        images = _decode_many(items, self.base_size, pool).reshape(
            self.spec.n_way, self.spec.n_per_class, self.base_size, self.base_size, 3)
        return images, ep.classes

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        n = len(self.sampler)
        with cf.ThreadPoolExecutor(WORKERS) as decode, cf.ThreadPoolExecutor(PREFETCH) as ahead:
            futures = {i: ahead.submit(self._load, i, decode) for i in range(min(PREFETCH, n))}
            for i in range(n):
                if i + PREFETCH < n:
                    futures[i + PREFETCH] = ahead.submit(self._load, i + PREFETCH, decode)
                yield futures.pop(i).result()


class ReplayEpisodeStream:
    """Episodes from an explicit per-episode file manifest instead of the
    sampler: every file, slot and episode order is the caller's (a manifest
    recorded from the reference's own loader replays here one to one).
    ``episodes``: a list of episodes, each ``n_way`` lists of
    ``n_support + n_query`` paths, relative to ``root`` when it is given.
    Yields ``(images, None)``."""

    def __init__(self, episodes, spec: EpisodeSpec, *, base_size: int = 256, root: str | None = None):
        self.spec = spec
        self.base_size = base_size
        self.episodes = []
        for e, ways in enumerate(episodes):
            if len(ways) != spec.n_way or any(len(w) != spec.n_per_class for w in ways):
                raise ValueError(f"episode {e}: manifest shape {[len(w) for w in ways]} != "
                                 f"[{spec.n_per_class}] * {spec.n_way}")
            self.episodes.append([[os.path.join(root, p) if root else p for p in way] for way in ways])

    @classmethod
    def from_json(cls, path: str, spec: EpisodeSpec, *, base_size: int = 256, root: str | None = None):
        import json

        with open(path) as f:
            raw = json.load(f)
        return cls(raw["episodes"] if isinstance(raw, dict) else raw, spec, base_size=base_size, root=root)

    def __len__(self):
        return len(self.episodes)

    def __iter__(self):
        s = self.spec
        with cf.ThreadPoolExecutor(WORKERS) as pool:
            for ways in self.episodes:
                images = _decode_many([p for way in ways for p in way], self.base_size, pool)
                yield images.reshape(s.n_way, s.n_per_class, self.base_size, self.base_size, 3), None


class ReplayBatchStream:
    """Explicit minibatch replay for supervised pretraining, the
    ``BatchStream`` counterpart of :class:`ReplayEpisodeStream`: ``batches``
    are lists of paths (relative to ``root``), ``labels_by_path`` maps the
    un-rooted paths to labels.  Batches must share one size (static shapes)."""

    def __init__(self, batches, labels_by_path, *, base_size: int = 256, root: str | None = None):
        sizes = {len(b) for b in batches}
        if len(sizes) != 1:
            raise ValueError(f"ragged replay batches {sorted(sizes)}: static shapes require "
                             f"uniform batch size")
        self.base_size = base_size
        self.labels = [np.asarray([labels_by_path[p] for p in b], np.int64) for b in batches]
        self.batches = [[os.path.join(root, p) if root else p for p in b] for b in batches]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        with cf.ThreadPoolExecutor(WORKERS) as pool:
            for batch, labels in zip(self.batches, self.labels):
                yield _decode_many(batch, self.base_size, pool), labels


class BatchStream:
    """Flat shuffled minibatches for supervised pretraining, as
    ``DataLoader(batch_size, shuffle=True)`` (SimpleDataManager,
    data/datamgr.py:50-62): an epoch-wide permutation chunked into batches,
    every item at most once per pass, re-permuted when ``n_batches`` asks
    for more than one pass.  The permutations come from a Philox generator
    keyed by ``seed``, so the JAX package's stream gives the same batches."""

    def __init__(self, manifest: Manifest, batch_size: int, n_batches: int, *, base_size: int = 256,
                 seed: int = 10):
        self.manifest = manifest
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.base_size = base_size
        self.seed = seed

    def __len__(self):
        return self.n_batches

    def __iter__(self):
        rs = np.random.Generator(np.random.Philox(key=self.seed))
        perm, used = rs.permutation(len(self.manifest)), 0
        with cf.ThreadPoolExecutor(WORKERS) as pool:
            for _ in range(self.n_batches):
                if used + self.batch_size > len(perm):
                    perm, used = rs.permutation(len(self.manifest)), 0
                if self.batch_size > len(perm):  # tiny dataset: pad by re-permuting
                    reps = -(-self.batch_size // len(perm))
                    idx = np.concatenate([rs.permutation(len(perm)) for _ in range(reps)])[: self.batch_size]
                else:
                    idx = perm[used : used + self.batch_size]
                    used += self.batch_size
                yield _decode_many([self.manifest.items[j] for j in idx], self.base_size, pool), self.manifest.labels[idx]
