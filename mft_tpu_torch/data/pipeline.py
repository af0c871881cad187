"""Host-side input pipeline: decode each image once, augment on the device
(port of ``mft_tpu/data/pipeline.py``: ``EpisodeStream``, ``BatchStream``,
``ReplayEpisodeStream``, ``ReplayBatchStream``).

Episodes come out as uint8 ``[n_way, n_support+n_query, base, base, 3]``
numpy arrays (the host layout); the eval moves them to the device and to
NCHW.  File items go through the native libjpeg decoder when it is built
and bit-identical to PIL (``native_decode.py``, ``MFT_NATIVE_DECODE``), and
through PIL otherwise, as in the JAX pipeline; in-memory items (the
synthetic and CIFAR datasets) need no decoder.  ``MFT_DRAFT_DECODE=0``
turns JPEG draft decoding off on both backends.
``EpisodeStream(cache_dir=...)`` keeps each decoded episode as a uint8
``.npy`` under the JAX package's cache key, so a repeated eval skips the
decode.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import os

import numpy as np

from mft_tpu_torch.core.episode import EpisodeSpec
from mft_tpu_torch.data import native_decode
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
        # JPEG draft decode (libjpeg DCT scaling), the JAX package's default
        # host decode; MFT_DRAFT_DECODE=0 decodes at full size first
        if os.environ.get("MFT_DRAFT_DECODE", "1") != "0":
            im.draft("RGB", (base_size, base_size))
        im = im.convert("RGB").resize((base_size, base_size), Image.BILINEAR)
        return np.asarray(im, np.uint8)


def _decode_many(items, base_size: int, pool: cf.Executor) -> np.ndarray:
    return np.stack(native_decode.decode_many(items, base_size, pool=pool, workers=WORKERS, fallback=decode_image))


def cache_key(manifest: Manifest, spec: EpisodeSpec, n: int, seed: int, base_size: int) -> str:
    """The decoded-episode cache's content key (JAX ``EpisodeStream._cache_key``):
    any change to the file list (or in-memory array content), labels,
    episode geometry, seed, decode resolution or ``MFT_DRAFT_DECODE``
    invalidates the cache; the backend does not (the two give the same bytes)."""
    h = hashlib.sha1()
    for it in manifest.items:
        h.update(np.ascontiguousarray(it).tobytes() if isinstance(it, np.ndarray) else str(it).encode())
    h.update(np.asarray(manifest.labels).tobytes())
    h.update(f"|{spec}|{n}|{seed}|{base_size}|draft={os.environ.get('MFT_DRAFT_DECODE', '1')}".encode())
    return h.hexdigest()[:20]


class EpisodeStream:
    """Iterates decoded episodes ``(images, classes)``; a thread pool decodes
    and the next ``PREFETCH`` episodes load while the device works.

    ``cache_dir``: each decoded episode is kept as ``<cache_dir>/<key>/
    epNNNNN.npy`` (:func:`cache_key`) and read back on the next run instead
    of decoded; writes are atomic (temporary file, then rename) and a partly
    written cache is resumed episode by episode (mft_tpu/data/pipeline.py:95-198)."""

    def __init__(self, manifest: Manifest, spec: EpisodeSpec, n_episodes: int, *, base_size: int = 256,
                 seed: int = 10, cache_dir: str | None = None):
        self.manifest = manifest
        self.spec = spec
        self.base_size = base_size
        self.sampler = EpisodicSampler(manifest.by_class(), spec, n_episodes, seed=seed)
        self.cache_path = None
        if cache_dir:
            self.cache_path = os.path.join(cache_dir, cache_key(manifest, spec, n_episodes, seed, base_size))
            os.makedirs(self.cache_path, exist_ok=True)

    def _load(self, i: int, pool: cf.Executor):
        ep = self.sampler.episode(i)
        if self.cache_path is not None:
            f = os.path.join(self.cache_path, f"ep{i:05d}.npy")
            if os.path.exists(f):
                try:
                    return np.load(f), ep.classes
                except (OSError, ValueError):
                    pass  # a torn write of a crashed run: decode again
        items = [self.manifest.items[j] for j in ep.items.reshape(-1)]
        images = _decode_many(items, self.base_size, pool).reshape(
            self.spec.n_way, self.spec.n_per_class, self.base_size, self.base_size, 3)
        if self.cache_path is not None:
            tmp = f"{f}.{os.getpid()}.tmp.npy"
            np.save(tmp, images)
            os.replace(tmp, f)
        return images, ep.classes

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        return self.iterate(range(len(self.sampler)))

    def iterate(self, indices):
        """The episodes ``indices`` in that order (each a function of the
        seed and its index alone; the eval's mesh workers load their own)."""
        indices = list(indices)
        n = len(indices)
        with cf.ThreadPoolExecutor(WORKERS) as decode, cf.ThreadPoolExecutor(PREFETCH) as ahead:
            futures = {k: ahead.submit(self._load, indices[k], decode) for k in range(min(PREFETCH, n))}
            for k in range(n):
                if k + PREFETCH < n:
                    futures[k + PREFETCH] = ahead.submit(self._load, indices[k + PREFETCH], decode)
                yield futures.pop(k).result()


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
        return self.iterate(range(len(self.episodes)))

    def iterate(self, indices):
        """The recorded episodes ``indices`` in that order."""
        s = self.spec
        with cf.ThreadPoolExecutor(WORKERS) as pool:
            for i in indices:
                images = _decode_many([p for way in self.episodes[i] for p in way], self.base_size, pool)
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
