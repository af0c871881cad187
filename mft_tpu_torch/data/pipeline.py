"""Host-side input pipeline: decode each image once, augment on the device
(port of ``mft_tpu/data/pipeline.py``'s ``EpisodeStream``).

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
        imgs = list(pool.map(lambda it: decode_image(it, self.base_size), items))
        images = np.stack(imgs).reshape(self.spec.n_way, self.spec.n_per_class, self.base_size, self.base_size, 3)
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
