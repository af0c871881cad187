"""Pre-extracted feature store (a copy of ``mft_tpu/data/feature_store.py``).

The upstream cdfsl-benchmark ``save_features.py`` / ``test.py`` workflow,
whose scripts the reference lacks but whose loader it keeps
(data/feature_loader.py): a file of ``{all_feats [N, feat], all_labels [N],
count}`` read into a per-class dict (feature_loader.py:25-55).  The
container is ``.npz``, as in the JAX package; the reference's HDF5 reads
through a lazy ``h5py`` import, so nothing needs ``h5py`` until such a file
is read.  Plain numpy: the store holds host arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def save_features(path: str, all_feats: np.ndarray, all_labels: np.ndarray) -> None:
    """Write the feature bank (the upstream save_features.py's contract)."""
    np.savez(path, all_feats=np.asarray(all_feats), all_labels=np.asarray(all_labels), count=len(all_labels))


def load_features(path: str) -> Dict[int, np.ndarray]:
    """A per-class dict of ``[n_i, feat]`` arrays (the reference's
    ``init_loader``, feature_loader.py:25-55)."""
    if path.endswith((".hdf5", ".h5")):
        import h5py  # the reference's container, read only

        with h5py.File(path, "r") as f:
            count = int(f["count"][()]) if "count" in f else len(f["all_labels"])
            feats = np.asarray(f["all_feats"][:count])
            labels = np.asarray(f["all_labels"][:count])
    else:
        d = np.load(path)
        count = int(d["count"])
        feats = d["all_feats"][:count]
        labels = d["all_labels"][:count]
    return {int(c): feats[labels == c] for c in np.unique(labels)}


def sample_feature_episode(cl_data: Dict[int, np.ndarray], n_way: int, n_support: int, n_query: int,
                           rs: np.random.Generator):
    """``([n_way, n_support + n_query, feat], classes)`` from the per-class
    dict, drawn from ``rs`` in the JAX package's order (the upstream
    test.py's episode construction): a permutation of the classes, then each
    class's rows, with replacement where a class has too few."""
    classes = rs.permutation(sorted(cl_data))[:n_way]
    per = n_support + n_query
    eps = []
    for c in classes:
        pool = cl_data[int(c)]
        idx = rs.choice(len(pool), size=per, replace=len(pool) < per)
        eps.append(pool[idx])
    return np.stack(eps), classes
