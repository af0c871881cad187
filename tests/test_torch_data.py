"""The port's host data layer and config (mft_tpu_torch/data/, config.py)
against the JAX package's: the same seed gives the same episodes, byte for
byte, and the registry, checkpoint layout and manifests agree.  Exact
comparisons: this code is numpy and Python on both sides.
"""

import json
import os

import numpy as np
import pytest

from mft_tpu import config as jcfg
from mft_tpu.core.episode import EpisodeSpec as JSpec
from mft_tpu.data import manifests as jmf
from mft_tpu.data import pipeline as jpipe
from mft_tpu.data import registry as jreg
from mft_tpu_torch import config as tcfg
from mft_tpu_torch.core.episode import EpisodeSpec as TSpec
from mft_tpu_torch.data import manifests as tmf
from mft_tpu_torch.data import pipeline as tpipe
from mft_tpu_torch.data import registry as treg


@pytest.mark.parametrize("spec,base,seed", [((5, 5, 3), 40, 10), ((3, 2, 4), 23, 7)])
def test_episode_stream_matches(spec, base, seed):
    jm, tm = jmf.synthetic(base_size=32), tmf.synthetic(base_size=32)
    js = jpipe.EpisodeStream(jm, JSpec(*spec), 3, base_size=base, seed=seed, workers=2)
    ts = tpipe.EpisodeStream(tm, TSpec(*spec), 3, base_size=base, seed=seed)
    got, want = list(ts), list(js)
    assert len(got) == len(want) == 3
    for (ti, tc), (ji, jc) in zip(got, want):
        assert ti.dtype == np.uint8 and ti.shape == (spec[0], spec[1] + spec[2], base, base, 3)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tc, jc)


def test_registry_matches():
    assert treg.names() == jreg.names()
    for name in jreg.names():
        t, j = treg.get(name), jreg.get(name)
        assert t.n_classes == j.n_classes, name
        assert t.train_aug._asdict() == j.train_aug._asdict(), name
        assert t.eval_aug._asdict() == j.eval_aug._asdict(), name
        assert (t.split_builders is None) == (j.split_builders is None), name
    with pytest.raises(KeyError):
        treg.get("no_such_dataset")


def test_manifests_match(tmp_path):
    root = tmp_path / "imgs"
    for c in ("b_cls", "a_cls", "257.clutter"):
        os.makedirs(root / c)
        for f in ("2.jpg", "1.PNG", "notes.txt"):
            (root / c / f).write_bytes(b"")
    for build in ("image_folder", "caltech256"):
        t, j = getattr(tmf, build)(str(root)), getattr(jmf, build)(str(root))
        assert t.items == j.items and t.class_names == j.class_names and t.n_classes == j.n_classes, build
        np.testing.assert_array_equal(t.labels, j.labels)
    (tmp_path / "novel.json").write_text(json.dumps(
        {"label_names": ["x", "y", "z"], "image_names": ["p", "q", "r", "s"], "image_labels": [7, 3, 7, 9]}))
    want = jmf.json_filelist(str(tmp_path / "novel.json"))
    for t in (tmf.json_filelist(str(tmp_path / "novel.json")),
              treg.build_manifest(treg.get("CUB"), {"CUB": str(tmp_path)}, split="novel")):
        assert t.items == want.items and t.n_classes == want.n_classes == 3
        np.testing.assert_array_equal(t.labels, want.labels)


@pytest.mark.parametrize("item", [np.random.RandomState(0).rand(32, 32, 3).astype(np.float32),
                                  np.random.RandomState(1).randint(0, 256, (50, 40, 3)).astype(np.uint8)])
def test_decode_in_memory_item_matches(item):
    np.testing.assert_array_equal(tpipe.decode_image(item, 36), jpipe.decode_image(item, 36))


@pytest.mark.parametrize("method,kw", [("baseline", dict(train_aug=False)),
                                       ("baseline", dict(train_aug=True, n_way=5, n_shot=5)),
                                       ("gnnnet", dict(train_aug=True, n_way=5, n_shot=5)),
                                       ("gnnnet", dict(train_aug=False, n_way=5, n_shot=50))])
def test_checkpoint_dir_and_paths_match(method, kw):
    tp, jp = tcfg.Paths(save_dir="/x"), jcfg.Paths(save_dir="/x")
    assert tp.as_dict() == jp.as_dict()
    assert tcfg.checkpoint_dir(tp, "miniImageNet", "ResNet10", method, **kw) == \
        jcfg.checkpoint_dir(jp, "miniImageNet", "ResNet10", method, **kw)


def test_finetune_flag_defaults_match():
    """The port's eval flags keep the JAX driver's defaults (bf16 fast path
    included) and add only ``--device``, ``--inner_scan`` (which kernel
    path runs the GNN member's inner loop; the JAX package never wired its
    fused scan into an entry point) and the eval engine's four knobs, whose
    defaults are the JAX ``TransferCfg``'s (the JAX package sets them
    through ``bench.py``'s environment variables only)."""
    from mft_tpu.train import eval_engine as jee

    t = vars(tcfg.parse_finetune_args([]))
    j = vars(jcfg.parse_args("train", [], overrides={"dtype": "bfloat16", "inner_param_dtype": "bfloat16"}))
    assert t.pop("device") == "cuda"
    assert t.pop("inner_scan") == "eager"
    for knob in ("ensemble_fuse", "fanout_group_pass", "inner_gather", "inner_carry"):
        assert knob not in j and t.pop(knob) == getattr(jee.TransferCfg(), knob), knob
    for k, v in t.items():
        assert k in j and j[k] == v, k
