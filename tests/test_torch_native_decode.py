"""The port's native (C/libjpeg) decoder (``mft_tpu_torch/data/native_decode.py``
and its own ``_native/decode.c``) against PIL and against the JAX package's
library, on the same JPEGs:

* bit-identical to PIL (the port's ``pipeline.decode_image``) and to the JAX
  package's library, at every draft scale (8/4/2/1), grayscale,
  progressive, 4:4:4 and 4:2:0, and with ``MFT_DRAFT_DECODE=0``;
* per-file statuses (not a JPEG, missing, CMYK, truncated) as in JAX, each
  such file decoded through PIL by ``decode_many``;
* ``MFT_NATIVE_DECODE`` ``0``/``auto``/``1`` as in JAX, ``describe``'s reason;
* the port's ``EpisodeStream`` gives the same episodes on both backends;
* the library builds into ``mft_tpu_torch/_build/``, not the source tree.

Tolerance: none; every comparison is bit for bit.
"""

import concurrent.futures as cf
import io
import os
import zlib

import numpy as np
import pytest
from PIL import Image

from mft_tpu.data import native_decode as jnd
from mft_tpu_torch.data import native_decode as nd
from mft_tpu_torch.data.pipeline import decode_image


@pytest.fixture(autouse=True)
def _library():
    if nd._load() is None:
        pytest.skip(f"the native decode library is unavailable here: {nd.describe()[1]}")


def _jpeg_bytes(rs, w, h, mode="RGB", quality=88, **kw):
    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).convert(mode).save(buf, "JPEG", quality=quality,
                                                                                       **kw)
    return buf.getvalue()


CASES = [  # (w, h, mode, save kwargs): draft scales at base 64 / 257 in the comments
    (2100, 1500, "RGB", {}),                      # 8 at 64, 4 at 257
    (600, 400, "RGB", {}),                        # 4 at 64, 1 at 257
    (300, 200, "RGB", {"subsampling": 2}),        # 2 at 64, 4:2:0
    (160, 120, "RGB", {}),                        # 1 at 64
    (640, 560, "RGB", {"subsampling": 0}),        # 8 at 64, 4:4:4
    (2100, 1500, "RGB", {"progressive": True}),   # progressive + draft
    (520, 519, "RGB", {}),                        # off-by-one draft boundary
    (257, 257, "RGB", {}),                        # identity resize at 257
    (100, 80, "RGB", {}),                         # upscale
    (300, 200, "L", {}),                          # grayscale -> RGB replication
]


@pytest.mark.parametrize("w,h,mode,kw", CASES)
def test_bit_identical_to_pil_and_to_the_jax_library(tmp_path, w, h, mode, kw):
    rs = np.random.RandomState(zlib.crc32(f"{w}x{h}:{mode}:{sorted(kw.items())}".encode()) % 2**31)
    data = _jpeg_bytes(rs, w, h, mode=mode, **kw)
    p = tmp_path / "img.jpg"
    p.write_bytes(data)
    for base in (257, 64):
        native = nd.decode_jpeg_bytes(data, base, draft=True)
        assert native is not None
        assert np.array_equal(native, decode_image(str(p), base)), f"vs PIL at base {base}"
        assert np.array_equal(native, jnd.decode_jpeg_bytes(data, base, draft=True)), f"vs JAX at base {base}"


def test_no_draft_matches_pil(tmp_path, monkeypatch):
    data = _jpeg_bytes(np.random.RandomState(3), 1200, 900)
    p = tmp_path / "img.jpg"
    p.write_bytes(data)
    monkeypatch.setenv("MFT_DRAFT_DECODE", "0")
    native = nd.decode_jpeg_bytes(data, 128, draft=False)
    assert np.array_equal(native, decode_image(str(p), 128))
    assert np.array_equal(native, jnd.decode_jpeg_bytes(data, 128, draft=False))
    with cf.ThreadPoolExecutor(1) as pool:  # decode_many reads the variable too
        assert np.array_equal(nd.decode_many([str(p)], 128, pool=pool, workers=1, fallback=decode_image)[0], native)


def test_resample_bit_exact_vs_pil_and_jax():
    rs = np.random.RandomState(7)
    for w, h, ow, oh in [(300, 200, 257, 257), (100, 80, 257, 257), (331, 77, 64, 64)]:
        arr = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
        native = nd.resample_rgb(arr, ow, oh)
        assert np.array_equal(native, np.asarray(Image.fromarray(arr).resize((ow, oh), Image.BILINEAR)))
        assert np.array_equal(native, jnd.resample_rgb(arr, ow, oh))


def test_batch_statuses_as_in_jax(tmp_path):
    rs = np.random.RandomState(1)
    jp, png, cmyk, trunc = (tmp_path / n for n in ("a.jpg", "b.png", "c.jpg", "d.jpg"))
    jp.write_bytes(_jpeg_bytes(rs, 320, 240))
    Image.fromarray(rs.randint(0, 256, (60, 80, 3), dtype=np.uint8)).save(png, "PNG")
    Image.fromarray(rs.randint(0, 256, (60, 80, 3), dtype=np.uint8)).convert("CMYK").save(cmyk, "JPEG")
    data = _jpeg_bytes(rs, 800, 600)
    trunc.write_bytes(data[: len(data) // 2])
    paths = [str(jp), str(png), str(tmp_path / "missing.jpg"), str(cmyk), str(trunc)]
    out, status = nd.decode_batch(paths, 64, threads=2)
    assert status.tolist() == [nd.OK, nd.ERR_NOT_JPEG, nd.ERR_IO, nd.ERR_UNSUPPORTED, nd.ERR_TRUNCATED]
    jout, jstatus = jnd.decode_batch(paths, 64, threads=2)
    assert np.array_equal(status, jstatus) and np.array_equal(out[0], jout[0])
    assert np.array_equal(out[0], decode_image(str(jp), 64))
    assert nd.decode_jpeg_bytes(data[: len(data) // 2], 64) is None  # a truncated stream is refused


def test_decode_many_falls_back_per_file(tmp_path, monkeypatch):
    """Paths (JPEG, PNG, CMYK, truncated) and an in-memory array, in order,
    equal to decode_image on each, on both backends."""
    rs = np.random.RandomState(2)
    jp, png, cmyk, trunc = (tmp_path / n for n in ("a.jpg", "b.png", "c.jpg", "d.jpg"))
    jp.write_bytes(_jpeg_bytes(rs, 500, 300))
    Image.fromarray(rs.randint(0, 256, (60, 80, 3), dtype=np.uint8)).save(png, "PNG")
    Image.fromarray(rs.randint(0, 256, (60, 80, 3), dtype=np.uint8)).convert("CMYK").save(cmyk, "JPEG")
    data = _jpeg_bytes(rs, 800, 600)
    trunc.write_bytes(data[: len(data) // 2])
    items = [str(jp), str(png), rs.rand(40, 40, 3).astype(np.float32), str(cmyk), str(trunc), str(jp)]
    want = [decode_image(it, 64) for it in items]
    calls = []

    def fallback(item, base):
        calls.append(item if isinstance(item, str) else "array")
        return decode_image(item, base)

    with cf.ThreadPoolExecutor(2) as pool:
        for mode in ("1", "0"):
            monkeypatch.setenv("MFT_NATIVE_DECODE", mode)
            calls.clear()
            got = nd.decode_many(items, 64, pool=pool, workers=2, fallback=fallback)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
            if mode == "1":  # only what the library refuses goes through PIL
                assert sorted(calls) == sorted([str(png), "array", str(cmyk), str(trunc)])
            else:
                assert len(calls) == len(items)


def test_backend_env_semantics(monkeypatch):
    monkeypatch.setenv("MFT_NATIVE_DECODE", "0")
    assert nd.backend() == jnd.backend() == "pil"
    assert nd.describe() == ("pil", "MFT_NATIVE_DECODE=0")
    monkeypatch.setenv("MFT_NATIVE_DECODE", "auto")
    assert nd.backend() == "native" and nd.describe()[1].endswith("bit-identical to PIL on the canary")
    monkeypatch.setenv("MFT_NATIVE_DECODE", "1")
    assert nd.backend() == "native"
    monkeypatch.setattr(nd, "_canary_ok", False)  # a host whose libjpeg differs from PIL's
    with pytest.raises(RuntimeError, match="cannot be used"):
        nd.backend()
    monkeypatch.setenv("MFT_NATIVE_DECODE", "auto")
    assert nd.backend() == "pil" and "canary" in nd.describe()[1]


def test_library_builds_outside_the_source_tree():
    path = nd.lib_path()
    assert path.exists() and path.parent.name == "_build" and path.parent.parent.name == "mft_tpu_torch"
    assert not any(f.endswith(".so") for f in os.listdir(nd.SRC.parent))


def test_episode_stream_native_matches_pil(tmp_path, monkeypatch):
    """The port's EpisodeStream end to end: the same episodes on both backends."""
    from mft_tpu_torch.core.episode import EpisodeSpec
    from mft_tpu_torch.data.manifests import Manifest
    from mft_tpu_torch.data.pipeline import EpisodeStream

    rs = np.random.RandomState(5)
    items, labels = [], []
    for c in range(3):
        for i in range(4):
            p = tmp_path / f"c{c}_{i}.jpg"
            p.write_bytes(_jpeg_bytes(rs, 120 + 10 * i, 90, quality=80 + c))
            items.append(str(p))
            labels.append(c)
    man = Manifest(items=items, labels=np.asarray(labels), n_classes=3)
    spec = EpisodeSpec(n_way=2, n_support=1, n_query=1)

    def run():
        return [(np.asarray(im), np.asarray(cl)) for im, cl in EpisodeStream(man, spec, 2, base_size=48, seed=3)]

    monkeypatch.setenv("MFT_NATIVE_DECODE", "1")
    native = run()
    monkeypatch.setenv("MFT_NATIVE_DECODE", "0")
    pil = run()
    assert len(native) == 2
    for (ia, ca), (ib, cb) in zip(native, pil):
        assert np.array_equal(ia, ib) and np.array_equal(ca, cb)
