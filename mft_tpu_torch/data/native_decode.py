"""ctypes binding of the port's native (C/libjpeg) decode pipeline (its own
copy of ``mft_tpu/data/native_decode.py``, same C ABI and semantics).

``_native/decode.c`` decodes JPEGs with libjpeg's draft scaling and resizes
them with a bit-exact reimplementation of PIL's fixed-point antialiased
BILINEAR resample, on an in-library pthread pool that runs without the GIL.
It is built at first use with the host's C compiler (``cc -O2 -shared
-fPIC ... -ljpeg -lpthread``) into ``mft_tpu_torch/_build/``, never into
the source tree; the file name carries a hash of the source and the flags,
so an edited source rebuilds.

Backend selection (``MFT_NATIVE_DECODE``), as in the JAX package:

* ``auto`` (default): the native library iff it builds and loads AND a
  canary proves its output BIT-IDENTICAL to the PIL path on representative
  JPEGs (draft scales 8/4/2/1, grayscale, progressive, 4:4:4 and 4:2:0);
  otherwise PIL.  The decoded-episode cache key does not name the backend,
  so the two must give the same bytes.  :func:`describe` says which backend
  ``auto`` chose and why.
* ``1``: require native (raises if the library is unavailable or the canary
  fails).
* ``0``: force PIL.

``MFT_DRAFT_DECODE=0`` turns the JPEG draft (DCT-domain) downscale off on
both backends.  Non-JPEG files, CMYK JPEGs, truncated streams and any other
per-file failure go through the PIL path one file at a time (the C side
reports a status per file).
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "_native" / "decode.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ["-O2", "-shared", "-fPIC"]
LIBS = ["-ljpeg", "-lpthread"]
_ABI = 1

# status codes mirrored from decode.c
OK = 0
ERR_DECODE = 1
ERR_NOT_JPEG = 2
ERR_IO = 3
ERR_UNSUPPORTED = 4
ERR_TRUNCATED = 5  # damaged stream: synthesized pixels would be backend-defined

_lock = threading.Lock()
_lib = None
_lib_tried = False
_why_unavailable = ""
_canary_ok: bool | None = None


def lib_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(CFLAGS + LIBS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmftdecode-{digest}.so"


def build() -> str:
    """Compile ``decode.c`` into :func:`lib_path` unless it is there.
    Returns "" on success, else the compilers' complaints."""
    out = lib_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")  # pid-unique: concurrent builders must not interleave
    errors = []
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run([cc, *CFLAGS, str(SRC), "-o", str(tmp), *LIBS], capture_output=True, text=True,
                               timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return ""
        errors.append(f"{cc}: {r.stderr.strip()[-400:]}")
    if tmp.exists():
        tmp.unlink()
    return "; ".join(errors)


def _load():
    """The shared library (built first if needed), or None if unavailable."""
    global _lib, _lib_tried, _why_unavailable
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        err = build()
        if err:
            _why_unavailable = f"the C build failed ({err})"
            return None
        try:
            lib = ctypes.CDLL(str(lib_path()))
            abi = lib.mft_abi_version()
        except (OSError, AttributeError) as e:
            _why_unavailable = f"the library does not load ({e})"
            return None
        if abi != _ABI:
            _why_unavailable = f"the library's ABI is {abi}, not {_ABI}"
            return None
        lib.mft_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.mft_decode_jpeg.restype = ctypes.c_int
        lib.mft_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.mft_decode_batch.restype = ctypes.c_int
        lib.mft_resample_rgb.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int]
        lib.mft_resample_rgb.restype = ctypes.c_int
        _lib = lib
        return _lib


def decode_jpeg_bytes(data: bytes, base_size: int, draft: bool = True) -> np.ndarray | None:
    """Native decode of one in-memory JPEG to uint8 [base, base, 3]; None on
    any failure (the caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((base_size, base_size, 3), np.uint8)
    rc = lib.mft_decode_jpeg(data, len(data), base_size, int(draft), out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == OK else None


def resample_rgb(arr: np.ndarray, out_w: int, out_h: int) -> np.ndarray | None:
    """Native PIL-equivalent antialiased bilinear resample (tests)."""
    lib = _load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected uint8 [h, w, 3], got {arr.shape}")
    h, w = arr.shape[:2]
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.mft_resample_rgb(arr.ctypes.data_as(ctypes.c_void_p), w, h, out.ctypes.data_as(ctypes.c_void_p),
                              out_w, out_h)
    return out if rc == 0 else None


def decode_batch(paths, base_size: int, draft: bool = True, threads: int = 16):
    """Native parallel decode of ``paths``.  Returns (images uint8 [n, base,
    base, 3], status int32 [n]) or None if the library is unavailable;
    nonzero statuses mark files the caller decodes through PIL."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, base_size, base_size, 3), np.uint8)
    status = np.empty(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.mft_decode_batch(arr, n, base_size, int(draft), int(threads), out.ctypes.data_as(ctypes.c_void_p),
                         status.ctypes.data_as(ctypes.c_void_p))
    return out, status


def _pil_reference(data: bytes, base_size: int) -> np.ndarray:
    """The PIL path of ``pipeline.decode_image`` (draft on), on in-memory bytes."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with Image.open(io.BytesIO(data)) as im:
        im.draft("RGB", (base_size, base_size))
        im = im.convert("RGB").resize((base_size, base_size), Image.BILINEAR)
        return np.asarray(im, np.uint8)


#: the canary's JPEGs (w, h, mode, save kwargs): at base 64 the draft scale
#: is min(w//64, h//64) snapped down to {8, 4, 2, 1}
CANARY_CASES = (
    (600, 400, "RGB", {}),                       # scale 4, 4:2:0
    (160, 120, "RGB", {}),                       # scale 1
    (300, 200, "L", {}),                         # scale 2, grayscale
    (640, 560, "RGB", {"subsampling": 0}),       # scale 8, 4:4:4
    (520, 260, "RGB", {"progressive": True}),    # scale 4, progressive
    (200, 140, "RGB", {"subsampling": 2}),       # scale 2, 4:2:0 explicit
)


def _canary() -> bool:
    """Once per process: the native path bit-identical to PIL on
    :data:`CANARY_CASES`, whose libjpeg behaviour could differ between PIL's
    bundled libjpeg-turbo and the host's libjpeg."""
    global _canary_ok
    if _canary_ok is not None:
        return _canary_ok
    try:
        from PIL import Image
    except ImportError:
        _canary_ok = False
        return False
    rs = np.random.RandomState(0)
    ok = True
    for w, h, mode, kw in CANARY_CASES:
        buf = io.BytesIO()
        Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).convert(mode).save(buf, "JPEG", quality=88,
                                                                                           **kw)
        native = decode_jpeg_bytes(buf.getvalue(), 64, draft=True)
        if native is None or not np.array_equal(native, _pil_reference(buf.getvalue(), 64)):
            ok = False
            break
    _canary_ok = ok
    return ok


def describe() -> tuple[str, str]:
    """``(backend, why)``: the backend :func:`backend` picks under the
    current ``MFT_NATIVE_DECODE``, and the reason, for a log line."""
    mode = os.environ.get("MFT_NATIVE_DECODE", "auto").lower()
    if mode in ("0", "off", "pil"):
        return "pil", f"MFT_NATIVE_DECODE={mode}"
    if _load() is None:
        return "pil", _why_unavailable
    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return "pil", "PIL is not installed, so the canary cannot prove bit-identity"
    if not _canary():
        return "pil", "the canary is not bit-identical to PIL (a libjpeg variant mismatch)"
    return "native", f"{lib_path().name} built and bit-identical to PIL on the canary"


def backend() -> str:
    """'native' or 'pil' per ``MFT_NATIVE_DECODE`` (see the module docstring)."""
    mode = os.environ.get("MFT_NATIVE_DECODE", "auto").lower()
    name, why = describe()
    if mode in ("1", "on", "native") and name != "native":
        # forced mode must still be bit-identical: the decoded-episode cache
        # key excludes the backend, so a non-identical native decode would
        # poison caches that later PIL runs read
        raise RuntimeError(f"MFT_NATIVE_DECODE={mode} but the native decode cannot be used: {why}")
    return name


def decode_many(items, base_size: int, *, pool, workers: int, fallback) -> list:
    """A list of items (paths and/or in-memory arrays) -> a list of uint8
    [base, base, 3] arrays, in order.  Paths go through the native pthread
    batch when the backend is 'native'; arrays, non-JPEG files and every
    per-file native failure go through ``fallback`` (``pipeline.decode_image``)
    on the thread ``pool``.  With the 'pil' backend everything does."""
    path_idx = [i for i, it in enumerate(items) if isinstance(it, (str, os.PathLike))]
    out: list = [None] * len(items)
    if path_idx and backend() == "native":
        draft = os.environ.get("MFT_DRAFT_DECODE", "1") != "0"
        res = decode_batch([items[i] for i in path_idx], base_size, draft=draft, threads=workers)
        if res is not None:
            imgs, status = res
            for k, i in enumerate(path_idx):
                if status[k] == OK:
                    out[i] = imgs[k]
    rest = [i for i in range(len(items)) if out[i] is None]
    for i, img in zip(rest, pool.map(lambda i: fallback(items[i], base_size), rest)):
        out[i] = img
    return out
