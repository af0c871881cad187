"""The flax checkpoint wire format, read and written without flax or msgpack.

The JAX package writes its ``<epoch>.ckpt`` files with
``flax.serialization.to_bytes`` (``mft_tpu/utils/checkpoint.py:27-45``): the
tree's flax state dict (dicts, lists and tuples all become maps keyed
``"0"``, ``"1"``, ...; an empty tuple, as optax's ``MaskedNode``, becomes
``{}``) packed as msgpack, with three extension types:

* ext 1, an ndarray: the msgpack array ``[shape, dtype name, C-order bytes]``;
* ext 2, a Python complex: ``[real, imag]``;
* ext 3, a numpy scalar: an ndarray payload of shape ``()``.

A leaf above ``MAX_CHUNK_SIZE`` bytes is written as a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`` of
flat pieces of at most that many bytes.

This module decodes and encodes exactly that subset of msgpack (nil, bool,
every int width, float32/64, str, bin, array, map, and the three
extensions), in pure Python and numpy.  ``bfloat16`` leaves, which numpy
does not know without ``ml_dtypes``, decode to ``torch.bfloat16`` tensors;
every other leaf decodes to a numpy array.  A file is read into one buffer
and every array is a view of it (no per-leaf copy of the file); the encoder
writes each array's buffer straight to the file.  The encoder emits the
shortest form of each value, as msgpack's own packer does, so a tree
encodes to the bytes flax writes for it.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np
import torch

#: flax.serialization.MAX_CHUNK_SIZE: leaves above this many bytes are chunked
MAX_CHUNK_SIZE = 2**30
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

#: torch dtypes by the numpy names that flax writes
_TORCH_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
    torch.bool: "bool", torch.complex64: "complex64", torch.complex128: "complex128",
}


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------


class _Decoder:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def bin_view(self) -> memoryview:
        b = self.take(1)[0]
        fmt = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(b)
        if fmt is None:
            raise ValueError(f"expected an ndarray's bin, got type byte 0x{b:02x}")
        return self.take(self.unpack(fmt))

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        inner = _Decoder(self.take(n))
        if code == EXT_COMPLEX:
            re, im = inner.obj()
            out = complex(re, im)
        elif code in (EXT_NDARRAY, EXT_NPSCALAR):
            out = inner.ndarray()
            if code == EXT_NPSCALAR:
                out = out[()] if isinstance(out, np.ndarray) else out.reshape(())
        else:
            raise ValueError(f"unsupported msgpack extension type {code}")
        if inner.pos != n:
            raise ValueError(f"extension type {code}: {n - inner.pos} bytes left over")
        return out

    def ndarray(self):
        """flax's ``(shape, dtype name, C-order bytes)``: a view of the buffer."""
        if self.take(1)[0] != 0x93:
            raise ValueError("an ndarray extension must hold a 3-element array")
        shape, name = self.obj(), self.obj()
        data = self.bin_view()
        if isinstance(name, bytes):
            name = name.decode()
        if name == "bfloat16":
            if len(data) == 0:
                return torch.empty(shape, dtype=torch.bfloat16)
            if data.readonly or np.frombuffer(data, np.uint8).ctypes.data % 2:  # torch wants a writable, aligned start
                data = memoryview(bytearray(data))
            return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)
        return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """flax ``_unchunk_array_leaves_in_place``: chunked maps -> arrays."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        cat = torch.cat if isinstance(chunks[0], torch.Tensor) else np.concatenate
        return cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data) -> object:
    """Bytes (or any buffer) in flax's format -> the tree (flax
    ``serialization.msgpack_restore``).  Arrays are views of ``data``."""
    dec = _Decoder(memoryview(data).cast("B"))
    tree = dec.obj()
    if dec.pos != len(dec.buf):
        raise ValueError(f"{len(dec.buf) - dec.pos} bytes after the end of the msgpack object")
    return _unchunk(tree)


def read(path: str) -> object:
    """The tree of a ``.ckpt`` file, read into one writable buffer."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    return msgpack_restore(buf)


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v >= 0:
        for fmt, code, top in ((">B", 0xCC, 0xFF), (">H", 0xCD, 0xFFFF), (">I", 0xCE, 0xFFFFFFFF),
                               (">Q", 0xCF, 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for fmt, code, low in ((">b", 0xD0, -(2**7)), (">h", 0xD1, -(2**15)), (">i", 0xD2, -(2**31)),
                               (">q", 0xD3, -(2**63))):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"{v} does not fit msgpack's 64-bit integers")


def _sized(n: int, fix_base: int, fix_max: int, codes) -> bytes:
    """The header of a str/bin/array/map/ext of ``n`` items or bytes."""
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for fmt, code in zip((">B", ">H", ">I"), codes):
        if code is not None and n <= (1 << (8 * struct.calcsize(fmt))) - 1:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} is too long for msgpack")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, None, -1, (0xC4, 0xC5, 0xC6))


def _ext_header(n: int, code: int) -> bytes:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fix[n]]) if n in fix else _sized(n, None, -1, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _as_numpy(x) -> tuple[np.ndarray, str]:
    """A C-contiguous array whose buffer holds ``x``'s bytes, and the dtype
    name flax writes for it."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _TORCH_NAMES:
            raise TypeError(f"no flax dtype name for {t.dtype}")
        name = _TORCH_NAMES[t.dtype]
        return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()), name
    a = np.asarray(x, order="C")  # not ascontiguousarray, which makes a 0-d array 1-d
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no flax encoding")
    return a, a.dtype.name


def _ndarray_pieces(x) -> list:
    a, name = _as_numpy(x)
    head = bytes([0x93]) + _sized(len(a.shape), 0x90, 15, (None, 0xDC, 0xDD))
    head += b"".join(_int(int(d)) for d in a.shape) + _str(name) + _bin_header(a.nbytes)
    return [head, memoryview(a.reshape(-1)).cast("B") if a.size else b""]


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax ``_chunk``: flat pieces of at most MAX_CHUNK_SIZE bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[k : k + size] for i, k in enumerate(range(0, flat.shape[0], size))}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _pieces(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, np.generic):  # before float: np.float64 is a float, and msgpack's strict types pack it as ext 3
        body = _ndarray_pieces(np.asarray(x))
        out += [_ext_header(sum(len(p) for p in body), EXT_NPSCALAR), *body]
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        out.append(_str(x))
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        out += [_bin_header(len(raw)), raw]
    elif isinstance(x, dict):
        out.append(_sized(len(x), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in x.items():
            _pieces(k, out)
            _pieces(_chunk(v) if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE else v, out)
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in x:
            _pieces(v, out)
    elif _is_array(x):
        body = _ndarray_pieces(x)
        out += [_ext_header(sum(len(p) for p in body), EXT_NDARRAY), *body]
    elif isinstance(x, complex):
        body = b"\x92\xcb" + struct.pack(">d", x.real) + b"\xcb" + struct.pack(">d", x.imag)
        out += [_ext_header(len(body), EXT_COMPLEX), body]
    else:
        raise TypeError(f"cannot encode {type(x).__name__} in the flax format")


def write(f, tree) -> None:
    """Encode ``tree`` into the binary file ``f``, each array's buffer
    written as it is (flax ``msgpack_serialize`` of the tree)."""
    out: list = []
    _pieces(_chunk(tree) if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE else tree, out)
    for piece in out:
        f.write(piece)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def msgpack_serialize(tree) -> bytes:
    """``tree`` -> bytes in flax's format, as flax's ``msgpack_serialize``
    writes them: dict keys sorted (its ``tree_map`` sorts them; :func:`write`
    keeps the order it is given, as flax's ``to_bytes`` does)."""
    buf = io.BytesIO()
    write(buf, _sorted(tree))
    return buf.getvalue()


# --------------------------------------------------------------------------
# flax state dicts
# --------------------------------------------------------------------------


def listify(state):
    """A flax state dict with its sequences as lists: a map keyed exactly
    ``"0"`` .. ``"n-1"`` (n > 0) becomes a list (flax writes lists and
    tuples so); ``{}`` stays a dict."""
    if not isinstance(state, dict):
        return state
    out = {k: listify(v) for k, v in state.items()}
    if out and set(out) == {str(i) for i in range(len(out))}:
        return [out[str(i)] for i in range(len(out))]
    return out
