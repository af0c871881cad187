"""The port's own codec of flax's checkpoint wire format
(``mft_tpu_torch/utils/flax_msgpack.py``) against flax itself.

* bytes that ``flax.serialization.msgpack_serialize`` writes decode to
  equal trees, exactly (every leaf's dtype, shape and bytes);
* the port's encoder writes the very bytes flax writes for the same tree,
  and ``flax.serialization.msgpack_restore`` restores them to equal trees;
* hypothesis draws nested trees of every dtype (``bfloat16`` included, a
  ``torch.bfloat16`` tensor on the port's side), ints, strings, bins, maps
  and arrays at each length-prefix boundary;
* leaves above ``MAX_CHUNK_SIZE`` are chunked as flax chunks them (the
  limit lowered with ``monkeypatch`` on both sides);
* the reader runs in a process where ``flax``, ``msgpack`` and ``jax``
  cannot be imported, and no module of the port imports them.

Tolerance: none; every comparison is exact.
"""

import os
import re
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as ser
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from mft_tpu_torch.utils import flax_msgpack as fm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NUMPY_DTYPES = ("float16", "float32", "float64", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
                "uint64", "bool", "complex64", "complex128")
INT_EDGES = (0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**64 - 1, -1, -32, -33, -128,
             -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63))
LEN_EDGES = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)


def _bf16(bits: np.ndarray):
    """The same bf16 values as flax's leaf (ml_dtypes) and the port's (torch)."""
    bits = np.ascontiguousarray(bits, np.uint16)
    return bits.view(jnp.bfloat16), torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _split(tree):
    """A tree with ``("bf16", bits)`` markers -> (flax's tree, the port's tree)."""
    if isinstance(tree, tuple) and tree and tree[0] == "bf16":
        return _bf16(tree[1])
    if isinstance(tree, dict):  # keys sorted, as flax's msgpack_serialize writes them
        pairs = {k: _split(tree[k]) for k in sorted(tree)}
        return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
    if isinstance(tree, list):
        pairs = [_split(v) for v in tree]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return tree, tree


def _leaf_bytes(x):
    if isinstance(x, torch.Tensor):
        return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        return a.dtype.name, a.shape, a.tobytes(), type(x).__name__
    if isinstance(x, float):
        return "float", struct.pack(">d", x)
    return type(x).__name__, x


def assert_same(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}/{i}")
    else:
        assert _leaf_bytes(a) == _leaf_bytes(b), f"{path}: {a!r} != {b!r}"


def _fixed_tree():
    rs = np.random.RandomState(0)
    tree = {
        "arrays": {name: (rs.standard_normal((2, 3)) * 50).astype(name) for name in NUMPY_DTYPES},
        "bf16": ("bf16", rs.randint(0, 2**16, (4, 5))),
        "scalar_arrays": {"epoch": np.asarray(600), "count": np.asarray(7, np.int32), "flag": np.asarray(True)},
        "np_scalars": [np.float32(1.5), np.int64(-3), np.bool_(False), np.float64(2.0)],
        "empty": {}, "empty_array": np.zeros((0, 4), np.float32), "zero_d": np.float32(0.25),
        "python": [None, True, False, 1.5, -0.0, "text", b"\x00\x01", 3 + 4j],
        "ints": list(INT_EDGES),
    }
    return _split(tree)


def test_flax_bytes_decode_exactly():
    flax_tree, port_tree = _fixed_tree()
    back = fm.msgpack_restore(ser.msgpack_serialize(flax_tree))
    assert_same(back, port_tree)
    assert isinstance(back["bf16"], torch.Tensor) and back["bf16"].dtype == torch.bfloat16


def test_port_bytes_equal_flax_bytes_and_restore_in_flax():
    flax_tree, port_tree = _fixed_tree()
    raw = fm.msgpack_serialize(port_tree)
    assert raw == ser.msgpack_serialize(flax_tree)
    back = ser.msgpack_restore(raw)
    assert_same(fm.msgpack_restore(ser.msgpack_serialize(back)), port_tree)


@pytest.mark.parametrize("n", LEN_EDGES)
def test_length_prefix_boundaries(n):
    """str, bin, map (flax's lists) and arrays at each prefix width."""
    tree = {"a": list(range(n)), "b": b"\x07" * n, "m": {f"{i:05d}": i for i in range(n)} if n <= 256 else {},
            "s": "x" * n, "u8": np.arange(n, dtype=np.uint8)}
    raw = ser.msgpack_serialize(tree)
    assert fm.msgpack_serialize(tree) == raw
    assert_same(fm.msgpack_restore(raw), tree)


def test_ints_past_64_bits_are_refused():
    with pytest.raises(OverflowError):
        fm.msgpack_serialize({"big": 2**64})
    with pytest.raises(OverflowError):
        fm.msgpack_serialize({"small": -(2**63) - 1})


def _array(dtype):
    if dtype == "bfloat16":
        return hnp.arrays(np.uint16, hnp.array_shapes(min_dims=0, max_dims=3, max_side=4)).map(lambda a: ("bf16", a))
    return hnp.arrays(np.dtype(dtype), hnp.array_shapes(min_dims=0, max_dims=3, max_side=4))


LEAVES = st.one_of(
    st.none(), st.booleans(), st.integers(-(2**63), 2**64 - 1), st.sampled_from(INT_EDGES), st.floats(width=64),
    st.text(max_size=40), st.binary(max_size=300), st.complex_numbers(allow_nan=False),
    st.sampled_from(NUMPY_DTYPES + ("bfloat16",)).flatmap(_array),
)
TREES = st.recursive(LEAVES, lambda kids: st.one_of(st.dictionaries(st.text(max_size=6), kids, max_size=17),
                                                    st.lists(kids, max_size=17)), max_leaves=24)


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(TREES)
def test_random_trees_both_ways(tree):
    flax_tree, port_tree = _split({"t": tree})
    raw = ser.msgpack_serialize(flax_tree)
    assert_same(fm.msgpack_restore(raw), port_tree)
    assert fm.msgpack_serialize(port_tree) == raw


def test_chunked_leaves(monkeypatch):
    """Leaves above MAX_CHUNK_SIZE bytes go as flax's chunked maps: the
    limit lowered to 64 bytes on both sides."""
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(1)
    bits = rs.randint(0, 2**16, (7, 11))
    flax_tree, port_tree = _split({"big": rs.standard_normal((9, 10)).astype(np.float32), "small": np.ones(3),
                                   "nested": {"bf": ("bf16", bits), "i64": np.arange(17, dtype=np.int64)}})
    raw = ser.msgpack_serialize(flax_tree)
    assert fm.msgpack_serialize(port_tree) == raw
    assert b"__msgpack_chunked_array__" in raw
    assert_same(fm.msgpack_restore(raw), port_tree)
    assert_same(fm.msgpack_restore(ser.msgpack_serialize(ser.msgpack_restore(raw))), port_tree)


def test_truncated_and_trailing_bytes_are_refused():
    raw = fm.msgpack_serialize({"a": np.arange(10, dtype=np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        fm.msgpack_restore(raw[:-3])
    with pytest.raises(ValueError, match="after the end"):
        fm.msgpack_restore(raw + b"\xc0")


def test_listify_inverts_flax_state_dicts():
    tree = {"stages": [[{"w": 1}, {"w": 2}]], "empty": {}, "t": (3, 4)}
    assert fm.listify(ser.to_state_dict(tree)) == {"stages": [[{"w": 1}, {"w": 2}]], "empty": {}, "t": [3, 4]}


def test_reader_runs_without_flax_msgpack_or_jax(tmp_path):
    """A ``.ckpt`` written by flax reads in a process that cannot import
    flax, msgpack or jax (each blocked in ``sys.modules``)."""
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, "epoch": np.asarray(3)}
    path = tmp_path / "3.ckpt"
    path.write_bytes(ser.to_bytes(tree))
    code = (
        "import sys\n"
        "for m in ('flax', 'msgpack', 'jax', 'mft_tpu'): sys.modules[m] = None\n"
        "from mft_tpu_torch.utils import flax_msgpack\n"
        f"t = flax_msgpack.read({str(path)!r})\n"
        "assert t['params']['w'].tolist() == [[0, 1, 2], [3, 4, 5]] and int(t['epoch']) == 3\n"
        "import mft_tpu_torch.utils.checkpoint, mft_tpu_torch.cli.import_ckpt, mft_tpu_torch.cli.export_ckpt\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_module_of_the_port_imports_jax_flax_or_msgpack():
    pattern = re.compile(r"^\s*(import|from) (jax|flax|msgpack|mft_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mft_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [f"{f}:{i}" for f in files for i, line in enumerate(open(f), 1) if pattern.match(line)]
    assert not bad
