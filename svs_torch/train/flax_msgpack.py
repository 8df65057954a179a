"""msgpack, the subset that svs_tpu's native checkpoints are written in.

svs_tpu writes a ``.ckpt`` with flax's ``serialization.msgpack_serialize``:
a msgpack map of maps, strings, ints, floats, bools, nil and arrays, whose
ndarray leaves are msgpack extension type 1 holding a packed ``(shape,
dtype name, C-order bytes)`` triple (numpy scalars type 3 in the same
form), and whose leaves above
2**30 bytes are split into ``{"__msgpack_chunked_array__": True, "shape":
{...}, "chunks": {...}}`` maps of flat pieces.  Neither flax nor the
``msgpack`` package is needed here: :func:`packb` writes that subset the
way flax and msgpack-python pack it (map keys sorted, the smallest
encoding of each int, float64, bin for bytes: the same bytes) and
:func:`unpackb` reads it back, ndarray leaves as numpy arrays.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

ND_ARRAY, NP_SCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30  # flax's per-leaf limit before it chunks
CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------- write


def _header(out: bytearray, n: int, fix: int, fix_max: int,
            codes: Tuple[int, int, int]) -> None:
    """A length header: fix | n below fix_max, else 8/16/32-bit (code 0
    means no 8-bit form)."""
    if n < fix_max:
        out.append(fix | n)
    elif n < 1 << 8 and codes[0]:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    else:
        out.append(codes[2])
        out += struct.pack(">I", n)


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"{n} does not fit 64 bits")
    else:
        for code, fmt, bot in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if n >= bot:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"{n} does not fit 64 bits")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes((0xc7, n))
    elif n < 1 << 16:
        out.append(0xc8)
        out += struct.pack(">H", n)
    else:
        out.append(0xc9)
        out += struct.pack(">I", n)
    out.append(code)
    out += data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise TypeError(f"cannot pack an array of dtype {a.dtype}")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _chunk(a: np.ndarray) -> dict:
    """flax's chunked form of an array leaf above MAX_CHUNK_SIZE bytes."""
    size = max(1, MAX_CHUNK_SIZE // a.dtype.itemsize)
    flat = a.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): n for i, n in enumerate(a.shape)},
            "chunks": {str(i): flat[lo:lo + size] for i, lo in
                       enumerate(range(0, flat.size, size))}}


def _pack(obj: Any, out: bytearray, sort: bool = True) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), 0, 0, (0xc4, 0xc5, 0xc6))
        out += data
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            # flax chunks after its sorting copy: the chunk maps keep
            # their insertion order
            _pack(_chunk(obj), out, sort=False)
        else:
            _pack_ext(ND_ARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(NP_SCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (0, 0xdc, 0xdd))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        # flax copies the tree with jax.tree_util first, which sorts keys
        _header(out, len(obj), 0x80, 16, (0, 0xde, 0xdf))
        for key in (sorted(obj) if sort else obj):
            _pack(key, out)
            _pack(obj[key], out, sort)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` (maps, lists, str, bytes, int, float, bool, None, numpy
    arrays and scalars) as msgpack bytes, in flax's layout."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------- read


def _ndarray_from(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"unsupported array dtype {name!r}") from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _ext(code: int, data: bytes) -> Any:
    if code == ND_ARRAY:
        return _ndarray_from(data)
    if code == NP_SCALAR:
        return _ndarray_from(data)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    code = buf[pos]
    pos += 1

    def take(fmt):
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[pos:pos + n])[0], pos + n

    def items(n, at, pairs):
        out = {} if pairs else []
        for _ in range(n):
            key, at = _unpack(buf, at)
            if pairs:
                value, at = _unpack(buf, at)
                out[key] = value
            else:
                out.append(key)
        return out, at

    if code <= 0x7f:
        return code, pos
    if code >= 0xe0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8f:
        return items(code & 0x0f, pos, True)
    if 0x90 <= code <= 0x9f:
        return items(code & 0x0f, pos, False)
    if 0xa0 <= code <= 0xbf:
        n = code & 0x1f
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if code in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[code], pos
    if code in _FIXED:
        return take(_FIXED[code])
    if code in (0xc4, 0xc5, 0xc6, 0xd9, 0xda, 0xdb):
        n, pos = take({0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B",
                       0xda: ">H", 0xdb: ">I"}[code])
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if code >= 0xd9 else raw), pos + n
    if code in (0xdc, 0xdd, 0xde, 0xdf):
        n, pos = take(">H" if code in (0xdc, 0xde) else ">I")
        return items(n, pos, code >= 0xde)
    if 0xd4 <= code <= 0xd8 or code in (0xc7, 0xc8, 0xc9):
        if code >= 0xd4:
            n = 1 << (code - 0xd4)
        else:
            n, pos = take({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[code])
        kind = struct.unpack(">b", buf[pos:pos + 1])[0]
        return _ext(kind, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """msgpack bytes -> Python values; ndarray leaves (flax's chunked ones
    joined) as read-only numpy arrays over ``data``."""
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes after the msgpack object")
    return _unchunk(obj)
