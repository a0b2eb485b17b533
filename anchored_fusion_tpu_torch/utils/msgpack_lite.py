"""A small msgpack reader and writer for Flax's checkpoint layout.

Flax's ``serialization.to_bytes`` writes nested maps of str keys whose
leaves are numpy arrays, each as msgpack ext type 1 whose payload is itself
msgpack: ``(shape, dtype name, C-order bytes)``.  This module reads and
writes exactly that subset — maps, arrays, str, bin, ints and ext type 1 —
so the port needs no ``msgpack`` package.  Ints and lengths take the
smallest encoding, as the ``msgpack`` package packs them, and map keys are
written sorted, as Flax writes them: a tree packs to Flax's bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"int out of msgpack range: {n}")


def _sized(n: int, fix: Tuple[int, int], codes) -> bytes:
    """Header of a str/bin/array/map of length ``n``: ``fix`` = (first code,
    fix-range size) or None; ``codes`` = codes for 8-, 16-, 32-bit lengths
    (None where the type has no such form)."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length out of msgpack range: {n}")


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        head = bytes([fixed[len(data)]])
    else:
        head = _sized(len(data), None, (0xc7, 0xc8, 0xc9))
    return head + struct.pack(">b", code) + data


def _pack(obj, out: list):
    if isinstance(obj, np.ndarray):
        payload = packb((list(obj.shape), obj.dtype.name, obj.tobytes("C")))
        out.append(_ext(EXT_NDARRAY, payload))
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), (0x80, 16), (None, 0xde, 0xdf)))
        for k, v in sorted(obj.items()):
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), (0x90, 16), (None, 0xdc, 0xdd)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(_sized(len(b), (0xa0, 32), (0xd9, 0xda, 0xdb)) + b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_sized(len(obj), None, (0xc4, 0xc5, 0xc6)) + bytes(obj))
    elif isinstance(obj, bool):
        raise TypeError("bool is outside the supported msgpack subset")
    elif isinstance(obj, int):
        out.append(_int(obj))
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of nested dicts/lists of str, bytes, int and numpy
    arrays (arrays as ext type 1)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.obj() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.take(c & 0x1f).decode()
        sized = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
                 0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
                 0xdc: (">H", "array"), 0xdd: (">I", "array"),
                 0xde: (">H", "map"), 0xdf: (">I", "map"),
                 0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in ints:
            return self.num(ints[c])
        if 0xd4 <= c <= 0xd8:
            return self.ext(1 << (c - 0xd4))
        if c not in sized:
            raise ValueError(f"msgpack code 0x{c:02x} is outside the "
                             "supported subset")
        fmt, kind = sized[c]
        n = self.num(fmt)
        if kind == "str":
            return self.take(n).decode()
        if kind == "bin":
            return self.take(n)
        if kind == "array":
            return [self.obj() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.num(">b")
        payload = self.take(n)
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is outside the "
                             "supported subset")
        shape, dtype, buf = unpackb(payload)
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """The object of one msgpack document; ext type 1 becomes a numpy
    array."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack document")
    return obj
