"""The subset of MessagePack a checkpoint manifest uses, with no `msgpack`.

`pack` writes the bytes `msgpack.packb` writes for the same object (its
defaults: the smallest integer and length forms, floats as float64);
`unpack` reads them back as `msgpack.unpackb` does (arrays as lists,
strings decoded as UTF-8).  Types: dict, list, tuple, str, int from
-2**63 to 2**64 - 1, float, bool and None; numpy integer and floating
scalars pack as the Python numbers they hold.
"""
from __future__ import annotations

import struct

import numpy as np


def pack(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _length(out: bytearray, n: int, fix: int | None, fix_max: int,
            codes: tuple[int, int, int], widths=(">B", ">H", ">I")) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, widths, (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit MessagePack")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v > 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit MessagePack")
    else:
        for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000),
                                 (0xD3, ">q", -0x8000000000000000)):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit MessagePack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False or isinstance(obj, np.bool_):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)):
        _pack_int(int(obj), out)
    elif isinstance(obj, (float, np.floating)):
        out.append(0xCB)
        out += struct.pack(">d", float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _length(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _length(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _length(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} "
                        "to MessagePack")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.num(numbers[b])
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
                   0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if b not in lengths:
            raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")
        n = self.num(lengths[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self.take(n).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self.array(n)
        return self.map(n)

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpack(data: bytes):
    """Decode one object; trailing bytes are an error, as in msgpack."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra data after the MessagePack object")
    return obj
