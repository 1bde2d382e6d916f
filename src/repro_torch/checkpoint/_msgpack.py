"""A minimal msgpack codec for the checkpoint payload.

Only the types a checkpoint holds: maps, strings, byte strings, integers
and arrays (of integers: the shapes).  :func:`packb` writes what
``msgpack.packb(obj, use_bin_type=True)`` writes for such an object (the
smallest encoding of each value, str8 allowed, byte strings as bin), so a
file is the same whichever package wrote it; :func:`unpackb` also reads
nil, booleans and floats, and returns byte strings as memoryviews of the
input (no copy).
"""
from __future__ import annotations

import struct


def _head(out: list, n: int, fix: int, fix_max: int, codes) -> None:
    """The header of a sized value: ``fix | n`` below ``fix_max``, else the
    first of ``codes`` ((code, limit, struct format)) whose limit n is
    under."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for code, limit, fmt in codes:
        if n < limit:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xD9, 1 << 8, ">B"), (0xDA, 1 << 16, ">H"), (0xDB, 1 << 32, ">I"))
_BIN = ((0xC4, 1 << 8, ">B"), (0xC5, 1 << 16, ">H"), (0xC6, 1 << 32, ">I"))
_ARR = ((0xDC, 1 << 16, ">H"), (0xDD, 1 << 32, ">I"))
_MAP = ((0xDE, 1 << 16, ">H"), (0xDF, 1 << 32, ">I"))


def _int(out: list, n: int) -> None:
    if 0 <= n < 128 or -32 <= n < 0:
        out.append(struct.pack(">b" if n < 0 else ">B", n))
    elif n >= 0:
        for code, limit, fmt in ((0xCC, 1 << 8, ">B"), (0xCD, 1 << 16, ">H"),
                                 (0xCE, 1 << 32, ">I"),
                                 (0xCF, 1 << 64, ">Q")):
            if n < limit:
                out.append(bytes((code,)) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: int {n} too large")
    else:
        for code, limit, fmt in ((0xD0, 1 << 7, ">b"), (0xD1, 1 << 15, ">h"),
                                 (0xD2, 1 << 31, ">i"),
                                 (0xD3, 1 << 63, ">q")):
            if n >= -limit:
                out.append(bytes((code,)) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: int {n} too small")


def _pack(obj, out: list) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"msgpack: {type(obj).__name__} is not a "
                        f"checkpoint type")
    if isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xA0, 32, _STR)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = memoryview(obj).cast("B")
        _head(out, b.nbytes, None, 0, _BIN)
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, _ARR)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, _MAP)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: {type(obj).__name__} is not a "
                        f"checkpoint type")


def packb(obj) -> bytes:
    """The msgpack bytes of ``obj`` (maps, str, bytes, int, lists)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in sized:
            return self.take(self.num(sized[c]))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in strs:
            return str(self.take(self.num(strs[c])), "utf-8")
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in nums:
            return self.num(nums[c])
        if c in (0xDC, 0xDD):
            return [self.obj()
                    for _ in range(self.num(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self.map(self.num(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(buf):
    """The object encoded in ``buf`` (which must hold exactly one)."""
    r = _Reader(buf)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: extra data after the object")
    return obj
