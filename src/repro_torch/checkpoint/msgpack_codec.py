"""The subset of MessagePack the checkpoint manifests and the cost
model's records use, without the `msgpack` package.

`packb` encodes as `msgpack.packb` does with its defaults (the smallest
integer and length encodings, float64 for every float, str as UTF-8
and bytes as bin), so `plan.costmodel.model_bytes` is byte-identical to
the reference's.  `unpackb` decodes maps, arrays, str, bin, integers,
float32 / float64, bool and nil -- everything `packb` writes; extension
types raise.  Maps keep their encoded key order.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _len_header(n: int, fix: int, fix_max: int, codes: Tuple[int, int, int]
                ) -> bytes:
    """The length header of a str / bin / array / map of `n` items:
    the fix form (when `fix` is given and n fits), else 8-, 16- or
    32-bit lengths (`codes`; a None code skips that width)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    c8, c16, c32 = codes
    if c8 is not None and n < 1 << 8:
        return bytes([c8, n])
    if n < 1 << 16:
        return struct.pack(">BH", c16, n)
    if n < 1 << 32:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"object of length {n} is too large to pack")


def _pack_int(v: int, out: List[bytes]) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError(f"{v} is too small to pack")
                out.append(struct.pack(">Bq", 0xD3, v))
            else:
                out.append(struct.pack(">Bi", 0xD2, v))
        elif v < -(1 << 7):
            out.append(struct.pack(">Bh", 0xD1, v))
        else:
            out.append(struct.pack(">Bb", 0xD0, v))
    elif v < 1 << 7:
        out.append(struct.pack(">b", v) if v < 0 else bytes([v]))
    elif v < 1 << 16:
        out.append(struct.pack(">BB", 0xCC, v) if v < 1 << 8
                   else struct.pack(">BH", 0xCD, v))
    elif v < 1 << 32:
        out.append(struct.pack(">BI", 0xCE, v))
    elif v < 1 << 64:
        out.append(struct.pack(">BQ", 0xCF, v))
    else:
        raise OverflowError(f"{v} is too large to pack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_len_header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_len_header(len(raw), None, 0, (0xC4, 0xC5, 0xC6)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_len_header(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_len_header(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """MessagePack bytes of `obj` (None, bool, int, float, str, bytes,
    list / tuple, dict)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MessagePack data")
        b = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in fixed:
            return fixed[c]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if c in scalars:
            return self.unpack(scalars[c])
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
                 0xC6: (">I", "bin"), 0xD9: (">B", "str"),
                 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if c not in sized:
            raise ValueError(f"unsupported MessagePack type byte 0x{c:02x}")
        fmt, kind = sized[c]
        n = self.unpack(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "array":
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes) -> Any:
    """The object `data` encodes (arrays as lists, maps as dicts in
    encoded order); trailing bytes raise."""
    r = _Reader(bytes(data))
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("extra bytes after the MessagePack object")
    return obj


__all__ = ["packb", "unpackb"]
