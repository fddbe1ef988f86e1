"""The msgpack subset that container headers and trailers use.

Container headers and integrity trailers are msgpack maps.  This module
writes and reads them without the ``msgpack`` package, so the port has one
code path wherever it runs.  It covers nil, bool, int, float, str, bin, array
and map.  :func:`packb` gives the same bytes as
``msgpack.packb(obj, use_bin_type=True)``: the smallest encoding of each
value, Python floats as float64, str as UTF-8 str, and bytes-like values as
bin.  :func:`unpackb` reads what ``msgpack.unpackb(raw=False)`` reads for
these types, with str as ``str``, bin as ``bytes`` and arrays as lists.

Every malformed input raises a ``ValueError`` subclass: :class:`UnpackError`
for bad framing, ``UnicodeDecodeError`` for a str that is not UTF-8.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

#: nesting deeper than this is refused (headers nest two levels)
MAX_DEPTH = 256


class UnpackError(ValueError):
    """The bytes are not a well-formed msgpack value of a supported type."""


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------

def _pack_int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(struct.pack("B", v))
        elif v <= 0xFF:
            out.append(b"\xcc" + struct.pack("B", v))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + struct.pack(">H", v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + struct.pack(">I", v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + struct.pack(">Q", v))
        else:
            raise OverflowError(f"integer {v} does not fit msgpack uint64")
    elif v >= -32:
        out.append(struct.pack("b", v))
    elif v >= -0x80:
        out.append(b"\xd0" + struct.pack("b", v))
    elif v >= -0x8000:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise OverflowError(f"integer {v} does not fit msgpack int64")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[bytes, ...], out) -> None:
    """Length prefix: a fix form below ``fix_max``, else 8/16/32-bit forms
    (``codes`` lists the markers from narrowest; None where absent)."""
    if n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for marker, fmt, limit in zip(codes, ("B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if marker is not None and n <= limit:
            out.append(marker + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack(obj: Any, out: List[bytes], depth: int) -> None:
    if depth > MAX_DEPTH:
        raise ValueError("object nests too deeply to pack")
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), 0, 0, (b"\xc4", b"\xc5", b"\xc6"), out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, b"\xdc", b"\xdd"), out)
        for item in obj:
            _pack(item, out, depth + 1)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, b"\xde", b"\xdf"), out)
        for k, v in obj.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """Serialize ``obj``; equals ``msgpack.packb(obj, use_bin_type=True)``."""
    out: List[bytes] = []
    _pack(obj, out, 0)
    return b"".join(out)


# ---------------------------------------------------------------------------
# unpack
# ---------------------------------------------------------------------------

class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise UnpackError("incomplete input")
        out = self.buf[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {
    0xC4: ("bin", "B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", "B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


def _read(r: _Reader, depth: int) -> Any:
    if depth > MAX_DEPTH:
        raise UnpackError("msgpack value nests too deeply")
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b == 0xC0:
        return None
    elif b == 0xC2:
        return False
    elif b == 0xC3:
        return True
    elif b in _FIXED:
        return r.unpack(_FIXED[b])
    elif b in _LEN:
        kind, fmt = _LEN[b]
        n = r.unpack(fmt)
    else:
        raise UnpackError(f"unsupported msgpack type byte 0x{b:02x}")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "array":
        return [_read(r, depth + 1) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _read(r, depth + 1)
        if not isinstance(k, (str, bytes)):
            raise UnpackError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _read(r, depth + 1)
    return out


def unpackb(buf) -> Any:
    """Deserialize one value that spans all of ``buf`` (extra bytes after it
    are an error, as in ``msgpack.unpackb``)."""
    r = _Reader(bytes(buf))
    obj = _read(r, 0)
    if r.pos != len(r.buf):
        raise UnpackError("unpack(b) received extra data")
    return obj
