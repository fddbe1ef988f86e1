"""Read an SZ3J container from its bytes: prologue, msgpack header, body.

Layout: ``b"SZ3J"``, two little-endian int64 lengths (header, body), the
msgpack header, the body, then an optional integrity trailer that the
declared lengths skip.  A v2 ("chunked") or v4 ("pwr") container's body is a
concatenation of whole containers, one per chunk, listed in the header's
``chunks`` table as ``{"off", "len", "n0", ...}``.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

MAGIC = b"SZ3J"
PROLOGUE = 20
MULTICHUNK_KINDS = ("chunked", "pwr")


class FormatError(ValueError):
    """The bytes are not a well-formed container."""


def _unpack(buf: bytes, i: int) -> Tuple[Any, int]:
    """One msgpack value of the subset headers use, from ``buf[i:]``."""
    if i >= len(buf):
        raise FormatError("msgpack value runs past the header")
    b = buf[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0xA0 <= b <= 0xBF:
        return _str(buf, i, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, i, b & 0x0F)
    if 0x80 <= b <= 0x8F:
        return _map(buf, i, b & 0x0F)
    fixed = {
        0xC0: (0, None), 0xC2: (0, False), 0xC3: (0, True),
        0xCA: (4, ">f"), 0xCB: (8, ">d"),
        0xCC: (1, ">B"), 0xCD: (2, ">H"), 0xCE: (4, ">I"), 0xCF: (8, ">Q"),
        0xD0: (1, ">b"), 0xD1: (2, ">h"), 0xD2: (4, ">i"), 0xD3: (8, ">q"),
    }
    if b in fixed:
        size, fmt = fixed[b]
        if size == 0:
            return fmt, i
        _need(buf, i, size)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    lengths = {
        0xD9: (1, _str), 0xDA: (2, _str), 0xDB: (4, _str),
        0xC4: (1, _bin), 0xC5: (2, _bin), 0xC6: (4, _bin),
        0xDC: (2, _array), 0xDD: (4, _array),
        0xDE: (2, _map), 0xDF: (4, _map),
    }
    if b not in lengths:
        raise FormatError(f"msgpack type byte 0x{b:02x} is not used by container headers")
    size, read = lengths[b]
    _need(buf, i, size)
    n = int.from_bytes(buf[i : i + size], "big")
    return read(buf, i + size, n)


def _need(buf: bytes, i: int, n: int) -> None:
    if i + n > len(buf):
        raise FormatError("msgpack value runs past the header")


def _str(buf: bytes, i: int, n: int) -> Tuple[str, int]:
    _need(buf, i, n)
    return buf[i : i + n].decode("utf-8"), i + n


def _bin(buf: bytes, i: int, n: int) -> Tuple[bytes, int]:
    _need(buf, i, n)
    return bytes(buf[i : i + n]), i + n


def _array(buf: bytes, i: int, n: int) -> Tuple[List[Any], int]:
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _map(buf: bytes, i: int, n: int) -> Tuple[Dict[Any, Any], int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i


def unpackb(raw: bytes) -> Any:
    value, end = _unpack(raw, 0)
    if end != len(raw):
        raise FormatError(f"{len(raw) - end} bytes follow the msgpack header")
    return value


def parse(blob: bytes) -> Tuple[Dict[str, Any], bytes]:
    """(header, declared body) of one container."""
    if len(blob) < PROLOGUE or blob[:4] != MAGIC:
        raise FormatError("not an SZ3J container")
    hlen, blen = struct.unpack_from("<qq", blob, 4)
    if hlen < 0 or blen < 0 or PROLOGUE + hlen + blen > len(blob):
        raise FormatError(f"declared lengths {hlen} + {blen} do not fit {len(blob)} bytes")
    header = unpackb(blob[PROLOGUE : PROLOGUE + hlen])
    if not isinstance(header, dict):
        raise FormatError("the header is not a map")
    body = blob[PROLOGUE + hlen : PROLOGUE + hlen + blen]
    return header, body


def leaves(blob: bytes) -> List[Dict[str, Any]]:
    """The single-body containers of ``blob`` in order, each as
    ``{"header", "body", "n0"}``: the blob itself, or each chunk of a
    multi-chunk container (checked to tile its body in order)."""
    header, body = parse(blob)
    if header.get("kind") not in MULTICHUNK_KINDS:
        shape = header.get("shape") or [0]
        return [{"header": header, "body": body, "n0": int(shape[0]) if shape else 1}]
    out = []
    pos = 0
    for rec in header.get("chunks", []):
        off, ln = int(rec["off"]), int(rec["len"])
        if off != pos or off + ln > len(body):
            raise FormatError(f"chunk at {off}+{ln} does not follow the previous one at {pos}")
        sub_header, sub_body = parse(body[off : off + ln])
        if sub_header.get("kind") in MULTICHUNK_KINDS:
            raise FormatError("a chunk is itself multi-chunk")
        out.append({"header": sub_header, "body": sub_body, "n0": int(rec["n0"])})
        pos = off + ln
    if pos != len(body):
        raise FormatError(f"chunks cover {pos} of the {len(body)} body bytes")
    return out
