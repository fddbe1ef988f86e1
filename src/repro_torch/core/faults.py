"""Deterministic fault injection for container resilience testing.

The JAX package's ``repro.core.faults``, ported: the same mutations, in the
same order, from the same seed, so a grid entry names the same bytes in
both packages.  Mutations model the faults an ingest path sees — storage
bit rot (bit flips), torn/partial writes (truncation, zeroed pages), buffer
mix-ups (spliced bytes from another blob), and hostile/corrupt metadata
(length-field inflation) — applied to real containers of every generation.
``tests/test_torch_faults.py`` drives :func:`mutation_grid` across v1–v6
blobs and holds the decode contract: correct decode, a typed ``ValueError``
subclass, or a salvage report — never a hang, an unbounded allocation, a
raw ``struct.error``/``KeyError``/``IndexError``, or silently wrong bytes
when checksums are on.

Everything here is seeded and pure: ``mutation_grid(blob, seed=0)`` yields
the same mutations for the same blob forever.  Byte work, on the host.
"""
from __future__ import annotations

import struct
from typing import Iterator, Tuple

import numpy as np

from . import integrity
from . import pipeline as pl_mod

# ---------------------------------------------------------------------------
# primitive mutations (all pure: bytes in, bytes out)
# ---------------------------------------------------------------------------


def bit_flip(blob: bytes, pos: int, bit: int = 0) -> bytes:
    """Flip one bit at byte ``pos``."""
    if not blob:
        return blob
    pos %= len(blob)
    out = bytearray(blob)
    out[pos] ^= 1 << (bit & 7)
    return bytes(out)


def truncate(blob: bytes, keep: int) -> bytes:
    """Keep only the first ``keep`` bytes (a torn write)."""
    return blob[: max(0, min(len(blob), keep))]


def zero_range(blob: bytes, off: int, length: int) -> bytes:
    """Zero ``length`` bytes starting at ``off`` (a lost page)."""
    if not blob:
        return blob
    off %= len(blob)
    out = bytearray(blob)
    out[off : off + length] = b"\x00" * len(out[off : off + length])
    return bytes(out)


def splice(blob: bytes, off: int, src_off: int, length: int) -> bytes:
    """Overwrite ``length`` bytes at ``off`` with bytes copied from
    ``src_off`` of the SAME blob (a buffer mix-up: plausible-looking but
    wrong content, the case raw structure checks cannot catch)."""
    if len(blob) < 2:
        return blob
    off %= len(blob)
    src_off %= len(blob)
    length = min(length, len(blob) - off, len(blob) - src_off)
    out = bytearray(blob)
    out[off : off + length] = blob[src_off : src_off + length]
    return bytes(out)


def inflate_length(blob: bytes, which: str = "body", factor: int = 1 << 20) -> bytes:
    """Multiply a prologue length field (``"header"`` or ``"body"``) — the
    decompression-bomb / overflow shape: structure intact, size claims
    hostile."""
    if len(blob) < 20:
        return blob
    hlen, blen = struct.unpack_from("<qq", blob, 4)
    if which == "header":
        hlen = max(1, hlen) * factor
    else:
        blen = max(1, blen) * factor
    out = bytearray(blob)
    struct.pack_into("<qq", out, 4, hlen, blen)
    return bytes(out)


def corrupt_chunk(blob: bytes, index: int) -> bytes:
    """Flip a byte in the MIDDLE of chunk ``index``'s body slice — damages
    exactly one chunk of a multi-chunk container, leaving every other chunk
    (and the header, and the trailer) untouched.  The salvage-mode fixture
    generator uses this to pin recovered/lost chunk sets."""
    header, body_off = pl_mod.parse_header(blob)
    body_len = len(pl_mod.container_body(blob, body_off))
    bounds = integrity.chunk_bounds_of(header, body_len)
    off, ln = bounds[index]
    if ln == 0:
        return blob
    return bit_flip(blob, body_off + off + ln // 2, 2)


# ---------------------------------------------------------------------------
# the deterministic grid
# ---------------------------------------------------------------------------

def _regions(blob: bytes) -> dict:
    """(start, stop) of each structural region, best effort."""
    n = len(blob)
    try:
        _, body_off = pl_mod.parse_header(blob)
    except ValueError:
        body_off = min(20, n)
    blen = len(pl_mod.container_body(blob, body_off)) if n >= 20 else 0
    core = body_off + blen
    return {
        "prologue": (0, min(20, n)),
        "header": (min(20, n), body_off),
        "body": (body_off, core),
        "trailer": (core, n),
    }


def mutation_grid(
    blob: bytes, seed: int = 0, flips_per_region: int = 3
) -> Iterator[Tuple[str, bytes]]:
    """Yield ``(name, mutated_blob)`` pairs covering every structural region
    with every mutation class.  Deterministic in (blob, seed).  Mutations
    that happen to be identity (e.g. zeroing an already-zero range) are
    skipped, so every yielded blob really differs from the original."""
    rng = np.random.default_rng(seed)
    regions = _regions(blob)
    for rname, (lo, hi) in regions.items():
        if hi <= lo:
            continue
        for i in range(flips_per_region):
            pos = int(rng.integers(lo, hi))
            bit = int(rng.integers(0, 8))
            yield f"bitflip-{rname}-{i}@{pos}.{bit}", bit_flip(blob, pos, bit)
        span = max(1, (hi - lo) // 4)
        off = int(rng.integers(lo, max(lo + 1, hi - span + 1)))
        mut = zero_range(blob, off, span)
        if mut != blob:
            yield f"zero-{rname}@{off}+{span}", mut
    # torn writes at structurally meaningful cut points
    for rname, (lo, hi) in regions.items():
        if 0 < hi < len(blob):
            yield f"truncate-at-{rname}-end", truncate(blob, hi)
    mid = len(blob) // 2
    if 0 < mid < len(blob):
        yield "truncate-mid", truncate(blob, mid)
    # buffer mix-ups: body bytes overwritten with header bytes and vice versa
    hlo, hhi = regions["header"]
    blo, bhi = regions["body"]
    if hhi > hlo and bhi > blo:
        ln = max(1, min(hhi - hlo, bhi - blo) // 2)
        mut = splice(blob, blo + (bhi - blo) // 3, hlo, ln)
        if mut != blob:
            yield "splice-header-into-body", mut
        mut = splice(blob, hlo + (hhi - hlo) // 3, blo, ln)
        if mut != blob:
            yield "splice-body-into-header", mut
    # hostile length fields
    yield "inflate-body-len", inflate_length(blob, "body")
    yield "inflate-header-len", inflate_length(blob, "header")
    yield "negate-body-len", _negate_len(blob)


def _negate_len(blob: bytes) -> bytes:
    if len(blob) < 20:
        return blob
    out = bytearray(blob)
    hlen, blen = struct.unpack_from("<qq", blob, 4)
    struct.pack_into("<qq", out, 4, hlen, -max(1, blen))
    return bytes(out)
