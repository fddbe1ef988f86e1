"""Container integrity: checksummed trailers, typed errors, and salvage decode.

The same trailer format as the JAX package's ``repro.core.integrity``, so
blobs verify in either package.  Error-bounded compression only earns its
bound on data that survives the round trip, so every writer appends an
integrity TRAILER and every reader can verify it:

  ``... prologue | header | body | [payload | len u32 | ver u8 | b"SZ3T"]``

The trailer sits BEYOND the body length declared in the prologue, so any
reader that honours the declared lengths (all in-repo readers slice the body
by its declared length) skips it: pre-trailer blobs keep decoding unchanged,
and trailer-carrying blobs decode under pre-trailer readers.  The msgpack
payload carries fixed-width fields only — ``a`` (checksum algorithm), ``h``
(checksum of prologue+header), ``w`` (whole-container digest over everything
before the trailer) and ``c`` (one 4-byte checksum per chunk of the body) —
so trailer length is a pure function of the chunk count and containers stay
byte-deterministic.

Checksum algorithm: CRC32C (Castagnoli) via ``google_crc32c`` when the C
extension is importable, else ``zlib.crc32``; the trailer records which
(``a``), so blobs verify wherever they land.  This is a format rule shared
with the JAX package, not a device fallback.

Threat model — what the checksums DO defend: accidental corruption (storage
bit rot, truncated writes, torn reads, bad NICs) is detected before decode
can propagate it, and damage is localized to the chunk level so salvage
decode recovers everything else.  What they DON'T defend: a deliberate
attacker can recompute CRCs after tampering (they are not MACs), and
stripping the whole trailer from a container downgrades it to unverified
legacy framing — readers that must reject that case check the header's
``itg`` flag, which travels under the header checksum.  Hostile length
fields are handled separately: every header-declared size/count/offset is
bounded against the actual blob before any allocation (see ``guard_*`` and
``LosslessBackend.decompress_bounded``).

Error contract: every malformed-input failure raises :class:`ContainerError`
(a ``ValueError``) or its checksum-specific subclass :class:`IntegrityError`
— never a raw ``struct.error`` / ``KeyError`` / ``IndexError`` from the
decode internals (``decode_errors`` converts them at the dispatch boundary).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from . import _msgpack

try:  # CRC32C (Castagnoli): hardware-accelerated C extension when present
    import google_crc32c as _crc32c_mod

    _HAVE_CRC32C = True
except Exception:  # pragma: no cover - exercised where the wheel is absent
    _crc32c_mod = None
    _HAVE_CRC32C = False


# ---------------------------------------------------------------------------
# typed error contract
# ---------------------------------------------------------------------------

class ContainerError(ValueError):
    """A malformed or hostile container: bad framing, inconsistent lengths,
    unparseable headers, or decode state that cannot be reconciled with the
    header's claims.  Subclasses ``ValueError`` so pre-existing callers that
    catch ``ValueError`` keep working."""


class IntegrityError(ContainerError):
    """A checksum mismatch: the container parsed, but its bytes are not the
    bytes that were written.  ``chunk_index`` names the first damaged chunk
    when the per-chunk checksums localize it; ``region`` names the damaged
    area otherwise ("header", "container", "trailer")."""

    def __init__(
        self,
        message: str,
        *,
        chunk_index: Optional[int] = None,
        region: str = "container",
    ):
        super().__init__(message)
        self.chunk_index = chunk_index
        self.region = region


#: exception types the decode internals may leak on hostile input; converted
#: to ContainerError at the dispatch boundary.  MemoryError is deliberately
#: NOT here — the allocation guards exist to prevent it, and masking one
#: would hide a guard gap.
_LEAKY_ERRORS = (
    KeyError,
    IndexError,
    TypeError,
    AttributeError,
    struct.error,
    zlib.error,
    OverflowError,
)


@contextlib.contextmanager
def decode_errors(what: str = "container") -> Iterator[None]:
    """Normalize the error contract at a decode boundary: ``ValueError``
    (including our typed subclasses) passes through; the leaky exception
    types malformed input can trigger inside numpy/struct/zlib are
    re-raised as :class:`ContainerError`."""
    try:
        yield
    except ValueError:
        raise
    except _LEAKY_ERRORS as e:
        raise ContainerError(
            f"malformed {what}: {type(e).__name__}: {e}"
        ) from e
    except lzma_error() as e:  # lzma.LZMAError lazily resolved
        raise ContainerError(f"malformed {what}: {e}") from e


def lzma_error():
    import lzma

    return lzma.LZMAError


# ---------------------------------------------------------------------------
# allocation guards (decompression-bomb / overflow defense)
# ---------------------------------------------------------------------------

#: hard ceiling on any single header-driven allocation during decode; a
#: container legitimately bigger than this is outside the supported envelope
#: (override via the environment for archival restores of huge arrays)
MAX_OUTPUT_BYTES = int(os.environ.get("SZ3J_MAX_OUTPUT_BYTES", str(1 << 34)))


def guard_alloc(nbytes: int, what: str) -> int:
    """Bound a header-declared allocation BEFORE making it."""
    nbytes = int(nbytes)
    if nbytes < 0 or nbytes > MAX_OUTPUT_BYTES:
        raise ContainerError(
            f"hostile or corrupt container: {what} declares {nbytes} bytes "
            f"(allowed 0..{MAX_OUTPUT_BYTES}; raise SZ3J_MAX_OUTPUT_BYTES "
            "for legitimately larger arrays)"
        )
    return nbytes


def guard_count(n: Any, limit: int, what: str) -> int:
    """Bound a header-declared count by a limit derived from real bytes."""
    try:
        n = int(n)
    except (TypeError, ValueError) as e:
        raise ContainerError(f"corrupt container: {what} is not an integer") from e
    if n < 0 or n > limit:
        raise ContainerError(
            f"hostile or corrupt container: {what}={n} outside 0..{limit}"
        )
    return n


def guard_shape(shape: Any, itemsize: int, what: str = "shape") -> Tuple[int, ...]:
    """Validate a header-declared shape and bound its total allocation."""
    if not isinstance(shape, (list, tuple)):
        raise ContainerError(f"corrupt container: {what} is not a sequence")
    dims: List[int] = []
    total = 1
    for d in shape:
        d = guard_count(d, MAX_OUTPUT_BYTES, f"{what} dim")
        dims.append(d)
        total *= d
        if total * itemsize > MAX_OUTPUT_BYTES:
            raise ContainerError(
                f"hostile or corrupt container: {what} {dims}... declares more "
                f"than {MAX_OUTPUT_BYTES} bytes"
            )
    return tuple(dims)


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------

def _crc32c(data, value: int = 0) -> int:
    return int(_crc32c_mod.extend(value, bytes(data)))


def _crc32(data, value: int = 0) -> int:
    return zlib.crc32(data, value) & 0xFFFFFFFF


_ALGOS = {"crc32c": _crc32c, "crc32": _crc32}

#: the algorithm new trailers are written with in THIS process
CHECKSUM_ALGO = "crc32c" if _HAVE_CRC32C else "crc32"


def checksum(data, value: int = 0, algo: Optional[str] = None) -> int:
    """Running 32-bit checksum of ``data`` (CRC32C when available)."""
    fn = _ALGOS.get(algo or CHECKSUM_ALGO)
    if fn is None:
        raise ContainerError(f"unknown checksum algorithm {algo!r} in trailer")
    return fn(data, value)


# ---------------------------------------------------------------------------
# the trailer
# ---------------------------------------------------------------------------

TRAILER_MAGIC = b"SZ3T"
TRAILER_VERSION = 1
_FOOTER = struct.Struct("<IB4s")  # payload length, version, magic — 9 bytes


@dataclasses.dataclass(frozen=True)
class Trailer:
    """Parsed integrity trailer."""

    algo: str
    header_crc: int
    whole_crc: int
    chunk_crcs: Tuple[int, ...]
    start: int  # byte offset where the trailer begins (== verified length)


def build_trailer(
    head: bytes, body: bytes, chunk_bounds: Optional[Sequence[Tuple[int, int]]]
) -> bytes:
    """Integrity trailer for a container whose pre-trailer bytes are
    ``head + body``.  ``chunk_bounds`` lists body-relative ``(off, len)`` of
    each independently decodable chunk (multi-chunk containers pass their
    chunk table; single-body containers pass None for one whole-body chunk).
    """
    if chunk_bounds is None:
        chunk_bounds = ((0, len(body)),) if body else ()
    algo = CHECKSUM_ALGO
    chunk_crcs = b"".join(
        struct.pack("<I", checksum(body[off : off + ln], algo=algo))
        for off, ln in chunk_bounds
    )
    whole = checksum(body, checksum(head, algo=algo), algo=algo)
    payload = _msgpack.packb(
        {
            "a": algo,
            "h": struct.pack("<I", checksum(head, algo=algo)),
            "w": struct.pack("<I", whole),
            "c": chunk_crcs,
        }
    )
    return payload + _FOOTER.pack(len(payload), TRAILER_VERSION, TRAILER_MAGIC)


def read_trailer(blob: bytes) -> Optional[Trailer]:
    """Parse the trailer at the end of ``blob``; None when absent/unreadable.

    Absence is not an error at this layer — pre-trailer blobs are legitimate.
    Callers that must distinguish "legacy blob" from "trailer stripped" check
    the header's ``itg`` flag (which travels under the header checksum).
    """
    if len(blob) < _FOOTER.size or blob[-4:] != TRAILER_MAGIC:
        return None
    plen, ver, _magic = _FOOTER.unpack(blob[-_FOOTER.size :])
    if ver != TRAILER_VERSION or plen > len(blob) - _FOOTER.size:
        return None
    start = len(blob) - _FOOTER.size - plen
    try:
        payload = _msgpack.unpackb(blob[start : len(blob) - _FOOTER.size])
        algo = payload["a"]
        hdr = struct.unpack("<I", payload["h"])[0]
        whole = struct.unpack("<I", payload["w"])[0]
        crcs_raw = payload["c"]
        if len(crcs_raw) % 4:
            return None
        chunk_crcs = struct.unpack(f"<{len(crcs_raw) // 4}I", crcs_raw)
    except Exception:
        return None
    if not isinstance(algo, str):
        return None
    return Trailer(algo, hdr, whole, chunk_crcs, start)


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VerifyResult:
    """Outcome of inspecting a container's integrity trailer."""

    has_trailer: bool
    header_ok: bool = True
    whole_ok: bool = True
    #: indices of chunks whose checksum mismatched; None when unknown (no
    #: trailer, or trailer/table disagree on the chunk count)
    bad_chunks: Optional[List[int]] = None

    @property
    def ok(self) -> bool:
        return self.header_ok and self.whole_ok


def chunk_bounds_of(header: Dict[str, Any], body_len: int) -> List[Tuple[int, int]]:
    """Body-relative (off, len) of each independently decodable chunk, from
    the header chunk table for v2+ multi-chunk containers, else one
    whole-body chunk.  Bounds are validated against ``body_len`` — a hostile
    chunk table cannot direct reads outside the body."""
    chunks = header.get("chunks")
    if header.get("v", 1) >= 2 and isinstance(chunks, list):
        # a chunk's framing alone needs >= 21 bytes (magic + lengths + a
        # 1-byte header), so the table length is bounded by the real body
        guard_count(len(chunks), body_len // 21 + 1, "chunk-table entries")
        out = []
        for i, c in enumerate(chunks):
            if not isinstance(c, dict):
                raise ContainerError(f"corrupt chunk table: entry {i} not a map")
            off = guard_count(c.get("off"), body_len, f"chunk {i} offset")
            ln = guard_count(c.get("len"), body_len - off, f"chunk {i} length")
            out.append((off, ln))
        return out
    return [(0, body_len)] if body_len else []


def inspect(blob: bytes, header: Dict[str, Any], body_off: int) -> VerifyResult:
    """Check every checksum the trailer carries; never raises on mismatch
    (that policy belongs to :func:`verify_container` / salvage decode)."""
    tr = read_trailer(blob)
    body_len = _declared_body_len(blob)
    core_len = body_off + body_len
    if tr is None or tr.start != core_len:
        # no trailer, or a "trailer" that does not sit flush with the
        # declared body — either way there is nothing trustworthy to verify
        return VerifyResult(has_trailer=False)
    res = VerifyResult(has_trailer=True)
    res.header_ok = checksum(blob[:body_off], algo=tr.algo) == tr.header_crc
    res.whole_ok = checksum(blob[:core_len], algo=tr.algo) == tr.whole_crc
    if not res.whole_ok and res.header_ok:
        # localize: the header (and so the chunk table) is trustworthy
        try:
            bounds = chunk_bounds_of(header, body_len)
        except ContainerError:
            bounds = None
        if bounds is not None and len(bounds) == len(tr.chunk_crcs):
            res.bad_chunks = [
                i
                for i, (off, ln) in enumerate(bounds)
                if checksum(
                    blob[body_off + off : body_off + off + ln], algo=tr.algo
                )
                != tr.chunk_crcs[i]
            ]
    return res


def _declared_body_len(blob: bytes) -> int:
    """Body length from the prologue (callers have already parse_header'd)."""
    return int.from_bytes(blob[12:20], "little", signed=True)


def verify_container(blob: bytes, header: Dict[str, Any], body_off: int) -> VerifyResult:
    """Strict-mode policy: raise :class:`IntegrityError` naming the first
    damaged chunk (or region) on any mismatch; blobs written before the
    trailer era pass un-verified unless their header claims a trailer."""
    res = inspect(blob, header, body_off)
    if not res.has_trailer:
        if header.get("itg"):
            raise IntegrityError(
                "container header declares an integrity trailer but none is "
                "attached — trailer stripped or container truncated",
                region="trailer",
            )
        return res
    if not res.header_ok:
        raise IntegrityError(
            "container header bytes fail their checksum — header damaged",
            region="header",
        )
    if not res.whole_ok:
        if res.bad_chunks:
            first = res.bad_chunks[0]
            raise IntegrityError(
                f"container chunk {first} fails its checksum "
                f"({len(res.bad_chunks)} of {_nchunks(header)} chunks damaged)",
                chunk_index=first,
            )
        raise IntegrityError(
            "container fails its whole-blob digest (damage outside any "
            "chunk: padding, chunk table, or trailer bytes)",
        )
    return res


def _nchunks(header: Dict[str, Any]) -> int:
    chunks = header.get("chunks")
    return len(chunks) if isinstance(chunks, list) else 1


# ---------------------------------------------------------------------------
# salvage reporting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkDamage:
    """One damaged chunk: flat element range [start, stop) filled/lost."""

    index: int
    start: int
    stop: int
    reason: str  # "checksum" | "decode-error" | "missing"


@dataclasses.dataclass
class SalvageReport:
    """What salvage decode recovered and what it had to give up on."""

    total_chunks: int = 0
    recovered: List[int] = dataclasses.field(default_factory=list)
    damage: List[ChunkDamage] = dataclasses.field(default_factory=list)
    fill_value: float = 0.0
    checksummed: bool = False  # a trailer drove the per-chunk verdicts

    @property
    def ok(self) -> bool:
        return not self.damage

    @property
    def lost_elements(self) -> int:
        return sum(d.stop - d.start for d in self.damage)

    def lost_ranges(self) -> List[Tuple[int, int]]:
        return [(d.start, d.stop) for d in self.damage]

    def recovered_ranges(
        self, chunk_ranges: Sequence[Tuple[int, int]]
    ) -> List[Tuple[int, int]]:
        return [chunk_ranges[i] for i in self.recovered]

    def summary(self) -> str:
        if self.ok:
            return f"salvage: all {self.total_chunks} chunks recovered"
        lost = ", ".join(
            f"#{d.index}[{d.start}:{d.stop}] ({d.reason})" for d in self.damage
        )
        return (
            f"salvage: {len(self.recovered)}/{self.total_chunks} chunks "
            f"recovered, {self.lost_elements} elements lost: {lost}"
        )


# ---------------------------------------------------------------------------
# writer switch (benchmarks measure integrity-off vs -on; tests pin legacy)
# ---------------------------------------------------------------------------

WRITE_TRAILERS = True


@contextlib.contextmanager
def trailers_disabled() -> Iterator[None]:
    """Write pre-trailer (legacy-framed) containers inside the block — for
    overhead benchmarking and legacy-fixture generation only."""
    global WRITE_TRAILERS
    prev = WRITE_TRAILERS
    WRITE_TRAILERS = False
    try:
        yield
    finally:
        WRITE_TRAILERS = prev
