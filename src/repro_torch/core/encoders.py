"""Encoder module (paper §3.2 "Encoder", Appendix A.4).

Instances:
  * HuffmanEncoder      — canonical Huffman [36] over the quantization codes.
  * FixedHuffmanEncoder — SZ-Pastri's predefined-tree variant [19]: a static
                          two-sided-geometric code model centred on the zero
                          bin eliminates tree construction + storage cost.
  * BitpackEncoder      — fixed-width bit packing (fast path / small alphabets).
  * RawEncoder          — passthrough (module bypass).
  * LegacyHuffmanEncoder — Huffman that writes the older v1 stream layout.

Entropy coding is byte-level work and stays on the host in numpy; its
streams are byte-identical to the JAX package's.

Vectorization: encode emits one bitstream
with *sync points* every ``SYNC`` symbols (a bit-offset each, ~0.06 bit/sym
overhead).  Decode then advances all sync lanes in lock-step with numpy
gathers — the same interleaved-entropy-coder trick production codecs use —
instead of a pointer-chasing per-symbol loop.  Code lengths are capped at 16
bits (zlib-style frequency scaling) so one 2^16 table drives decode.

Stream formats (the payload bit layout is identical in both):

  v1 — head [n, total_bits, n_sync] int64, sync offsets int64.  Written by
       older encoders; still decoded (and still writable via
       ``stream_version=1`` for compatibility testing).
  v2 — head [-2, n, total_bits, n_sync] int64, sync offsets uint32 (half the
       sync overhead; total_bits must fit 32 bits, else v1 layout is used).

The encode hot path ORs codes into 64-bit words at cumulative bit offsets
(no n x maxlen bit-matrix intermediate); the decode hot path gathers one
64-bit window per lane and peels several symbols from it before the next
gather.
"""
from __future__ import annotations

import abc
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from . import telemetry as tel

_MAXLEN = 16
_SYNC = 1024
_V2_MARK = -2  # first head int64 of a v2 stream (v1 stores n >= 0 there)

#: histogram fast path applies when codes are non-negative and bounded by
#: this (quantization codes live in [0, 2*radius], far below it)
_HIST_MAX = 1 << 22


# ---------------------------------------------------------------------------
# canonical Huffman machinery
# ---------------------------------------------------------------------------

def _huffman_tree_depths(f: np.ndarray) -> np.ndarray:
    """Leaf depths of the greedy Huffman tree of ``f`` (at least 2 leaves).

    The two-queue form of the classic heap [36]: leaves sorted by (freq,
    index), merged nodes in creation order (their freqs never decrease).
    Taking the smaller head, a leaf on a tie, pops nodes in the heap's
    (freq, id) order, so the tree, and every length, is the heap's."""
    n = f.size
    order = np.argsort(f, kind="stable")
    leaf_f = f[order].tolist()
    big = sum(leaf_f) + 1  # above every node (Python ints): ends an emptied queue
    leaf_f.append(big)
    leaf_id = order.tolist()
    merged = [big] * (n - 1)
    parent = [0] * (2 * n - 1)
    i = j = 0
    for node in range(n, 2 * n - 1):
        if leaf_f[i] <= merged[j]:
            a = leaf_f[i]
            parent[leaf_id[i]] = node
            i += 1
        else:
            a = merged[j]
            parent[n + j] = node
            j += 1
        if leaf_f[i] <= merged[j]:
            b = leaf_f[i]
            parent[leaf_id[i]] = node
            i += 1
        else:
            b = merged[j]
            parent[n + j] = node
            j += 1
        merged[node - n] = a + b
    depth = [0] * (2 * n - 1)
    for node in range(2 * n - 3, -1, -1):  # a parent's id exceeds its children's
        depth[node] = depth[parent[node]] + 1
    return np.array(depth[:n], np.uint8)


def _huffman_code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Code length per symbol with freq > 0 (classic greedy heap [36])."""
    sym = np.flatnonzero(freqs)
    if sym.size == 0:
        return np.zeros(0, np.uint8), sym
    if sym.size == 1:
        return np.ones(1, np.uint8), sym
    f = freqs[sym].astype(np.int64)
    while True:
        lens = _huffman_tree_depths(f)
        if lens.max() <= _MAXLEN:
            return lens, sym
        # cap: flatten the distribution and rebuild (zlib heuristic)
        f = (f + 1) // 2


def _canonical_codes(lens_sorted: np.ndarray) -> np.ndarray:
    """Canonical codes for symbols already sorted by (len, symbol).

    code_i = (code_{i-1} + 1) << (len_i - len_{i-1}) is the Kraft sum of the
    shorter codes, sum_{k<i} 2^-len_k, scaled by 2^len_i: exact in int64 for
    lengths up to ``_MAXLEN``."""
    if lens_sorted.size == 0:
        return np.zeros(0, np.uint32)
    lens = lens_sorted.astype(np.int64)
    top = int(lens.max())
    kraft = np.zeros(lens.size, np.int64)
    np.cumsum(np.left_shift(1, top - lens[:-1]), out=kraft[1:])
    return np.right_shift(kraft, top - lens).astype(np.uint32)


class _HuffTable:
    """Built codec state: per-symbol (code, len) + 2^16 decode table."""

    def __init__(self, symbols: np.ndarray, lengths: np.ndarray):
        order = np.lexsort((symbols, lengths))
        self.sym_sorted = symbols[order]
        self.len_sorted = lengths[order].astype(np.uint8)
        self.codes_sorted = _canonical_codes(self.len_sorted)
        # encode-side lookup: dense over max symbol value
        top = int(symbols.max()) + 1 if symbols.size else 1
        self.enc_code = np.zeros(top, np.uint32)
        self.enc_len = np.zeros(top, np.uint8)
        self.enc_code[self.sym_sorted] = self.codes_sorted
        self.enc_len[self.sym_sorted] = self.len_sorted
        # decode-side: canonical codes tile [0, 2^MAXLEN) contiguously
        reps = (1 << (_MAXLEN - self.len_sorted.astype(np.int64)))
        self.dec_sym = np.repeat(self.sym_sorted, reps)
        self.dec_len = np.repeat(self.len_sorted, reps)
        full = 1 << _MAXLEN
        if 0 < self.dec_sym.size < full:
            # incomplete tree only happens for the 1-symbol alphabet; any
            # window then decodes to that symbol, so padding is safe.
            pad = full - self.dec_sym.size
            self.dec_sym = np.concatenate([self.dec_sym, np.full(pad, self.dec_sym[-1])])
            self.dec_len = np.concatenate([self.dec_len, np.full(pad, self.dec_len[-1], np.uint8)])
        self.maxlen = int(self.len_sorted.max()) if self.len_sorted.size else 1
        # (symbol << 8 | length) as uint64: the batched decode pays ONE gather
        # per symbol and splits with register shifts instead of gathering two
        # parallel tables
        self.dec_packed = (self.dec_sym.astype(np.uint64) << np.uint64(8)) | (
            self.dec_len.astype(np.uint64)
        )


#: built tables keyed by code-length signature — the chunked engine emits one
#: Huffman stream per chunk and identical chunks (or identical length
#: profiles, which is all a canonical table depends on) are common, so
#: rebuilding the 2^16 decode table per chunk is pure waste.  A proper LRU
#: (not clear-on-full): the serving layer interleaves fetches across many
#: containers, and one pathological stream of unique signatures must not
#: flush every hot tenant's table at once.  Lock-guarded: the async service
#: decodes on a thread pool.
_TABLE_CACHE: "OrderedDict[bytes, _HuffTable]" = OrderedDict()
_TABLE_CACHE_MAX = 128
_TABLE_LOCK = threading.Lock()
_TABLE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def _cached_table(lengths: np.ndarray) -> _HuffTable:
    """Canonical table over symbols ``0..k-1`` with the given code lengths.

    Keyed by the length signature (canonical codes are a pure function of
    it), LRU-bounded at ``_TABLE_CACHE_MAX`` entries.
    """
    key = np.asarray(lengths, np.uint8).tobytes()
    with _TABLE_LOCK:
        table = _TABLE_CACHE.get(key)
        if table is not None:
            _TABLE_CACHE.move_to_end(key)
            _TABLE_STATS["hits"] += 1
            return table
        _TABLE_STATS["misses"] += 1
    # build outside the lock (the 2^16 np.repeat is the expensive part);
    # concurrent misses on the same signature build twice, last write wins
    table = _HuffTable(
        np.arange(lengths.size, dtype=np.int64), np.asarray(lengths, np.uint8).copy()
    )
    with _TABLE_LOCK:
        _TABLE_CACHE[key] = table
        _TABLE_CACHE.move_to_end(key)
        while len(_TABLE_CACHE) > _TABLE_CACHE_MAX:
            _TABLE_CACHE.popitem(last=False)
            _TABLE_STATS["evictions"] += 1
    return table


def table_cache_stats() -> Dict[str, int]:
    """Hit/miss/eviction counts plus current size of the decode-table LRU."""
    with _TABLE_LOCK:
        out = dict(_TABLE_STATS)
        out["size"] = len(_TABLE_CACHE)
    return out


def clear_table_cache(reset_stats: bool = True) -> None:
    with _TABLE_LOCK:
        _TABLE_CACHE.clear()
        if reset_stats:
            for k in _TABLE_STATS:
                _TABLE_STATS[k] = 0


def _windows64_at(buf: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """64-bit MSB-aligned windows starting at arbitrary bit positions.

    One contiguous 8-byte gather per lane reinterpreted as a big-endian
    uint64 (a byteswap, no shift-accumulate), plus a ninth byte for the
    sub-byte phase.  ``buf`` must be padded with >= 16 zero bytes past the
    last stream byte.
    """
    byte = (pos >> 3).astype(np.int64)
    idx = byte[:, None] + np.arange(8, dtype=np.int64)[None, :]
    v = buf[idx].view(">u8").astype(np.uint64).reshape(-1)
    sh = (pos & 7).astype(np.uint64)
    tail = buf[byte + 8].astype(np.uint64) >> (np.uint64(8) - sh)
    return np.where(sh > 0, (v << sh) | tail, v)


def _pack_codes(
    codes: np.ndarray, lens: np.ndarray, offsets: np.ndarray, total_bits: int
) -> bytes:
    """OR variable-length MSB-first codes into big-endian uint64 words.

    Each code occupies bits [offsets[i], offsets[i]+lens[i]) of the stream
    (bit 0 = MSB of byte 0).  A <=16-bit code spans at most two 64-bit words;
    within a word the bit ranges are disjoint, so per-word accumulation is a
    grouped bitwise-OR (``np.bitwise_or.reduceat`` over runs of equal word
    index — offsets are monotonic, so both the low- and the high-word index
    sequences are sorted and need no sort).  No n x maxlen intermediate.
    """
    nbytes = (total_bits + 7) >> 3
    if codes.size == 0:
        return b""
    nwords = (total_bits + 63) >> 6
    words = np.zeros(nwords + 1, np.uint64)  # +1 absorbs the last spill
    starts = offsets[:-1]
    widx = starts >> 6
    c64 = codes.astype(np.uint64)
    rsh = 64 - (starts & 63) - lens.astype(np.int64)  # in [-15, 63]
    lo = np.where(
        rsh >= 0,
        c64 << np.maximum(rsh, 0).astype(np.uint64),
        c64 >> np.where(rsh < 0, -rsh, 0).astype(np.uint64),
    )
    run = np.flatnonzero(np.r_[True, widx[1:] != widx[:-1]])
    words[widx[run]] = np.bitwise_or.reduceat(lo, run)
    spill = rsh < 0
    if spill.any():
        hi = c64[spill] << (64 + rsh[spill]).astype(np.uint64)
        hidx = widx[spill] + 1
        run = np.flatnonzero(np.r_[True, hidx[1:] != hidx[:-1]])
        words[hidx[run]] |= np.bitwise_or.reduceat(hi, run)
    return words.astype(">u8").tobytes()[:nbytes]


def _encode_stream(syms: np.ndarray, table: _HuffTable, version: int = 2) -> bytes:
    """Word-packed encode; emits the v2 head unless told (or forced) to v1."""
    lens = table.enc_len[syms]
    codes = table.enc_code[syms]
    if syms.size and int(lens.min()) == 0:
        raise ValueError("symbol outside Huffman alphabet")
    offsets = np.zeros(syms.size + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    sync = offsets[:-1:_SYNC]
    total_bits = int(offsets[-1])
    payload = _pack_codes(codes, lens, offsets, total_bits)
    if version == 1 or total_bits >= (1 << 32):
        # v1 layout (also the >=4-Gbit fallback: sync must fit uint32 in v2)
        head = np.asarray([syms.size, total_bits, sync.size], np.int64).tobytes()
        return head + sync.astype(np.int64).tobytes() + payload
    head = np.asarray(
        [_V2_MARK, syms.size, total_bits, sync.size], np.int64
    ).tobytes()
    return head + sync.astype(np.uint32).tobytes() + payload


def _parse_stream_head(
    buf: bytes, offset: int
) -> Tuple[int, int, np.ndarray, int]:
    """Common v1/v2 head parsing: (n, total_bits, sync, payload_pos)."""
    first = int(np.frombuffer(buf, np.int64, count=1, offset=offset)[0])
    if first == _V2_MARK:
        head = np.frombuffer(buf, np.int64, count=4, offset=offset)
        n, total_bits, n_sync = int(head[1]), int(head[2]), int(head[3])
        pos = offset + 32
        sync = np.frombuffer(buf, np.uint32, count=n_sync, offset=pos).astype(np.int64)
        pos += n_sync * 4
    else:
        head = np.frombuffer(buf, np.int64, count=3, offset=offset)
        n, total_bits, n_sync = int(head[0]), int(head[1]), int(head[2])
        pos = offset + 24
        sync = np.frombuffer(buf, np.int64, count=n_sync, offset=pos).copy()
        pos += n_sync * 8
    return n, total_bits, sync, pos


def _decode_stream(buf: bytes, offset: int, table: _HuffTable) -> Tuple[np.ndarray, int]:
    """Batched lane decode (v1 and v2 streams).

    Each outer round gathers ONE 64-bit window per lane and peels up to
    ``K = 48 // maxlen + 1`` symbols from it with in-register shifts (every
    lookup is guaranteed >= 16 valid bits while the bits consumed stay <= 48),
    so the expensive stream gather is amortized over K symbols.  Lanes run
    unconditionally into per-lane padding (clamped to the stream end) and the
    over-decoded tail is dropped by one final mask — no per-symbol boolean
    bookkeeping.
    """
    n, total_bits, sync, pos = _parse_stream_head(buf, offset)
    nbytes = (total_bits + 7) // 8
    stream = np.frombuffer(buf, np.uint8, count=nbytes, offset=pos)
    pos += nbytes
    if n == 0:
        return np.zeros(0, np.int64), pos - offset
    stream = np.concatenate([stream, np.zeros(16, np.uint8)])
    n_lanes = sync.size
    lanes = sync.astype(np.int64)
    # symbol k of lane l lands in out_t[k, l]: every store is a CONTIGUOUS
    # row write (the lane-strided layout would scatter across cache lines),
    # and only the LAST lane is ever partial (sync points are every _SYNC
    # symbols), so the lane-major transpose trimmed to n is the answer — no
    # per-symbol active-mask bookkeeping at all.
    steps = min(_SYNC, n)
    out_t = np.empty((steps, n_lanes), np.int64)
    dec_packed = table.dec_packed
    K = max(1, min(steps, 48 // table.maxlen + 1))
    limit = np.int64(total_bits)
    k = 0
    while k < steps:
        kk = min(K, steps - k)
        w = _windows64_at(stream, lanes)
        consumed = np.zeros(n_lanes, np.uint64)
        for j in range(kk):
            v = dec_packed[(w >> np.uint64(48)).astype(np.int64)]
            out_t[k + j] = v >> np.uint64(8)  # symbol (assignment casts)
            ln = v & np.uint64(0xFF)
            w <<= ln
            consumed += ln
        lanes += consumed.astype(np.int64)
        np.minimum(lanes, limit, out=lanes)  # finished lanes idle at the end
        k += kk
    return out_t.T.reshape(-1)[:n], pos - offset


# ---------------------------------------------------------------------------
# Encoder interface + instances
# ---------------------------------------------------------------------------

class Encoder(abc.ABC):
    """Paper Appendix A.4: encode(bins)->bytes / decode(bytes,len)->bins.

    save()/load() (tree metadata) is folded into the byte stream each encoder
    emits, which keeps the pipeline driver generic."""

    name = "abstract"

    @abc.abstractmethod
    def encode(self, codes: np.ndarray) -> bytes: ...

    @abc.abstractmethod
    def decode(self, buf: bytes, n: int) -> np.ndarray: ...


class RawEncoder(Encoder):
    name = "raw"

    def encode(self, codes):
        arr = np.ascontiguousarray(codes)
        head = np.asarray([arr.itemsize], np.int64).tobytes()
        return head + arr.tobytes()

    def decode(self, buf, n):
        itemsize = int(np.frombuffer(buf, np.int64, count=1)[0])
        dt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.int64}[itemsize]
        return np.frombuffer(buf, dt, count=n, offset=8).copy()


class BitpackEncoder(Encoder):
    """Fixed-width packing; width = bits needed for the max code present."""

    name = "bitpack"

    def encode(self, codes):
        arr = np.ascontiguousarray(codes).astype(np.uint32).reshape(-1)
        width = max(1, int(arr.max()).bit_length()) if arr.size else 1
        shifts = np.arange(width - 1, -1, -1, dtype=np.uint32)
        bits = ((arr[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
        payload = np.packbits(bits.reshape(-1)).tobytes()
        head = np.asarray([arr.size, width], np.int64).tobytes()
        return head + payload

    def decode(self, buf, n):
        head = np.frombuffer(buf, np.int64, count=2)
        count, width = int(head[0]), int(head[1])
        nbits = count * width
        raw = np.frombuffer(buf, np.uint8, count=(nbits + 7) // 8, offset=16)
        bits = np.unpackbits(raw, count=nbits).reshape(count, width)
        shifts = np.arange(width - 1, -1, -1, dtype=np.uint32)
        return (bits.astype(np.uint32) << shifts[None, :]).sum(axis=1)


def _alphabet_of(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(distinct values, frequencies, rank indices) of an int array.

    Quantization codes are non-negative and bounded by ``2*radius``, so the
    common case is a bounded ``np.bincount`` histogram + an O(n) rank gather
    instead of the O(n log n) sort ``np.unique`` pays per call.
    """
    lo = int(arr.min()) if arr.size else 0
    hi = int(arr.max()) if arr.size else 0
    if 0 <= lo and hi < _HIST_MAX:
        freqs_full = np.bincount(arr)
        vals = np.flatnonzero(freqs_full)
        rank = np.zeros(hi + 1, np.int64)
        rank[vals] = np.arange(vals.size, dtype=np.int64)
        return vals.astype(np.int64), freqs_full[vals], rank[arr]
    vals, inv = np.unique(arr, return_inverse=True)
    return vals, np.bincount(inv), inv.astype(np.int64)


class HuffmanDecodeHandle:
    """Parsed, reusable decode state for one Huffman blob: the alphabet
    values, the built canonical table and the stream offset, so a caller
    that decodes the same blob repeatedly (the serving layer's random-access
    reads) pays the header parse and table build once.  The handle pins its
    table, so it stays valid after the signature leaves the module LRU."""

    __slots__ = ("vals", "table", "stream_pos")

    def __init__(self, vals: np.ndarray, table: _HuffTable, stream_pos: int):
        self.vals = vals
        self.table = table
        self.stream_pos = stream_pos


def huffman_decode_handle(buf: bytes) -> Optional[HuffmanDecodeHandle]:
    """A :class:`HuffmanDecodeHandle` for a ``HuffmanEncoder`` blob; None for
    the empty-stream blob (k == 0), which decodes without a table."""
    # alphabet header: K, symbol values (int64), lengths (uint8)
    k = int(np.frombuffer(buf, np.int64, count=1)[0])
    if k == 0:
        return None
    pos = 8
    vals = np.frombuffer(buf, np.int64, count=k, offset=pos)
    pos += k * 8
    lens = np.frombuffer(buf, np.uint8, count=k, offset=pos)
    pos += k
    return HuffmanDecodeHandle(vals, _cached_table(lens), pos)


class HuffmanEncoder(Encoder):
    """Canonical Huffman built from the observed code frequencies [36].

    ``stream_version=2`` (default) emits the word-packed v2 stream; ``1``
    emits the older layout (the decoder reads both).
    """

    name = "huffman"

    def __init__(self, stream_version: int = 2):
        self.stream_version = int(stream_version)

    def encode(self, codes):
        arr = np.ascontiguousarray(codes).reshape(-1)
        if arr.dtype.kind not in "iu":
            arr = arr.astype(np.int64)
        if arr.size == 0:
            return np.asarray([0], np.int64).tobytes()
        # the coder's two halves, each a span: the table, then the stream
        with tel.span("huffman_table", bytes=arr.nbytes):
            vals, freqs, inv = _alphabet_of(arr)
            lens, present = _huffman_code_lengths(freqs)
            table = _cached_table(lens)
        with tel.span("huffman_pack", bytes=arr.nbytes):
            stream = _encode_stream(inv, table, self.stream_version)
            # alphabet header: K, symbol values (int64), lengths (uint8)
            head = np.asarray([vals.size], np.int64).tobytes()
            return head + vals.astype(np.int64).tobytes() + lens.tobytes() + stream

    def decode(self, buf, n, handle: Optional[HuffmanDecodeHandle] = None):
        if handle is None:
            with tel.span("huffman_table", bytes=len(buf)):
                handle = huffman_decode_handle(buf)
        if handle is None:  # empty stream (k == 0)
            return np.zeros(0, np.int64)
        with tel.span("huffman_unpack", bytes=len(buf)):
            idx, _ = _decode_stream(buf, handle.stream_pos, handle.table)
            if idx.size != n:
                raise ValueError(f"huffman stream length mismatch {idx.size} != {n}")
            return handle.vals[idx]


class LegacyHuffmanEncoder(HuffmanEncoder):
    """The v1-stream Huffman: writes the older layout (int64 head and sync
    offsets), which every decoder still reads.  ``name`` stays "huffman";
    blobs are interchangeable with :class:`HuffmanEncoder`."""

    def __init__(self):
        super().__init__(stream_version=1)


class FixedHuffmanEncoder(Encoder):
    """Predefined tree (SZ-Pastri [19]): no build or storage cost.

    Model: two-sided geometric over the distance from the zero bin (symbol
    ``radius``), with code 0 (unpredictable) and far tails folded into an
    escape class that is followed by a raw int64 value.  Built tables are
    cached per (radius, decay, span) under a lock: chunk workers share them.
    """

    name = "fixed_huffman"
    _cache: Dict[Tuple[int, float, int], Tuple[_HuffTable, np.ndarray]] = {}
    _lock = threading.Lock()

    def __init__(self, radius: int = 32768, decay: float = 0.7, span: int = 256, stream_version: int = 2):
        self.radius = radius
        self.decay = decay
        self.span = span  # symbols within [radius-span, radius+span] get codes
        self.stream_version = int(stream_version)

    def _table(self) -> Tuple[_HuffTable, np.ndarray]:
        key = (self.radius, self.decay, self.span)
        with FixedHuffmanEncoder._lock:
            hit = FixedHuffmanEncoder._cache.get(key)
        if hit is not None:
            return hit
        # alphabet: 0 (unpred), [radius-span, radius+span], escape symbol
        core = np.arange(self.radius - self.span, self.radius + self.span + 1)
        symbols = np.concatenate([[0], core, [-1]])  # -1 = escape
        dist = np.abs(core - self.radius).astype(np.float64)
        w = np.power(self.decay, np.minimum(dist, 96.0))  # clamp underflow
        freqs = np.concatenate([[w.sum() * 0.01], w, [w.sum() * 0.001]])
        scaled = np.maximum(1, (freqs / freqs.max() * (1 << 30)).astype(np.int64))
        lens, present = _huffman_code_lengths(scaled)
        built = (_HuffTable(np.arange(symbols.size, dtype=np.int64), lens), symbols)
        with FixedHuffmanEncoder._lock:
            # concurrent misses build the same table; the first one stays
            return FixedHuffmanEncoder._cache.setdefault(key, built)

    def encode(self, codes):
        table, symbols = self._table()
        arr = np.ascontiguousarray(codes).reshape(-1).astype(np.int64)
        lo, hi = self.radius - self.span, self.radius + self.span
        in_core = (arr >= lo) & (arr <= hi)
        is_zero = arr == 0
        escape = ~(in_core | is_zero)
        # map to alphabet indices: 0->0, core->1.., escape->last
        idx = np.where(is_zero, 0, np.where(in_core, arr - lo + 1, symbols.size - 1))
        stream = _encode_stream(idx.astype(np.int64), table, self.stream_version)
        esc_vals = arr[escape].astype(np.int64)
        head = np.asarray([self.radius, self.span, int(esc_vals.size)], np.int64).tobytes()
        head += np.asarray([self.decay], np.float64).tobytes()
        return head + esc_vals.tobytes() + stream

    def decode(self, buf, n):
        head = np.frombuffer(buf, np.int64, count=3)
        radius, span, n_esc = int(head[0]), int(head[1]), int(head[2])
        decay = float(np.frombuffer(buf, np.float64, count=1, offset=24)[0])
        pos = 32
        esc_vals = np.frombuffer(buf, np.int64, count=n_esc, offset=pos)
        pos += n_esc * 8
        table, symbols = FixedHuffmanEncoder(radius=radius, span=span, decay=decay)._table()
        idx, _ = _decode_stream(buf, pos, table)
        if idx.size != n:
            raise ValueError("fixed huffman stream length mismatch")
        lo = radius - span
        out = np.where(idx == 0, 0, idx - 1 + lo)
        out[idx == symbols.size - 1] = esc_vals
        return out


_REGISTRY = {
    "raw": RawEncoder,
    "bitpack": BitpackEncoder,
    "huffman": HuffmanEncoder,
    "fixed_huffman": FixedHuffmanEncoder,
}


def register(name: str, cls) -> None:
    _REGISTRY[name] = cls


def make(name: str, **kw) -> Encoder:
    return _REGISTRY[name](**kw)
