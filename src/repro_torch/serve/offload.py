"""Async multi-tenant KV-offload service.

The JAX package's ``repro.serve.offload``, ported: the same requests give
the same blobs and the same decoded chunks, and the metrics carry the same
``sz3_serve_*`` names.  Pages are torch tensors on the service's ``device``
(``"cuda"`` unless the caller passes ``"cpu"``): a put compresses the page
there through the chunked engine, so on the card the Lorenzo kernels run
each chunk's predict stage, and a fetch returns a tensor on that device,
decoded there.

The paper's APS use case is a serving-shaped workload: many concurrent
producers evicting KV pages through a composed pipeline and paging them back
in under tight latency budgets.  This module wraps the chunked container
engine (:mod:`repro_torch.core.chunking`) in a service:

  * **asyncio front** — :class:`OffloadService` exposes ``await``-able
    ``put`` / ``fetch`` / ``evict`` for named ``(tenant, page)`` KV pages.
  * **pooled workers** — compress/decode jobs run on a
    ``ThreadPoolExecutor`` (default: zlib/numpy release the GIL, and the
    jobs share the service's device) or a ``ProcessPoolExecutor``
    (``executor="process"``, spawned; the worker functions are module-level
    and picklable, with a per-process decode-state cache).  A page crosses
    to a worker process as a host numpy array and the worker moves it to
    its own device; blobs come back as bytes and decoded chunks as numpy.
    No CUDA tensor is pickled across.
  * **request coalescing** — fetches that arrive within ``coalesce_ms`` are
    drained into one batch, grouped by page, and submitted as one executor
    job per page, so a burst of small random-access reads pays one dispatch.
  * **cached decode state** — a bounded LRU (:class:`DecodeStateCache`)
    keyed by blob identity: parsed headers + chunk tables
    (:class:`~repro_torch.core.chunking.ChunkedIndex`) so repeated fetches
    skip msgpack parsing, plus a byte-budgeted layer of decoded chunk
    tensors so re-reads of a hot KV page skip the entropy decode (the
    dominant per-fetch cost) entirely; the Huffman decode tables themselves
    live in the signature-keyed LRU inside :mod:`repro_torch.core.encoders`,
    which these layers keep warm.

Per-chunk reads stay O(chunk): :func:`repro_torch.core.chunking.decompress_chunk`
verifies the header CRC plus only the requested chunk's CRC, so a corrupt
sibling chunk surfaces a typed :class:`OffloadError` to exactly the request
that asked for it — the rest of the batch completes.

Telemetry: ``sz3_serve_request_seconds`` latency histogram,
``sz3_serve_queue_depth`` gauge, ``sz3_serve_index_cache_{hits,misses}_total``
counters, batch/coalescing counters, and an entries gauge for cache sizing.
"""
from __future__ import annotations

import asyncio
import multiprocessing
import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import Executor, ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import encoders
from ..core import integrity
from ..core import pipeline as pl_mod
from ..core import telemetry
from ..core.chunking import (
    DEFAULT_CANDIDATES,
    ChunkedIndex,
    decompress_chunk,
    parse_chunked_index,
    sz3_chunked,
)
from ..core.config import CompressionConfig, ErrorBoundMode
from ..core.integrity import IntegrityError

log = telemetry.get_logger("serve.offload")

__all__ = [
    "OffloadError",
    "DecodeStateCache",
    "OffloadService",
    "blob_key",
]


class OffloadError(RuntimeError):
    """A request-scoped service failure, addressed to its owning request.

    ``cause_type`` names the underlying error class (``"IntegrityError"``,
    ``"ContainerError"``, ...) so callers can branch without string matching;
    ``chunk`` is the chunk index the failing request asked for (None for
    whole-page requests), and ``chunk_index`` is the damaged chunk the
    integrity layer localized, when it did.
    """

    def __init__(
        self,
        message: str,
        *,
        tenant: Optional[str] = None,
        page: Optional[str] = None,
        chunk: Optional[int] = None,
        cause_type: Optional[str] = None,
        chunk_index: Optional[int] = None,
    ):
        super().__init__(message)
        self.tenant = tenant
        self.page = page
        self.chunk = chunk
        self.cause_type = cause_type
        self.chunk_index = chunk_index


def blob_key(blob: bytes) -> Tuple[int, int, int]:
    """Identity fingerprint of a container: O(header + trailer), not O(body).

    (length, CRC of the prologue + msgpack header, CRC of the integrity
    trailer).  These are exactly the bytes a :class:`ChunkedIndex` is derived
    from (the body contributes only its length, pinned by the prologue), so
    two blobs with equal keys parse to identical decode state and may share
    a cache entry — even when their bodies differ (e.g. a corrupt copy; the
    requested chunk's CRC check at read time still runs against the actual
    bytes).  Trailer-less (legacy) blobs have no body digest to lean on and
    fall back to a full-tail CRC, paying O(body) once per cache miss.
    """
    n = len(blob)
    if n >= 20 and blob[:4] == b"SZ3J":
        hlen = int.from_bytes(blob[4:12], "little", signed=True)
        head_end = min(n, 20 + max(hlen, 0))
        tail_crc = None
        if n >= 9 and blob[-4:] == integrity.TRAILER_MAGIC:
            plen = int.from_bytes(blob[-9:-5], "little")
            start = n - 9 - plen
            if start >= head_end:
                tail_crc = zlib.crc32(blob[start:])
        if tail_crc is None:
            tail_crc = zlib.crc32(blob[head_end:])
        return (n, zlib.crc32(blob[:head_end]), tail_crc)
    return (n, zlib.crc32(blob), 0)


class DecodeStateCache:
    """Bounded LRU of decode state keyed by blob identity.  Three layers:

    1. **parsed indexes** — :class:`~repro_torch.core.chunking.ChunkedIndex`
       objects (header, chunk table, trailer CRCs), so repeated fetches skip
       the msgpack parse and trailer scan (``max_entries`` bound).
    2. **decoded chunks** — the tensors themselves, wherever they live,
       byte-budgeted (``max_chunk_bytes``): a KV page that is re-read while
       hot skips the whole entropy decode.  Entries are returned without
       copying (torch has no read-only flag: a caller that mutates a
       fetched chunk clones it first); the chunk key includes the verify
       policy, so a ``verify="off"`` decode is never served to a strict
       reader.
    3. **Huffman decode tables** — not stored here: they live in the
       signature-keyed LRU inside :mod:`repro_torch.core.encoders`, which
       layers 1–2 keep warm.

    Thread-safe: the service decodes on a pool.  Indexes parse with
    ``verify="off"`` — integrity decisions (header CRC, per-chunk CRC,
    stripped trailer) are made per *read* from the cached fields.
    """

    def __init__(
        self,
        max_entries: int = 64,
        max_chunk_bytes: int = 32 << 20,
        metrics_prefix: str = "sz3_serve",
    ):
        self.max_entries = max(1, int(max_entries))
        self.max_chunk_bytes = max(0, int(max_chunk_bytes))
        self._prefix = metrics_prefix
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[int, int, int], ChunkedIndex]" = OrderedDict()
        self._chunks: "OrderedDict[Tuple[Tuple[int, int, int], int, str], torch.Tensor]" = (
            OrderedDict()
        )
        self._chunk_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.chunk_hits = 0
        self.chunk_misses = 0
        self.chunk_evictions = 0

    def index_for(self, blob: bytes) -> ChunkedIndex:
        key = blob_key(blob)
        with self._lock:
            idx = self._entries.get(key)
            if idx is not None:
                self._entries.move_to_end(key)
                self.hits += 1
        if idx is not None:
            telemetry.metric_count(f"{self._prefix}_index_cache_hits_total")
            return idx
        # parse outside the lock; concurrent misses on one blob parse twice
        idx = parse_chunked_index(blob, verify="off")
        evicted = 0
        with self._lock:
            self.misses += 1
            self._entries[key] = idx
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
                evicted += 1
            size = len(self._entries)
        telemetry.metric_count(f"{self._prefix}_index_cache_misses_total")
        if evicted:
            telemetry.metric_count(f"{self._prefix}_index_cache_evictions_total", evicted)
        telemetry.metric_gauge(f"{self._prefix}_index_cache_entries", size)
        return idx

    def get_chunk(
        self, blob: bytes, index: int, verify: str = "strict"
    ) -> Optional[torch.Tensor]:
        """The decoded tensor for chunk ``index``, or None on miss.

        Hits return the cached tensor directly (no copy) — callers that need
        to mutate copy on their side.
        """
        key = (blob_key(blob), int(index), verify)
        with self._lock:
            arr = self._chunks.get(key)
            if arr is not None:
                self._chunks.move_to_end(key)
                self.chunk_hits += 1
            else:
                self.chunk_misses += 1
        telemetry.metric_count(
            f"{self._prefix}_chunk_cache_{'hits' if arr is not None else 'misses'}_total"
        )
        return arr

    def put_chunk(
        self, blob: bytes, index: int, arr: torch.Tensor, verify: str = "strict"
    ) -> None:
        nbytes = _nbytes(arr)
        if nbytes > self.max_chunk_bytes:  # never evict everything for one entry
            return
        key = (blob_key(blob), int(index), verify)
        evicted = 0
        with self._lock:
            old = self._chunks.pop(key, None)
            if old is not None:
                self._chunk_bytes -= _nbytes(old)
            self._chunks[key] = arr
            self._chunk_bytes += nbytes
            while self._chunk_bytes > self.max_chunk_bytes and self._chunks:
                _, dropped = self._chunks.popitem(last=False)
                self._chunk_bytes -= _nbytes(dropped)
                self.chunk_evictions += 1
                evicted += 1
            total = self._chunk_bytes
        if evicted:
            telemetry.metric_count(
                f"{self._prefix}_chunk_cache_evictions_total", evicted
            )
        telemetry.metric_gauge(f"{self._prefix}_chunk_cache_bytes", total)

    def invalidate(self, blob: bytes) -> None:
        key = blob_key(blob)
        with self._lock:
            self._entries.pop(key, None)
            for ck in [k for k in self._chunks if k[0] == key]:
                self._chunk_bytes -= _nbytes(self._chunks.pop(ck))
            size = len(self._entries)
            total = self._chunk_bytes
        telemetry.metric_gauge(f"{self._prefix}_index_cache_entries", size)
        telemetry.metric_gauge(f"{self._prefix}_chunk_cache_bytes", total)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._chunks.clear()
            self._chunk_bytes = 0
        telemetry.metric_gauge(f"{self._prefix}_index_cache_entries", 0)
        telemetry.metric_gauge(f"{self._prefix}_chunk_cache_bytes", 0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "chunk_hits": self.chunk_hits,
                "chunk_misses": self.chunk_misses,
                "chunk_evictions": self.chunk_evictions,
                "chunk_entries": len(self._chunks),
                "chunk_bytes": self._chunk_bytes,
                "max_chunk_bytes": self.max_chunk_bytes,
            }


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A page as a host numpy array, to cross to a worker process (a
    dtype numpy lacks goes as float32, which the chunked engine would cast
    it to anyway)."""
    t = t.detach().cpu()
    if t.dtype not in (torch.float32, torch.float64):
        t = t.to(torch.float32)
    return t.numpy()


# ---------------------------------------------------------------------------
# executor-side work (module-level so ProcessPoolExecutor can pickle them)
# ---------------------------------------------------------------------------

#: per-process decode-state cache for ``executor="process"`` workers — each
#: worker process keeps its own bounded index LRU (the parent's cache object
#: is not shared across fork/spawn boundaries)
_WORKER_CACHE: Optional[DecodeStateCache] = None


def _process_cache() -> DecodeStateCache:
    global _WORKER_CACHE
    if _WORKER_CACHE is None:
        _WORKER_CACHE = DecodeStateCache(max_entries=32)
    return _WORKER_CACHE


def _compress_page(
    arr: Union[torch.Tensor, np.ndarray],
    mode_value: str,
    eb: float,
    candidates: Optional[Sequence[str]],
    chunk_bytes: int,
    device: str,
) -> bytes:
    """Compress one page into a v2 chunked container on ``device`` (executor
    job; a worker process gets the page as a numpy array)."""
    conf = CompressionConfig(mode=ErrorBoundMode(mode_value), eb=eb)
    comp = sz3_chunked(
        candidates=tuple(candidates) if candidates else DEFAULT_CANDIDATES,
        chunk_bytes=chunk_bytes,
        device=device,
    )
    return comp.compress(arr, conf).blob


def _fetch_batch(
    blob: bytes,
    chunks: Sequence[Optional[int]],
    verify: str,
    cache: Optional[DecodeStateCache] = None,
    device: str = "cuda",
    to_host: bool = False,
) -> List[Tuple[Any, ...]]:
    """Decode the requested chunk indices of one container on ``device``
    (executor job).

    ``chunks`` entries are chunk indices, or None for a whole-page decode.
    Returns one entry per request — ``("ok", tensor)`` (a numpy array with
    ``to_host``, as a worker process returns it) or ``("err", type_name,
    message, chunk_index)`` — so a damaged chunk fails only the request that
    asked for it.
    """
    cache = cache if cache is not None else _process_cache()
    try:
        parsed = cache.index_for(blob)
        if verify == "strict":
            if parsed.header.get("itg") and parsed.algo is None:
                raise IntegrityError(
                    "header advertises an integrity trailer but none is "
                    "present (trailer stripped or truncated)",
                    region="trailer",
                )
            if not parsed.header_ok:
                raise IntegrityError(
                    "container header fails its checksum", region="header"
                )
    except ValueError as e:
        # header-level failure: every request targeted this container
        err = ("err", type(e).__name__, str(e), getattr(e, "chunk_index", None))
        return [err for _ in chunks]
    out: List[Tuple[Any, ...]] = []
    for c in chunks:
        try:
            if c is None:
                arr = pl_mod.decompress(blob, verify=verify, device=device)
            else:
                arr = cache.get_chunk(blob, int(c), verify)
                if arr is None:
                    arr = decompress_chunk(
                        blob, int(c), verify=verify, parsed=parsed, device=device
                    )
                    cache.put_chunk(blob, int(c), arr, verify)
            out.append(("ok", arr.cpu().numpy() if to_host else arr))
        except ValueError as e:
            out.append(
                ("err", type(e).__name__, str(e), getattr(e, "chunk_index", None))
            )
    return out


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

@dataclass
class _Request:
    tenant: str
    page: str
    chunk: Optional[int]
    future: "asyncio.Future[torch.Tensor]"
    t_enqueue: float = field(default_factory=time.perf_counter)


_SHUTDOWN = object()


class OffloadService:
    """Async compress/fetch/evict service over named KV pages.

    Parameters
    ----------
    workers:
        Executor pool size (compress and decode jobs share it).
    executor:
        ``"thread"`` (default — numpy/zlib release the GIL, and the decode
        cache is shared in-process) or ``"process"`` (spawned workers, true
        multi-core for pure-Python-bound profiles; each worker keeps its own
        cache and opens its own context on ``device``).
    cache_entries / cache_chunk_bytes:
        Bounds on the decode-state LRU: ``cache_entries`` caps the
        parsed-index layer (one entry is a header dict + chunk table —
        kilobytes — so hundreds are cheap; a miss costs a msgpack parse +
        trailer scan), and ``cache_chunk_bytes`` budgets the decoded-chunk
        layer in bytes (a hot-chunk hit skips the entropy decode entirely —
        the dominant per-fetch cost; 0 disables result caching).
    coalesce_ms / max_batch:
        Fetches arriving within ``coalesce_ms`` of the first are drained
        (up to ``max_batch``) and grouped by page into one executor job per
        page.  Raising ``coalesce_ms`` trades first-byte latency for fewer,
        larger jobs.
    eb / mode / candidates / chunk_bytes:
        Compression policy for :meth:`put` (the v2 chunked engine).
    verify:
        Decode-side verify policy: ``"strict"`` checks the header CRC plus
        the requested chunk's CRC on every fetch (O(chunk), see
        ``decompress_chunk``); ``"off"`` trusts the bytes.
    device:
        Where pages compress and decode, and where fetches return (default
        ``"cuda"``; without a card the service raises unless given
        ``"cpu"``).
    """

    def __init__(
        self,
        workers: int = 4,
        executor: str = "thread",
        cache_entries: int = 64,
        cache_chunk_bytes: int = 32 << 20,
        coalesce_ms: float = 2.0,
        max_batch: int = 32,
        eb: float = 1e-3,
        mode: ErrorBoundMode = ErrorBoundMode.ABS,
        candidates: Optional[Sequence[str]] = None,
        chunk_bytes: int = 1 << 16,
        verify: str = "strict",
        device: pl_mod.Device = "cuda",
    ):
        if executor not in ("thread", "process"):
            raise ValueError("executor must be 'thread' or 'process'")
        if verify not in ("strict", "off"):
            raise ValueError("verify must be 'strict' or 'off'")
        self.workers = max(1, int(workers))
        self.executor_kind = executor
        self.coalesce_ms = float(coalesce_ms)
        self.max_batch = max(1, int(max_batch))
        self.eb = float(eb)
        self.mode = mode
        self.candidates = tuple(candidates) if candidates else None
        self.chunk_bytes = int(chunk_bytes)
        self.verify = verify
        self.device = pl_mod.resolve_device(device)
        self.cache = DecodeStateCache(cache_entries, cache_chunk_bytes)
        self._pages: Dict[Tuple[str, str], bytes] = {}
        self._executor: Optional[Executor] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queue: Optional["asyncio.Queue[Any]"] = None
        self._dispatcher: Optional["asyncio.Task[None]"] = None
        self._deliveries: "set[asyncio.Task[None]]" = set()
        self._closed = False

    # -- lifecycle ----------------------------------------------------------

    def _ensure_started(self) -> asyncio.AbstractEventLoop:
        if self._closed:
            raise RuntimeError("OffloadService is closed")
        loop = asyncio.get_running_loop()
        if self._loop is not loop:
            # first use, or a new asyncio.run() — rebind queue + dispatcher
            self._loop = loop
            self._queue = asyncio.Queue()
            self._dispatcher = loop.create_task(self._dispatch_loop())
        if self._executor is None:
            if self.executor_kind == "process":
                # spawn, not fork: the host process is multithreaded (asyncio,
                # torch) and fork-with-threads can deadlock in the child; a
                # forked child cannot use CUDA either
                self._executor = ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=multiprocessing.get_context("spawn"),
                )
            else:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix="sz3-serve"
                )
        return loop

    async def close(self) -> None:
        """Drain and stop: pending deliveries finish, the dispatcher exits,
        and the executor shuts down.  Pages and caches stay readable via a
        later event loop only by constructing a new service."""
        if self._closed:
            return
        self._closed = True
        if self._dispatcher is not None and self._queue is not None:
            await self._queue.put(_SHUTDOWN)
            try:
                await self._dispatcher
            except asyncio.CancelledError:
                pass
        if self._deliveries:
            await asyncio.gather(*tuple(self._deliveries), return_exceptions=True)
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    async def __aenter__(self) -> "OffloadService":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- requests -----------------------------------------------------------

    async def put(
        self, tenant: str, page: str, data: Union[torch.Tensor, np.ndarray]
    ) -> Dict[str, Any]:
        """Compress ``data`` on the pool, on the service's device, and
        register it as ``(tenant, page)``.

        Returns the offload report: source bytes (the page's OWN dtype),
        container bytes, ratio, and chunk count.
        """
        loop = self._ensure_started()
        t0 = time.perf_counter()
        t = data.detach() if isinstance(data, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(data))
        )
        t = t.to(self.device).contiguous()
        page_arg = _host_array(t) if self.executor_kind == "process" else t
        blob = await loop.run_in_executor(
            self._executor,
            _compress_page,
            page_arg,
            self.mode.value,
            self.eb,
            self.candidates,
            self.chunk_bytes,
            str(self.device),
        )
        return self._register(tenant, page, blob, n_in=_nbytes(t), t0=t0)

    async def put_compressed(
        self, tenant: str, page: str, blob: bytes, n_in: Optional[int] = None
    ) -> Dict[str, Any]:
        """Register a pre-built v2/v4 container as ``(tenant, page)``.

        The framing and header are validated here (malformed containers are
        rejected at admission); chunk *bodies* are not decoded, so a
        fault-injected chunk is accepted and surfaces later, at fetch time,
        to exactly the request that reads it.
        """
        self._ensure_started()
        t0 = time.perf_counter()
        parse_chunked_index(blob, verify="off")  # admission check: framing only
        return self._register(tenant, page, bytes(blob), n_in=n_in, t0=t0)

    def _register(
        self,
        tenant: str,
        page: str,
        blob: bytes,
        n_in: Optional[int],
        t0: float,
    ) -> Dict[str, Any]:
        old = self._pages.get((tenant, page))
        if old is not None:
            self.cache.invalidate(old)
        self._pages[(tenant, page)] = blob
        idx = self.cache.index_for(blob)  # warm the index cache at admission
        dt = time.perf_counter() - t0
        telemetry.metric_count("sz3_serve_puts_total")
        telemetry.metric_observe("sz3_serve_put_seconds", dt)
        telemetry.metric_gauge("sz3_serve_pages", len(self._pages))
        report: Dict[str, Any] = {
            "tenant": tenant,
            "page": page,
            "chunks": idx.n_chunks,
            "n_out": len(blob),
            "seconds": dt,
        }
        if n_in is not None:
            report["n_in"] = int(n_in)
            report["ratio"] = int(n_in) / max(1, len(blob))
        return report

    async def fetch(
        self, tenant: str, page: str, chunk: Optional[int] = None
    ) -> torch.Tensor:
        """Fetch one chunk (or, with ``chunk=None``, the whole page).

        Enqueues into the coalescing dispatcher; resolves with the decoded
        tensor, on the service's device, or raises :class:`OffloadError`
        scoped to this request.
        """
        loop = self._ensure_started()
        key = (tenant, page)
        if key not in self._pages:
            telemetry.metric_count("sz3_serve_errors_total")
            raise OffloadError(
                f"unknown page {tenant}/{page}", tenant=tenant, page=page, chunk=chunk
            )
        req = _Request(tenant, page, chunk, loop.create_future())
        telemetry.metric_gauge_add("sz3_serve_queue_depth", 1)
        assert self._queue is not None
        await self._queue.put(req)
        try:
            return await req.future
        finally:
            telemetry.metric_observe(
                "sz3_serve_request_seconds", time.perf_counter() - req.t_enqueue
            )

    async def evict(self, tenant: str, page: str) -> bool:
        """Drop a page and its cached decode state; True if it existed."""
        self._ensure_started()
        blob = self._pages.pop((tenant, page), None)
        if blob is None:
            return False
        self.cache.invalidate(blob)
        telemetry.metric_count("sz3_serve_evictions_total")
        telemetry.metric_gauge("sz3_serve_pages", len(self._pages))
        return True

    def stats(self) -> Dict[str, Any]:
        return {
            "pages": len(self._pages),
            "index_cache": self.cache.stats(),
            "huffman_table_cache": encoders.table_cache_stats(),
        }

    # -- dispatcher ---------------------------------------------------------

    async def _dispatch_loop(self) -> None:
        assert self._queue is not None
        while True:
            first = await self._queue.get()
            if first is _SHUTDOWN:
                break
            batch: List[_Request] = [first]
            if self.coalesce_ms > 0:
                await asyncio.sleep(self.coalesce_ms / 1000.0)
            while len(batch) < self.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if nxt is _SHUTDOWN:
                    await self._queue.put(_SHUTDOWN)  # re-post for the outer loop
                    break
                batch.append(nxt)
            self._dispatch_batch(batch)

    def _dispatch_batch(self, batch: List[_Request]) -> None:
        assert self._loop is not None
        groups: "OrderedDict[Tuple[str, str], List[_Request]]" = OrderedDict()
        for r in batch:
            groups.setdefault((r.tenant, r.page), []).append(r)
        telemetry.metric_count("sz3_serve_batches_total")
        telemetry.metric_count("sz3_serve_batched_requests_total", len(batch))
        for (tenant, page), reqs in groups.items():
            blob = self._pages.get((tenant, page))
            if blob is None:  # evicted between enqueue and dispatch
                for r in reqs:
                    self._fail(
                        r,
                        OffloadError(
                            f"page {tenant}/{page} evicted while queued",
                            tenant=tenant,
                            page=page,
                            chunk=r.chunk,
                        ),
                    )
                continue
            thread = self.executor_kind == "thread"
            job = self._loop.run_in_executor(
                self._executor,
                _fetch_batch,
                blob,
                [r.chunk for r in reqs],
                self.verify,
                self.cache if thread else None,
                str(self.device),
                not thread,
            )
            task = self._loop.create_task(self._deliver(reqs, job))
            self._deliveries.add(task)
            task.add_done_callback(self._deliveries.discard)

    async def _deliver(self, reqs: List[_Request], job: "asyncio.Future") -> None:
        try:
            results = await job
        except Exception as e:  # executor-level failure (e.g. broken pool)
            for r in reqs:
                self._fail(
                    r,
                    OffloadError(
                        f"fetch job failed: {type(e).__name__}: {e}",
                        tenant=r.tenant,
                        page=r.page,
                        chunk=r.chunk,
                        cause_type=type(e).__name__,
                    ),
                )
            return
        for r, res in zip(reqs, results):
            telemetry.metric_gauge_add("sz3_serve_queue_depth", -1)
            if r.future.done():
                continue
            if res[0] == "ok":
                arr = res[1]
                if isinstance(arr, np.ndarray):  # from a worker process
                    arr = torch.from_numpy(arr).to(self.device)
                r.future.set_result(arr)
            else:
                _tag, cause, msg, chunk_index = res
                telemetry.metric_count("sz3_serve_errors_total")
                r.future.set_exception(
                    OffloadError(
                        f"fetch {r.tenant}/{r.page}"
                        f"[{'*' if r.chunk is None else r.chunk}] failed: "
                        f"{cause}: {msg}",
                        tenant=r.tenant,
                        page=r.page,
                        chunk=r.chunk,
                        cause_type=cause,
                        chunk_index=chunk_index,
                    )
                )

    def _fail(self, r: _Request, err: OffloadError) -> None:
        telemetry.metric_gauge_add("sz3_serve_queue_depth", -1)
        telemetry.metric_count("sz3_serve_errors_total")
        if not r.future.done():
            r.future.set_exception(err)
