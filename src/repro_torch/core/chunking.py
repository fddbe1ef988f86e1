"""Streaming chunked compression with per-chunk adaptive pipeline selection.

The array is split into fixed-byte-budget chunks along the leading axis, and
for EACH chunk the best-fit pipeline is chosen by the paper's sampled
error-estimation criterion (§3.2): a contiguous sample of the chunk is scored
by every candidate's ``estimate_error``, and close calls go to a trial
compression of the sample.  The container is the JAX package's v2 container,
byte for byte, so blobs move freely between the two packages.

Two I/O shapes:

  * one-shot — ``ChunkedCompressor.compress`` returns a self-describing v2
    container: the header records per-chunk (pipeline, offset, length) and
    the body concatenates ordinary v1 blobs, so every chunk is independently
    decodable (random access).
  * streaming — ``compress_stream`` / ``decompress_stream`` iterate frames
    (a prologue + one v1 blob per chunk); ``frames_to_blob`` reassembles the
    exact one-shot container from a frame stream.

Devices: the input is a tensor on the engine's device (``"cuda"`` unless
told otherwise) and its chunks are views of it; each chunk's v1 pipeline
runs on that device, through the kernels where the pipeline routes there.
The contest runs on the HOST copy of each chunk's sample (at most
``SAMPLE_BUDGET`` elements): the estimators are the JAX package's numpy code
and the trial runoff compresses the sample on the CPU's host routes, so the
picks — which decide every byte of a chunk — are the reference's on any
device.  Decode fills an output preallocated on the device, chunk by chunk.

Error-bound semantics: REL bounds are resolved to an ABS bound against the
GLOBAL array statistics before chunking; an iterator of slabs resolves per
slab.  PW_REL needs no global statistics: each chunk's winning Algorithm-1
pipeline is composed with ``preprocess.LogTransform`` (selection scores the
log-domain view of the sample), and the one-shot container is the v4 "pwr"
kind (``PWRelChunkedCompressor``, ``sz3_pwr``).

Parallelism: chunks are independent after the global bound is resolved, so
select+compress and decompress fan out over a ``ThreadPoolExecutor``
(``workers=``).  Results are reassembled in submission order, so parallel
containers and frame streams are byte-identical to serial ones.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    TypeVar,
    Union,
)

import numpy as np
import torch

from . import _msgpack
from . import integrity
from . import pipeline as pl_mod
from . import preprocess as pre_mod
from . import telemetry as tel
from .config import CompressionConfig, ErrorBoundMode
from .integrity import (
    ChunkDamage,
    ContainerError,
    IntegrityError,
    SalvageReport,
    decode_errors,
    guard_count,
    guard_shape,
)
from .pipeline import CompressionResult, pack_container
from .quantizers import to_host

_STREAM_MAGIC = b"SZ3S"
_VERSION2 = 2
_VERSION4 = 4  # pointwise-relative multi-chunk container (kind "pwr")

#: default contest entrants: the three §6.2 pipelines with distinct strengths
DEFAULT_CANDIDATES: Tuple[str, ...] = ("sz3_lorenzo", "sz3_lr", "sz3_interp")

#: elements drawn from each chunk for candidate scoring
SAMPLE_BUDGET = 4096

#: strided probe blocks per chunk sample: a single centred block sees only
#: the middle regime of piecewise data and mis-ranks candidates for the rest
SAMPLE_PROBES = 3

#: candidates whose factory takes ``route=`` (they have kernel routes)
_ROUTED = frozenset(("sz3_lorenzo", "sz3_transform", "sz3_fast", "sz3_aps"))

_T = TypeVar("_T")
_R = TypeVar("_R")


def _parallel_map_ordered(
    fn: Callable[[_T], _R],
    items: Iterable[_T],
    workers: int,
    timeout: Optional[float] = None,
) -> Iterator[_R]:
    """Apply ``fn`` across worker threads, yielding results in input order.

    At most ``2*workers`` tasks are in flight, so streaming callers keep
    their bounded-memory guarantee.  Order is deterministic by construction
    (a result deque, not as-completed), so parallel output is byte-identical
    to serial output.

    ``timeout`` (seconds) bounds the wait for each task's result.  A task
    that blows the budget trips DEGRADED mode: its item — and every item not
    yet submitted — is recomputed serially in the calling thread, queued
    futures are cancelled, and the pool is abandoned without joining.
    Results and their order are identical either way because ``fn`` is pure
    per item.
    """
    if workers <= 1:
        for item in items:
            yield fn(item)
        return
    fn = tel.propagate(fn)
    # CPU-bound tasks: more threads than cores is pure contention, so the
    # pool is clamped (the in-flight window still honours ``workers``)
    pool_size = max(1, min(workers, os.cpu_count() or workers))
    pool = ThreadPoolExecutor(max_workers=pool_size)
    degraded = False
    pending: "collections.deque" = collections.deque()

    def _drain_one() -> _R:
        nonlocal degraded
        fut, item = pending.popleft()
        try:
            return fut.result(timeout)
        except FuturesTimeoutError:
            degraded = True
            fut.cancel()
            return fn(item)

    try:
        items_iter = iter(items)
        while not degraded:
            try:
                item = next(items_iter)
            except StopIteration:
                break
            pending.append((pool.submit(fn, item), item))
            if len(pending) >= 2 * workers:
                yield _drain_one()
        while pending:
            yield _drain_one()
        for item in items_iter:  # non-empty only in degraded mode
            yield fn(item)
    finally:
        pool.shutdown(wait=not degraded, cancel_futures=degraded)


# ---------------------------------------------------------------------------
# chunk geometry
# ---------------------------------------------------------------------------

def chunk_slices(shape: Sequence[int], itemsize: int, chunk_bytes: int) -> List[slice]:
    """Split the leading axis into slabs of at most ``chunk_bytes`` each.

    Returns slices over axis 0.  Inner axes stay whole so every chunk keeps
    the array's dimensionality (predictors see real N-d neighbourhoods).
    """
    if not shape or int(np.prod(shape)) == 0:
        return [slice(0, shape[0] if shape else 0)]
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * itemsize
    rows = max(1, int(chunk_bytes) // max(1, row_bytes))
    n0 = int(shape[0])
    return [slice(i, min(i + rows, n0)) for i in range(0, n0, rows)]


def _sample_block(
    chunk: torch.Tensor, budget: int = SAMPLE_BUDGET, probes: int = SAMPLE_PROBES
) -> torch.Tensor:
    """2-3 strided contiguous probe blocks with ~budget elements in total.

    Contiguity WITHIN each probe keeps neighbour statistics intact, while
    spreading the probes along the chunk's longest axis keeps piecewise-regime
    chunks represented.  Budget unused by short axes is redistributed to the
    long ones (smallest axis first).  Deterministic: the same chunk always
    yields the same sample.  The axis order is numpy's ``argsort`` of the
    shape, as the JAX package takes it, ties included.
    """
    if chunk.numel() <= budget:
        return chunk
    shape = tuple(int(s) for s in chunk.shape)
    takes = [1] * chunk.ndim
    rem = budget
    for i, ax in enumerate(np.argsort(shape)):
        axes_left = chunk.ndim - i
        side = max(1, int(rem ** (1.0 / axes_left) + 1e-9))
        takes[ax] = min(shape[ax], side)
        rem = max(1, rem // takes[ax])
    axl = int(np.argmax(shape))
    k = max(1, int(probes))
    per = max(1, takes[axl] // k)
    if k <= 1 or shape[axl] < k * per + k:
        # probes would overlap — the centred block already covers the chunk
        sl = tuple(slice((dim - t) // 2, (dim - t) // 2 + t) for dim, t in zip(shape, takes))
        return chunk[sl]
    base = [slice((dim - t) // 2, (dim - t) // 2 + t) for dim, t in zip(shape, takes)]
    # probe 0 flush with the start, probe k-1 flush with the end, the rest
    # evenly strided between — piecewise regimes at either edge are seen
    step = (shape[axl] - per) // (k - 1)
    pieces = []
    for i in range(k):
        sl = list(base)
        sl[axl] = slice(i * step, i * step + per)
        pieces.append(chunk[tuple(sl)])
    return torch.cat(pieces, dim=axl)


# ---------------------------------------------------------------------------
# per-chunk pipeline selection (paper §3.2 estimate_error, lifted to pipelines)
# ---------------------------------------------------------------------------

def _make_pipeline(name: str, **kw):
    try:
        factory = pl_mod.PIPELINES[name]
    except KeyError:
        raise KeyError(f"unknown pipeline {name!r}; have {sorted(pl_mod.PIPELINES)}") from None
    return factory(**kw)


def _routed_pipeline(name: str, route: str, device):
    """The candidate ``name`` built on ``device``, with ``route`` where its
    factory takes one (the candidates with kernel routes)."""
    kw: Dict[str, Any] = {"device": device}
    if name in _ROUTED:
        kw["route"] = route
    return _make_pipeline(name, **kw)


#: estimate scores within this factor of the best are "too close to call" and
#: go to a trial-compression runoff on the sample
RUNOFF_MARGIN = 1.3

#: nominal compress throughput per pipeline (MB/s): the ``speed_tier=
#: "throughput"`` cost model's price list, the JAX package's, measured on its
#: benchmark host.  Only RATIOS between entries matter.
PIPELINE_MBPS = {
    "sz3_fast": 200.0,
    "sz3_lorenzo": 25.0,
    "sz3_transform": 25.0,
    "sz3_chunked": 20.0,
    "sz3_lr": 12.0,
    "sz3_interp": 12.0,
    "sz3_hybrid": 9.0,
}
_MBPS_DEFAULT = 12.0

#: assumed downstream bandwidth (MB/s) the compressed bytes must traverse —
#: the exchange rate between code-bits and compute seconds in throughput mode
LINK_MBPS = 100.0

#: below this many estimated bits/element the data is trivially compressible
#: by every close candidate — estimates alone decide, skipping the runoff
TRIVIAL_BITS = 0.05


def _trial_bits(comp, sample: np.ndarray, eff: CompressionConfig) -> float:
    try:
        with tel.suppress_decisions():  # runoff trials are not real outputs
            return 8.0 * len(comp.compress(sample, eff).blob) / max(1, sample.size)
    except Exception:
        return float("inf")


def select_pipeline(
    chunk,
    abs_eb: float,
    conf: CompressionConfig,
    candidates: Sequence[str] = DEFAULT_CANDIDATES,
    pipelines: Optional[Dict[str, Any]] = None,
    speed_tier: str = "ratio",
) -> Tuple[str, Dict[str, float]]:
    """Pick the candidate pipeline with the lowest estimated cost on a sample.

    Two-stage contest, all scores in estimated bits/element:

      1. every candidate's ``estimate_error`` scores the sample; candidates
         scoring beyond ``RUNOFF_MARGIN`` x best are eliminated.
      2. if several finalists remain, the sample is trial-compressed by each
         finalist and measured bytes decide.  Skipped when the best estimate
         is under ``TRIVIAL_BITS``.

    ``chunk`` is a tensor (on any device) or a numpy array; the sample is
    scored on the host.  ``pipelines`` are the instances that score and
    trial-compress it, keyed by name (default: each candidate built on the
    CPU, whose host routes write the JAX package's bytes).  Returns (winner,
    stage-1 scores).

    ``speed_tier="throughput"`` prices each candidate in estimated seconds
    per MB: ``1/PIPELINE_MBPS[name]`` plus the estimated coded size over a
    ``LINK_MBPS`` link, with no trial runoff.
    """
    if len(candidates) == 1:
        return candidates[0], {candidates[0]: 0.0}
    if pipelines is None:
        pipelines = {name: _make_pipeline(name, device="cpu") for name in candidates}
    if not isinstance(chunk, torch.Tensor):
        chunk = torch.from_numpy(np.ascontiguousarray(chunk))
    sample = to_host(_sample_block(chunk))
    eff = conf.replace(mode=ErrorBoundMode.ABS, eb=abs_eb)
    ests: Dict[str, Optional[float]] = {}
    for name in candidates:
        # pipeline-level estimator first (whole-pipeline coders, e.g. the
        # fast tier), else the predictor's (Algorithm-1 pipelines)
        est_fn = getattr(pipelines[name], "estimate_error", None)
        if est_fn is None:
            pred = getattr(pipelines[name], "predictor", None)
            est_fn = pred.estimate_error if pred is not None else None
        ests[name] = est_fn(sample, abs_eb, conf) if est_fn is not None else None
    if speed_tier == "throughput":
        itembits = 8.0 * chunk.element_size()
        costs = {}
        for name in candidates:
            bits = ests[name] if ests[name] is not None else itembits
            ratio_frac = min(1.0, float(bits) / itembits)  # coded MB per raw MB
            mbps = PIPELINE_MBPS.get(name, _MBPS_DEFAULT)
            costs[name] = 1.0 / mbps + ratio_frac / LINK_MBPS
        winner = min(candidates, key=lambda n: (costs[n], candidates.index(n)))
        return winner, costs
    estimated = {k: float(v) for k, v in ests.items() if v is not None}
    finalists = [k for k, v in ests.items() if v is None]  # no estimator -> runoff
    if estimated:
        best = min(estimated.values())
        if best <= TRIVIAL_BITS and not finalists:
            return min(estimated, key=lambda n: (estimated[n], candidates.index(n))), estimated
        finalists += [k for k, v in estimated.items() if v <= best * RUNOFF_MARGIN + 1e-12]
    if len(finalists) == 1:
        return finalists[0], estimated
    runoff = {name: _trial_bits(pipelines[name], sample, eff) for name in finalists}
    winner = min(finalists, key=lambda n: (runoff[n], candidates.index(n)))
    return winner, estimated or runoff


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChunkRecord:
    """Header entry for one chunk of a v2 container."""

    off: int  # byte offset of the chunk's v1 blob within the body
    length: int
    n0: int  # extent along the chunk axis
    pipeline: str  # winning candidate name (observability; blob self-describes)
    extra: Optional[Dict[str, Any]] = None  # e.g. the quality controller's
    # per-chunk achieved record; readers that predate it ignore the key
    sel: Optional[Dict[str, Any]] = None  # selection-decision record
    # (telemetry.sel_header_entry), present only while a trace records

    def to_header(self) -> Dict[str, Any]:
        h = {
            "off": int(self.off),
            "len": int(self.length),
            "n0": int(self.n0),
            "pipeline": self.pipeline,
        }
        if self.extra:
            h["q"] = pl_mod._clean_meta(self.extra)
        if self.sel:
            h["sel"] = pl_mod._clean_meta(self.sel)
        return h


class ChunkedCompressor:
    """Fixed-budget chunking + per-chunk adaptive pipeline selection.

    Runs each chunk through the winning candidate's v1 pipeline, on the
    engine's ``device``; emits the v2 multi-chunk container (or a frame
    stream).  ``route`` goes to the candidates with kernel routes
    (``sz3_lorenzo``, ``sz3_fast``): ``"force"`` runs the kernels' plain
    versions on CPU tensors, as for those pipelines.
    """

    kind = "chunked"
    container_version = _VERSION2

    def __init__(
        self,
        candidates: Sequence[str] = DEFAULT_CANDIDATES,
        chunk_bytes: int = 1 << 22,
        conf: Optional[CompressionConfig] = None,
        workers: int = 1,
        speed_tier: str = "ratio",
        chunk_timeout: Optional[float] = None,
        route: str = "auto",
        device: pl_mod.Device = "cuda",
    ):
        if speed_tier not in ("ratio", "throughput"):
            raise ValueError(f"unknown speed_tier {speed_tier!r}")
        candidates = tuple(candidates)
        if speed_tier == "throughput" and "sz3_fast" not in candidates:
            # the throughput tier prices encode speed, so the fixed-length
            # coder always belongs in the contest
            candidates += ("sz3_fast",)
        self.candidates = candidates
        self.chunk_bytes = int(chunk_bytes)
        self.conf = conf or CompressionConfig()
        self.workers = max(1, int(workers))
        self.speed_tier = speed_tier
        #: seconds each parallel chunk task may take before the engine
        #: degrades to serial compression in the calling thread (None: wait
        #: forever)
        self.chunk_timeout = chunk_timeout
        self.route = route
        self.device = device

    # -- shared per-chunk path ----------------------------------------------
    def _pwr_candidates(self) -> Tuple[str, ...]:
        """Candidates usable under PW_REL: Algorithm-1 pipelines only (they
        have a preprocessor slot to compose LogTransform into; whole-pipeline
        coders like the transform family and truncation are dropped from the
        contest).  Computed once per engine."""
        cached = getattr(self, "_pwr_cands", None)
        if cached is None:
            cached = tuple(
                n for n in self.candidates if hasattr(_make_pipeline(n, device="cpu"), "preprocessor")
            ) or ("sz3_lorenzo",)
            self._pwr_cands = cached
        return cached

    def _chunk_pipeline(self, name: str, device: torch.device):
        return _routed_pipeline(name, self.route, device)

    def _compress_chunk(
        self, chunk: torch.Tensor, abs_eb: float, eff: CompressionConfig
    ) -> Tuple[bytes, str, int, Optional[Dict[str, Any]]]:
        """Select + compress ONE chunk.  Self-contained per call (each task
        builds its own pipeline instances, which hold quantizer state), so
        the function is pure in (chunk, eff) and parallel output is
        byte-identical to serial.  The 4th element is the selection-decision
        info, computed only while a trace records, so the untraced path does
        no extra work and writes containers without ``sel`` entries.

        PW_REL chunks compose ``preprocess.LogTransform`` into the winning
        Algorithm-1 pipeline: selection scores the log-domain view of the
        chunk's sample against the log-domain ABS bound, and the emitted v1
        blob carries the chunk's sign / zero / non-finite side channels in
        its ``pre_meta``."""
        n0 = int(chunk.shape[0] if chunk.ndim else chunk.numel())
        pwr = eff.mode == ErrorBoundMode.PW_REL
        cands = self._pwr_candidates() if pwr else self.candidates
        with tel.span("select"):
            if pwr:
                # log_domain_view is elementwise: this is the sample of the
                # chunk's log view, which select_pipeline keeps whole (a
                # sample fits the budget)
                view = pre_mod.log_domain_view(_sample_block(chunk))
                sel_conf = eff.replace(mode=ErrorBoundMode.ABS, eb=abs_eb)
                name, scores = select_pipeline(view, abs_eb, sel_conf, cands, speed_tier=self.speed_tier)
            else:
                name, scores = select_pipeline(chunk, abs_eb, eff, cands, speed_tier=self.speed_tier)
        comp = self._chunk_pipeline(name, chunk.device)
        if pwr:
            comp.preprocessor = pre_mod.LogTransform()
        if not tel.enabled():
            return comp.compress(chunk, eff).blob, name, n0, None
        with tel.suppress_decisions():
            res = comp.compress(chunk, eff, with_stats=True)
        meta = res.meta or {}
        sel = tel.sel_header_entry(
            cands, scores, name,
            nfail=int(meta.get("nfail", 0)),
            device="device" if meta.get("device") else "host",
        )
        sel["n"] = int(chunk.numel())  # trace-only; stripped before the header
        return res.blob, name, n0, sel

    def _chunk_frames(
        self, data, conf: CompressionConfig
    ) -> Iterator[Tuple[bytes, str, int, Optional[Dict[str, Any]]]]:
        """Yield (v1 blob, pipeline name, axis-0 extent, selection info) per
        chunk, in chunk order."""
        data = pl_mod._as_tensor(data, pl_mod.resolve_device(self.device))
        if conf.mode == ErrorBoundMode.PW_REL:
            # the log-domain ABS bound depends only on eb, so chunked PW_REL
            # output honours the bound alike for arrays and slab iterators
            abs_eb = pre_mod.pw_rel_log_eb(conf.eb)
            eff = conf
        else:
            rng, absmax = pl_mod._finite_stats(data)
            abs_eb = conf.resolve_abs_eb(rng, absmax)
            if abs_eb <= 0:
                abs_eb = float(np.finfo(np.float64).tiny)
            eff = conf.replace(mode=ErrorBoundMode.ABS, eb=abs_eb)
        flat_leading = data.reshape(-1) if data.ndim == 0 else data
        chunks = (
            flat_leading[sl]
            for sl in chunk_slices(
                tuple(flat_leading.shape), flat_leading.element_size(), self.chunk_bytes
            )
        )

        def _one(args: Tuple[int, torch.Tensor]):
            i, chunk = args
            with tel.span("chunk", order=i, bytes=chunk.numel() * chunk.element_size()):
                return self._compress_chunk(chunk, abs_eb, eff)

        engine = tel.chunked_engine_name(self.kind, self.candidates)
        results = _parallel_map_ordered(
            _one, enumerate(chunks), self.workers, timeout=self.chunk_timeout
        )
        for i, (blob, name, n0, sel) in enumerate(results):
            if sel is not None:
                tel.record_decision(tel.make_decision(
                    engine,
                    name,
                    index=i,
                    candidates=sel["cands"],
                    estimates=sel.get("est") or None,
                    est_bits=sel.get("est_bits"),
                    realized_bits=8.0 * len(blob) / max(1, sel["n"]),
                    margin=sel.get("margin"),
                    n_elems=sel["n"],
                    fallbacks=sel["nfail"],
                    device=sel["dev"],
                ))
            yield blob, name, n0, sel

    # -- one-shot v2 container ----------------------------------------------
    def compress(self, data, conf: Optional[CompressionConfig] = None, with_stats: bool = False) -> CompressionResult:
        """Compress a numpy array or torch tensor on this engine's device."""
        conf = conf or self.conf
        data = pl_mod._as_tensor(data, pl_mod.resolve_device(self.device))
        records: List[ChunkRecord] = []
        body_parts: List[bytes] = []
        off = 0
        for blob, name, n0, sel in self._chunk_frames(data, conf):
            sel_hdr = {k: v for k, v in sel.items() if k != "n"} if sel else None
            records.append(ChunkRecord(off, len(blob), n0, name, sel=sel_hdr))
            body_parts.append(blob)
            off += len(blob)
        blob = _assemble_v2(
            tuple(data.shape), pl_mod._DTYPE_STR[data.dtype], records, body_parts, conf,
            kind=self.kind, version=self.container_version,
        )
        meta = {"chunks": [r.to_header() for r in records]}
        return CompressionResult(
            blob=blob,
            ratio=data.numel() * data.element_size() / max(1, len(blob)),
            meta=meta if with_stats else None,
        )


def _assemble_v2(
    shape: Tuple[int, ...],
    dtype: str,
    records: Sequence[ChunkRecord],
    body_parts: Sequence[bytes],
    conf: CompressionConfig,
    kind: str = "chunked",
    version: int = _VERSION2,
    header_extra: Optional[Dict[str, Any]] = None,
) -> bytes:
    """Assemble a multi-chunk container (``dtype`` is numpy's ``dtype.str``).
    ``kind``/``version`` distinguish the generations sharing this layout: v2
    "chunked" (ABS/REL) and v4 "pwr".  ``header_extra`` merges further
    top-level header fields (the quality controller's achieved-quality
    summary); readers ignore fields they do not know."""
    header = {
        "v": int(version),
        "kind": kind,
        "shape": list(shape),
        "dtype": dtype,
        "axis": 0,
        "mode": conf.mode.value,
        "eb": float(conf.eb),
        "chunks": [r.to_header() for r in records],
    }
    if conf.eb_rel is not None:
        header["eb_rel"] = float(conf.eb_rel)
    if header_extra:
        header.update(pl_mod._clean_meta(header_extra))
    # per-chunk checksums in the trailer mirror the header chunk table, so
    # verification can name the damaged chunk and salvage can skip only it
    return pack_container(
        header, b"".join(body_parts), chunk_bounds=[(r.off, r.length) for r in records]
    )


#: default worker count for v2-container decompression through
#: ``pipeline.decompress`` when the caller passes no ``workers``
DECOMPRESS_WORKERS = 1


def decompress_chunked(
    blob: bytes,
    header: Dict[str, Any],
    body_off: int,
    workers: Optional[int] = None,
    verify: str = "strict",
    device: pl_mod.Device = None,
    route: str = "auto",
) -> torch.Tensor:
    """Decode a v2 multi-chunk container (called from pipeline.decompress)
    into an output preallocated on ``device``, filled chunk by chunk.

    Chunks decode on ``workers`` threads; output placement is positional.
    The chunk table is validated against the real body size before any
    slice, and ``verify`` and ``route`` propagate to the nested per-chunk
    decode.
    """
    dev = pl_mod.resolve_device(device)
    workers = DECOMPRESS_WORKERS if workers is None else max(1, int(workers))
    body = pl_mod.container_body(blob, body_off)
    bounds = integrity.chunk_bounds_of(header, len(body))
    nested = "off" if verify == "off" else "strict"
    dtype = pl_mod._torch_dtype(header["dtype"], "dtype")
    shape = guard_shape(header["shape"], dtype.itemsize, "shape")
    if not bounds:
        return torch.zeros(shape, dtype=dtype, device=dev)
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.reshape(-1)
    pos = 0
    parts = _parallel_map_ordered(
        lambda b: pl_mod.decompress(body[b[0] : b[0] + b[1]], verify=nested, device=dev, route=route),
        bounds,
        workers,
    )
    for i, part in enumerate(parts):
        if shape and (part.ndim != len(shape) or tuple(part.shape[1:]) != shape[1:]):
            raise ContainerError(
                f"chunk {i} decodes to shape {tuple(part.shape)}, which does not "
                f"stack into {list(shape)}"
            )
        n = part.numel()
        if pos + n > flat.numel():
            raise ContainerError(f"chunks decode to more than the {flat.numel()} declared elements")
        flat[pos : pos + n] = part.reshape(-1)
        pos += n
    if pos != flat.numel():
        raise ContainerError(f"chunks decode to {pos} of the {flat.numel()} declared elements")
    return out


def salvage_chunked(
    blob: bytes,
    header: Dict[str, Any],
    body_off: int,
    workers: Optional[int] = None,
    inspect_result: Optional[integrity.VerifyResult] = None,
    device: pl_mod.Device = None,
) -> Tuple[torch.Tensor, SalvageReport]:
    """``verify="salvage"`` for v2 containers: decode every intact chunk
    byte-exact, zero-fill the damaged ones, and report both sets.

    A chunk is damaged when the trailer's per-chunk checksum says so (reason
    ``"checksum"`` — its decode is not even attempted) or, absent a usable
    trailer, when its nested decode raises a ``ValueError`` (reason
    ``"decode-error"``).  The header itself must be intact, which the caller
    (``pipeline._decompress_salvage``) has already enforced.
    """
    dev = pl_mod.resolve_device(device)
    res = inspect_result
    if res is None:
        res = integrity.inspect(blob, header, body_off)
    workers = DECOMPRESS_WORKERS if workers is None else max(1, int(workers))
    body = pl_mod.container_body(blob, body_off)
    with decode_errors("chunked container"):
        dtype = pl_mod._torch_dtype(header["dtype"], "dtype")
        shape = guard_shape(header["shape"], dtype.itemsize, "shape")
        bounds = integrity.chunk_bounds_of(header, len(body))
        lead = int(shape[0]) if shape else 1
        inner = tuple(shape[1:])
        n0s: List[int] = []
        budget = lead
        for i, c in enumerate(header["chunks"] if bounds else []):
            n0 = guard_count(c.get("n0") if isinstance(c, dict) else None, budget, f"chunk {i} n0")
            n0s.append(n0)
            budget -= n0
    row = int(np.prod(inner, dtype=np.int64)) if inner else 1
    bad = set(res.bad_chunks or []) if res.has_trailer else set()
    report = SalvageReport(total_chunks=len(bounds), checksummed=res.has_trailer)

    def _decode_one(args):
        i, (off, ln) = args
        if i in bad:
            return None, "checksum"
        try:
            with decode_errors(f"chunk {i}"):
                part = pl_mod.decompress(body[off : off + ln], verify="strict", device=dev)
            return part, None
        except ValueError:
            return None, "decode-error"

    results = list(_parallel_map_ordered(_decode_one, enumerate(bounds), workers))
    out = torch.zeros((lead,) + inner, dtype=dtype, device=dev)
    r0 = 0
    for i, ((part, reason), n0) in enumerate(zip(results, n0s)):
        if part is not None and reason is None:
            if part.numel() == n0 * row:
                out[r0 : r0 + n0] = part.to(dtype).reshape((n0,) + inner)
                report.recovered.append(i)
            else:
                reason = "decode-error"
        if reason is not None:
            report.damage.append(ChunkDamage(i, r0 * row, (r0 + n0) * row, reason))
        r0 += n0
    return out.reshape(shape), report


@dataclasses.dataclass(frozen=True)
class ChunkedIndex:
    """Parsed random-access state for one v2/v4 container: the msgpack
    header, validated chunk bounds, and the trailer's per-chunk CRCs (when
    present).  Build once with :func:`parse_chunked_index`, then pass to
    repeated :func:`decompress_chunk` calls."""

    header: Dict[str, Any]
    body_off: int
    body_len: int
    bounds: Tuple[Tuple[int, int], ...]
    kind: str
    algo: Optional[str]  # trailer checksum algorithm, None without trailer
    chunk_crcs: Optional[Tuple[int, ...]]
    header_ok: bool  # header CRC verified (True when no trailer to check)

    @property
    def n_chunks(self) -> int:
        return len(self.bounds)


def parse_chunked_index(blob: bytes, verify: str = "strict") -> ChunkedIndex:
    """Parse the header + chunk table + trailer CRCs of a v2/v4 container.

    Under ``verify="strict"`` the header CRC is checked here, once, and a
    container whose header advertises a trailer (``itg``) that is missing
    raises.  Per-chunk CRCs are carried in the returned index but NOT checked
    here; :func:`decompress_chunk` checks only the requested chunk's.
    """
    if verify not in pl_mod.VERIFY_MODES:
        raise ValueError(f"verify must be one of {pl_mod.VERIFY_MODES}")
    with decode_errors("chunked container"):
        header, body_off = pl_mod.parse_header(blob)
        if header.get("v", 1) < _VERSION2 or header.get("kind") not in ("chunked", "pwr"):
            raise ContainerError("not a chunked (v2) or pwr (v4) container")
        body_len = len(pl_mod.container_body(blob, body_off))
        bounds = tuple(integrity.chunk_bounds_of(header, body_len))
        tr = integrity.read_trailer(blob)
        algo: Optional[str] = None
        crcs: Optional[Tuple[int, ...]] = None
        header_ok = True
        if tr is not None and tr.start == body_off + body_len:
            algo = tr.algo
            header_ok = integrity.checksum(blob[:body_off], algo=tr.algo) == tr.header_crc
            if len(tr.chunk_crcs) == len(bounds):
                crcs = tr.chunk_crcs
        elif header.get("itg") and verify == "strict":
            raise IntegrityError(
                "header advertises an integrity trailer but none is present "
                "(trailer stripped or truncated)",
                region="trailer",
            )
        if verify == "strict" and not header_ok:
            raise IntegrityError("container header fails its checksum", region="header")
        return ChunkedIndex(
            header=header,
            body_off=body_off,
            body_len=body_len,
            bounds=bounds,
            kind=header.get("kind"),
            algo=algo,
            chunk_crcs=crcs,
            header_ok=header_ok,
        )


def decompress_chunk(
    blob: bytes,
    index: int,
    verify: str = "strict",
    parsed: Optional[ChunkedIndex] = None,
    device: pl_mod.Device = None,
) -> torch.Tensor:
    """Random access: decode only chunk ``index`` of a v2 container, on
    ``device``.

    O(chunk): under ``verify="strict"`` only the header CRC (checked at parse
    time) and the requested chunk's CRC are validated.  When the outer
    per-chunk CRC matches, the nested blob's own verification is skipped;
    trailer-less containers fall back to the nested blob's strict path.
    ``parsed`` amortizes header/trailer parsing across reads.
    """
    if parsed is None:
        parsed = parse_chunked_index(blob, verify=verify)
    with decode_errors("chunked container"):
        off, ln = parsed.bounds[index]  # IndexError -> ContainerError
        lo = parsed.body_off + off
        chunk = blob[lo : lo + ln]
        nested = verify
        if verify == "strict" and parsed.chunk_crcs is not None:
            if not parsed.header_ok:
                raise IntegrityError("container header fails its checksum", region="header")
            if integrity.checksum(chunk, algo=parsed.algo) != parsed.chunk_crcs[index]:
                raise IntegrityError(
                    f"container chunk {index} fails its checksum", chunk_index=index
                )
            nested = "off"
        return pl_mod.decompress(chunk, verify=nested, device=device)


# ---------------------------------------------------------------------------
# streaming API (bounded memory)
# ---------------------------------------------------------------------------

def compress_stream(
    data: Union[np.ndarray, torch.Tensor, Iterable[Any]],
    conf: Optional[CompressionConfig] = None,
    candidates: Sequence[str] = DEFAULT_CANDIDATES,
    chunk_bytes: int = 1 << 22,
    workers: int = 1,
    device: pl_mod.Device = "cuda",
) -> Iterator[bytes]:
    """Yield a prologue frame, then one self-describing v1 blob per chunk.

    ``data`` may be an array or tensor (re-chunked by byte budget, bound
    resolved globally — the stream then reassembles bit-identically into the
    one-shot v2 container via :func:`frames_to_blob`) or an iterable of slabs
    (each slab is chunked independently as it arrives; REL bounds resolve
    per slab).  Chunks compress on ``device``.
    """
    conf = conf or CompressionConfig()
    eng = ChunkedCompressor(
        candidates=candidates, chunk_bytes=chunk_bytes, conf=conf, workers=workers, device=device
    )
    prologue = _STREAM_MAGIC + _msgpack.packb(
        {"v": _VERSION2, "axis": 0, "mode": conf.mode.value, "eb": float(conf.eb)}
    )
    yield prologue
    slabs = [data] if isinstance(data, (np.ndarray, torch.Tensor)) else data
    for slab in slabs:
        for blob, _name, _n0, _sel in eng._chunk_frames(slab, conf):
            yield blob


def decompress_stream(
    frames: Iterable[bytes], workers: int = 1, verify: str = "strict", device: pl_mod.Device = None
) -> Iterator[Any]:
    """Inverse of :func:`compress_stream`: yield one decoded tensor per chunk.

    Tolerates a missing prologue (a bare sequence of v1/v2 blobs works too).
    ``verify`` is applied per frame; ``"salvage"`` yields ``(data,
    SalvageReport)`` pairs instead of bare tensors.
    """
    payload = (f for f in frames if f[:4] != _STREAM_MAGIC)
    yield from _parallel_map_ordered(
        lambda f: pl_mod.decompress(f, verify=verify, device=device),
        payload,
        max(1, int(workers)),
    )


def frames_to_blob(frames: Iterable[bytes]) -> bytes:
    """Assemble a frame stream into the one-shot v2 container.

    Only compressed blobs are held; raw data is never materialized.  The
    result is byte-identical to ``ChunkedCompressor.compress(x).blob`` when
    the stream came from the same array/config with the DEFAULT candidate
    set.  Frames carry no rank information, so a 0-d input reassembles (and
    decodes) as shape ``(1,)``.
    """
    records: List[ChunkRecord] = []
    parts: List[bytes] = []
    off = 0
    mode, eb = ErrorBoundMode.ABS.value, None
    shape0 = 0
    inner: Optional[Tuple[int, ...]] = None
    dtype = np.dtype(np.float32).str
    for frame in frames:
        if frame[:4] == _STREAM_MAGIC:
            meta = _msgpack.unpackb(frame[4:])
            mode = meta.get("mode", mode)
            if meta.get("eb") is not None:
                eb = float(meta["eb"])
            continue
        h, _ = pl_mod.parse_header(frame)
        cshape = tuple(h["shape"])
        n0 = int(cshape[0]) if cshape else 1
        if inner is None:
            inner = cshape[1:]
            dtype = np.dtype(h["dtype"]).str
        elif cshape[1:] != inner:
            raise ValueError(f"inconsistent chunk shapes in stream: {cshape[1:]} vs {inner}")
        records.append(ChunkRecord(off, len(frame), n0, _pipeline_name_from_spec(h["spec"])))
        parts.append(frame)
        off += len(frame)
        shape0 += n0
    conf = CompressionConfig(mode=ErrorBoundMode(mode), eb=1e-3 if eb is None else eb)
    pwr = conf.mode == ErrorBoundMode.PW_REL
    return _assemble_v2(
        (shape0,) + (inner or ()), dtype, records, parts, conf,
        kind="pwr" if pwr else "chunked",
        version=_VERSION4 if pwr else _VERSION2,
    )


def _pipeline_name_from_spec(spec: Dict[str, Any]) -> str:
    """Recover the factory name a v1 blob was produced by (best effort)."""
    kind = spec.get("kind")
    if kind in ("truncation", "transform", "hybrid", "fast"):
        return f"sz3_{kind}"
    pred = spec.get("predictor")
    if pred == "composite":
        return "sz3_lr"
    if pred == "interp":
        return "sz3_interp"
    if pred == "lorenzo":
        return "sz3_lorenzo"
    if pred == "pattern":
        if spec.get("quantizer") == "unpred_aware":
            return "sz3_pastri"
        return "sz_pastri" if spec.get("lossless") == "none" else "sz_pastri_zstd"
    return str(spec.get("kind", "sz3"))


def write_frames(frames: Iterable[bytes], fp) -> int:
    """Length-prefix frames onto a binary file object; returns bytes written."""
    total = 0
    for frame in frames:
        fp.write(np.asarray([len(frame)], np.int64).tobytes())
        fp.write(frame)
        total += 8 + len(frame)
    return total


def read_frames(fp) -> Iterator[bytes]:
    """Inverse of :func:`write_frames`.  Hostile length prefixes are rejected
    before the read."""
    while True:
        head = fp.read(8)
        if len(head) < 8:
            return
        n = int(np.frombuffer(head, np.int64)[0])
        if n < 0 or n > integrity.MAX_OUTPUT_BYTES:
            raise ContainerError(f"corrupt frame stream: frame length {n}")
        frame = fp.read(n)
        if len(frame) != n:
            raise ContainerError("truncated frame stream")
        yield frame


def sz3_chunked(
    candidates: Sequence[str] = DEFAULT_CANDIDATES,
    chunk_bytes: int = 1 << 22,
    workers: int = 1,
    **kw,
) -> ChunkedCompressor:
    """Named factory, registered alongside the paper pipelines; ``kw`` goes
    to :class:`ChunkedCompressor` (``conf``, ``speed_tier``, ``route``,
    ``device``, ...)."""
    return ChunkedCompressor(candidates=candidates, chunk_bytes=chunk_bytes, workers=workers, **kw)


# ---------------------------------------------------------------------------
# first-class pointwise-relative pipeline (v4 container)
# ---------------------------------------------------------------------------

class PWRelChunkedCompressor(ChunkedCompressor):
    """Pointwise-relative chunked engine: ``|x_i - x_hat_i| <= eb * |x_i|``
    holds for every finite nonzero element, zeros reconstruct exactly, and
    non-finite values round-trip bit-exact.

    Each chunk is compressed by the winning Algorithm-1 pipeline composed
    with ``preprocess.LogTransform`` (per-chunk sign / zero / non-finite side
    channels travel in the chunk blob's ``pre_meta``), and the container
    carries the v4 "pwr" tag."""

    kind = "pwr"
    container_version = _VERSION4

    def __init__(
        self,
        candidates: Sequence[str] = DEFAULT_CANDIDATES,
        chunk_bytes: int = 1 << 22,
        conf: Optional[CompressionConfig] = None,
        workers: int = 1,
        **kw,
    ):
        super().__init__(
            candidates=candidates,
            chunk_bytes=chunk_bytes,
            conf=conf or CompressionConfig(mode=ErrorBoundMode.PW_REL, eb=1e-3),
            workers=workers,
            **kw,
        )

    def compress(self, data, conf: Optional[CompressionConfig] = None, with_stats: bool = False) -> CompressionResult:
        conf = conf or self.conf
        if conf.mode != ErrorBoundMode.PW_REL:
            raise ValueError(
                "sz3_pwr compresses pointwise-relative bounds only; got mode "
                f"{conf.mode.value!r} (use sz3_chunked for ABS/REL)"
            )
        return super().compress(data, conf, with_stats)


def sz3_pwr(
    eb: float = 1e-3,
    candidates: Sequence[str] = DEFAULT_CANDIDATES,
    chunk_bytes: int = 1 << 22,
    workers: int = 1,
    **kw,
) -> PWRelChunkedCompressor:
    """First-class pointwise-relative pipeline (v4 "pwr" container); ``kw``
    goes to :class:`ChunkedCompressor` (``conf``, ``route``, ``device``,
    ...)."""
    return PWRelChunkedCompressor(
        candidates=candidates,
        chunk_bytes=chunk_bytes,
        workers=workers,
        conf=kw.pop("conf", None) or CompressionConfig(mode=ErrorBoundMode.PW_REL, eb=eb),
        **kw,
    )


# register with the named-pipeline table (PIPELINES lives in pipeline.py;
# chunking imports pipeline, so registration happens here to avoid a cycle)
pl_mod.PIPELINES["sz3_chunked"] = sz3_chunked
pl_mod.PIPELINES["sz3_pwr"] = sz3_pwr
