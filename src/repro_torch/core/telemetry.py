"""Telemetry spine: stage spans, counters, streaming histograms, decisions.

The JAX package's ``repro.core.telemetry``, ported whole, so a port trace
reads as a reference trace does.  Three layers, cheapest first:

  * **Stage spans** — nestable timed scopes named after the pipeline stages
    (``predict``, ``quantize``, ``huffman``, ``lossless``, ``integrity``,
    ``device_transfer``) recorded into a context-var-scoped :class:`Trace`.
    When no trace is active, :func:`span` returns a module-level no-op
    singleton: the disabled path is one ``ContextVar.get`` plus a comparison.
    The port's stages launch asynchronous CUDA work, so while a trace
    records, a span synchronises the current CUDA stream at exit (where
    CUDA is initialised): its seconds include the stage's device time, not
    just its launch time.  Every span waits, host-only ones too, and
    parallel chunk workers share the default stream, so at ``workers > 1``
    a span also waits for the work other chunks queued there: its seconds
    are then an upper bound on its stage's own, not the stage's device
    time.  With tracing off nothing synchronises.
  * **Selection-decision records** — every engine that runs a contest
    (per-chunk pipeline selection, per-block predictor tags, constant-vs-
    fixed-length) emits a schema-pinned record of who contested, who won,
    estimated vs realized code-bits, margin, fallback counts and
    device-vs-host routing.  :func:`explain` retrieves them from a live
    :class:`Trace` or reconstructs them from a container blob's header.
  * **Global serving metrics** — always-on monotonic counters and streaming
    histograms (p50/p90/p99 without storing samples) in a process-wide
    registry, exported as a Prometheus text page for the serving layer.

Parallel chunk workers record into the same trace: worker threads start with
an empty ``contextvars`` context, so :func:`propagate` captures the active
trace at submit time and re-binds it inside the worker.  Per-chunk spans
carry an ``order`` attribute and the exporters sort siblings by it, so a
parallel run's trace tree is deterministic and identical to the serial one.
"""
from __future__ import annotations

import contextvars
import json
import logging
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import torch

__all__ = [
    "Span",
    "Trace",
    "StreamingHistogram",
    "trace",
    "current",
    "enabled",
    "span",
    "count",
    "observe",
    "record_decision",
    "suppress_decisions",
    "propagate",
    "make_decision",
    "validate_decision",
    "explain",
    "trace_summary",
    "metric_count",
    "metric_observe",
    "metric_gauge",
    "metric_gauge_add",
    "prometheus_text",
    "reset_metrics",
    "get_logger",
    "STAGES",
]

#: canonical stage-span names (engines may add engine-specific ones, e.g.
#: "chunk"/"select"/"leaf"; exporters treat any name uniformly)
STAGES = (
    "predict", "quantize", "huffman", "lossless", "integrity", "device_transfer",
)

LOG_LEVEL_ENV = "SZ3J_LOG_LEVEL"


# ---------------------------------------------------------------------------
# streaming histogram (p50/p90/p99 without storing samples)
# ---------------------------------------------------------------------------

class StreamingHistogram:
    """Log-bucketed histogram: quantiles without retaining samples.

    Buckets are sub-octaves of powers of two — ``BUCKETS_PER_OCTAVE``
    sub-buckets per factor-of-2, i.e. bucket ``i`` covers
    ``[2**(i/16), 2**((i+1)/16))`` — so any quantile is recovered to within
    a relative error of ``2**(1/16) - 1`` (~4.4%) regardless of the value
    range, and the bucket table stays sparse (a dict keyed by index).
    Non-positive observations land in a dedicated zero bucket.  All methods
    are thread-safe.
    """

    BUCKETS_PER_OCTAVE = 16
    _LOG2_SCALE = BUCKETS_PER_OCTAVE  # index = floor(16 * log2(v))

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._zero = 0  # observations <= 0
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.n += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            if v <= 0.0:
                self._zero += 1
                return
            idx = math.floor(self._LOG2_SCALE * math.log2(v))
            self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def merge(self, other: "StreamingHistogram") -> None:
        with other._lock:
            buckets = dict(other._buckets)
            zero, n, total = other._zero, other.n, other.total
            vmin, vmax = other.vmin, other.vmax
        with self._lock:
            for idx, c in buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + c
            self._zero += zero
            self.n += n
            self.total += total
            self.vmin = min(self.vmin, vmin)
            self.vmax = max(self.vmax, vmax)

    def quantile(self, q: float) -> float:
        """Approximate ``q``-quantile (0 <= q <= 1); NaN when empty."""
        with self._lock:
            if self.n == 0:
                return math.nan
            rank = q * (self.n - 1)
            seen = self._zero
            if rank < seen:
                return max(0.0, self.vmin)
            for idx in sorted(self._buckets):
                seen += self._buckets[idx]
                if rank < seen:
                    # geometric bucket midpoint, clamped to the observed range
                    mid = 2.0 ** ((idx + 0.5) / self._LOG2_SCALE)
                    return min(max(mid, self.vmin), self.vmax)
            return self.vmax

    def snapshot(self) -> Dict[str, float]:
        empty = self.n == 0
        return {
            "count": self.n,
            "sum": self.total,
            "min": None if empty else self.vmin,
            "max": None if empty else self.vmax,
            "p50": None if empty else self.quantile(0.50),
            "p90": None if empty else self.quantile(0.90),
            "p99": None if empty else self.quantile(0.99),
        }


# ---------------------------------------------------------------------------
# spans and traces
# ---------------------------------------------------------------------------

class Span:
    """One timed scope.  Created via :func:`span`; use as a context manager."""

    __slots__ = ("name", "attrs", "children", "seconds", "_trace", "_t0", "_token")

    def __init__(self, name: str, attrs: Dict[str, Any], trace: "Trace"):
        self.name = name
        self.attrs = attrs
        self.children: List["Span"] = []
        self.seconds: float = 0.0
        self._trace = trace
        self._t0 = 0.0
        self._token = None

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self._trace
        parent = tr._span_var.get() or tr.root
        with tr._lock:
            parent.children.append(self)
        self._token = tr._span_var.set(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if torch.cuda.is_initialized():
            # the stage's kernels are queued, not done: wait for them, so
            # the span times the work and not its launch (with everything
            # else queued on the stream, other workers' chunks included)
            torch.cuda.current_stream().synchronize()
        self.seconds = time.perf_counter() - self._t0
        self._trace._span_var.reset(self._token)
        return False

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "seconds": self.seconds}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in _ordered(self.children)]
        return d


def _ordered(children: Sequence[Span]) -> List[Span]:
    """Deterministic sibling order: spans carrying an ``order`` attribute
    (parallel chunk workers) sort by it; the rest keep insertion order after
    them.  A serial run and a parallel run therefore export the same tree."""
    return sorted(
        children,
        key=lambda s: (0, s.attrs["order"]) if "order" in s.attrs else (1, 0),
    )


class _NoopSpan:
    """Singleton returned by :func:`span` when no trace is active."""

    __slots__ = ()
    seconds = 0.0

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class Trace:
    """A tree of stage spans plus counters, histograms and decision records.

    Activate with ``with telemetry.trace() as tr:`` — every :func:`span`,
    :func:`count`, :func:`observe` and :func:`record_decision` inside the
    block (including worker threads entered via :func:`propagate`) lands in
    ``tr``.  Traces may nest; the innermost active trace receives events.
    """

    def __init__(self, name: str = "trace"):
        self.name = name
        self.root = Span("root", {}, self)
        self._lock = threading.Lock()
        # current open span, per thread/context — worker threads start fresh
        # (empty context), so their spans parent onto the root
        self._span_var: contextvars.ContextVar[Optional[Span]] = (
            contextvars.ContextVar(f"sz3t_span_{id(self)}", default=None)
        )
        self.counters: Dict[str, float] = {}
        self.histograms: Dict[str, StreamingHistogram] = {}
        self.decisions: List[Dict[str, Any]] = []
        self.seconds = 0.0
        self._t0 = 0.0

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **attrs: Any) -> Span:
        return Span(name, attrs, self)

    def count(self, name: str, inc: Union[int, float] = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + inc

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self.histograms.get(name)
            if hist is None:
                hist = self.histograms[name] = StreamingHistogram()
        hist.observe(value)

    def record_decision(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self.decisions.append(rec)

    # -- export -------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "seconds": self.seconds,
            "spans": [c.to_dict() for c in _ordered(self.root.children)],
            "counters": dict(sorted(self.counters.items())),
            "histograms": {
                k: self.histograms[k].snapshot() for k in sorted(self.histograms)
            },
            "decisions": list(self.decisions),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))

    def stage_totals(self) -> Dict[str, Dict[str, float]]:
        """Aggregate spans by name across the whole tree: calls, seconds,
        bytes (where spans carry a ``bytes`` attribute) and MB/s."""
        agg: Dict[str, Dict[str, float]] = {}

        def walk(s: Span) -> None:
            for c in s.children:
                row = agg.setdefault(c.name, {"calls": 0, "seconds": 0.0, "bytes": 0})
                row["calls"] += 1
                row["seconds"] += c.seconds
                row["bytes"] += int(c.attrs.get("bytes", 0))
                walk(c)

        walk(self.root)
        for row in agg.values():
            row["MBps"] = (
                row["bytes"] / 1e6 / row["seconds"]
                if row["bytes"] and row["seconds"] > 0
                else 0.0
            )
        return agg

    def summary(self) -> str:
        """Human-readable per-stage table (see :func:`trace_summary`)."""
        agg = self.stage_totals()
        total = self.seconds or sum(r["seconds"] for r in agg.values()) or 1e-12
        lines = [
            f"trace {self.name!r}: {self.seconds * 1e3:.2f} ms, "
            f"{len(self.decisions)} decisions",
            f"{'stage':<16s} {'calls':>6s} {'total ms':>10s} {'share':>7s} {'MB/s':>9s}",
        ]
        for name in sorted(agg, key=lambda n: -agg[n]["seconds"]):
            row = agg[name]
            mbps = f"{row['MBps']:.1f}" if row["MBps"] else "-"
            lines.append(
                f"{name:<16s} {row['calls']:>6d} {row['seconds'] * 1e3:>10.2f} "
                f"{100.0 * row['seconds'] / total:>6.1f}% {mbps:>9s}"
            )
        for cname in sorted(self.counters):
            lines.append(f"counter {cname} = {self.counters[cname]:g}")
        return "\n".join(lines)


_trace_var: contextvars.ContextVar[Optional[Trace]] = contextvars.ContextVar(
    "sz3t_trace", default=None
)
_suppress_var: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "sz3t_suppress_decisions", default=False
)


class _SuppressScope:
    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _suppress_var.set(True)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _suppress_var.reset(self._token)
        return False


def suppress_decisions() -> _SuppressScope:
    """Mute :func:`record_decision` inside the scope (spans still record).

    Engines wrap *internal* compressions — selection trial runoffs, the
    quality controller's bisection probes, a chunk winner's nested engine —
    so the decision stream carries exactly one authoritative record per
    contest, emitted in deterministic (chunk) order by the driver, never
    from racing worker threads."""
    return _SuppressScope()


class _TraceScope:
    """Context manager returned by :func:`trace`."""

    __slots__ = ("_trace", "_token")

    def __init__(self, tr: Trace):
        self._trace = tr
        self._token = None

    def __enter__(self) -> Trace:
        self._token = _trace_var.set(self._trace)
        self._trace._t0 = time.perf_counter()
        return self._trace

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._trace.seconds = time.perf_counter() - self._trace._t0
        _trace_var.reset(self._token)
        return False


def trace(name: str = "trace") -> _TraceScope:
    """``with telemetry.trace("compress") as tr:`` — activate a new trace."""
    return _TraceScope(Trace(name))


def current() -> Optional[Trace]:
    """The active trace in this context, or None."""
    return _trace_var.get()


def enabled() -> bool:
    """True when a trace is active (call sites guard non-trivial work on it)."""
    return _trace_var.get() is not None


def span(name: str, **attrs: Any):
    """Open a stage span on the active trace; no-op singleton when disabled."""
    tr = _trace_var.get()
    if tr is None:
        return _NOOP_SPAN
    return Span(name, attrs, tr)


def count(name: str, inc: Union[int, float] = 1) -> None:
    tr = _trace_var.get()
    if tr is not None:
        tr.count(name, inc)


def observe(name: str, value: float) -> None:
    tr = _trace_var.get()
    if tr is not None:
        tr.observe(name, value)


def record_decision(rec: Dict[str, Any]) -> None:
    tr = _trace_var.get()
    if tr is not None and not _suppress_var.get():
        tr.record_decision(rec)


def propagate(fn: Callable) -> Callable:
    """Bind the caller's active trace into worker threads.

    ``contextvars`` do NOT flow into ``ThreadPoolExecutor`` workers (each
    thread starts with an empty context), so a pool would silently drop all
    telemetry.  Wrap the task function with this at submit time; when no
    trace is active the function is returned unchanged (zero overhead)."""
    tr = _trace_var.get()
    if tr is None:
        return fn

    def wrapped(*args, **kw):
        token = _trace_var.set(tr)
        try:
            return fn(*args, **kw)
        finally:
            _trace_var.reset(token)

    return wrapped


def trace_summary(tr: Optional[Trace] = None) -> str:
    """Human table for ``tr`` (default: the active trace)."""
    tr = tr or _trace_var.get()
    if tr is None:
        return "no active trace"
    return tr.summary()


# ---------------------------------------------------------------------------
# selection-decision records (schema-pinned; see tests/test_telemetry.py)
# ---------------------------------------------------------------------------

#: field -> (accepted types, required).  ``None`` is additionally accepted
#: for every non-required field.  The schema is PINNED by a test: adding a
#: field means updating the test, the README and any downstream reader.
DECISION_SCHEMA: Dict[str, tuple] = {
    "engine": ((str,), True),
    "scope": ((str,), True),       # "chunk" | "block-summary" | "array" | "leaf"
    "index": ((int,), True),
    "candidates": ((list, tuple), True),
    "winner": ((str,), True),
    "estimates": ((dict,), False),    # candidate -> stage-1 score (bits/elem
    #                                   or cost s/MB in throughput mode)
    "est_bits": ((int, float), False),  # winner's estimated bits/element
    "realized_bits": ((int, float), False),  # 8*len(blob)/n_elems, measured
    "margin": ((int, float), False),  # runner-up score / winner score (>= 1)
    "n_elems": ((int,), True),
    "fallbacks": ((int,), True),   # fail-channel / unpredictable count
    "device": ((str,), True),      # "host" | "device"
    "extra": ((dict,), False),     # engine-specific payload (e.g. quality rec)
}


def make_decision(
    engine: str,
    winner: str,
    *,
    scope: str = "chunk",
    index: int = 0,
    candidates: Sequence[str] = (),
    estimates: Optional[Dict[str, float]] = None,
    est_bits: Optional[float] = None,
    realized_bits: Optional[float] = None,
    margin: Optional[float] = None,
    n_elems: int = 0,
    fallbacks: int = 0,
    device: str = "host",
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build a schema-complete selection-decision record."""
    return {
        "engine": str(engine),
        "scope": str(scope),
        "index": int(index),
        "candidates": [str(c) for c in candidates] or [str(winner)],
        "winner": str(winner),
        "estimates": (
            {str(k): float(v) for k, v in estimates.items()} if estimates else None
        ),
        "est_bits": None if est_bits is None else float(est_bits),
        "realized_bits": None if realized_bits is None else float(realized_bits),
        "margin": None if margin is None else float(margin),
        "n_elems": int(n_elems),
        "fallbacks": int(fallbacks),
        "device": str(device),
        "extra": dict(extra) if extra else None,
    }


def validate_decision(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Raise ``ValueError`` unless ``rec`` matches the pinned schema exactly
    (no missing required fields, no unknown fields, right types)."""
    unknown = set(rec) - set(DECISION_SCHEMA)
    if unknown:
        raise ValueError(f"unknown decision fields: {sorted(unknown)}")
    for field, (types, required) in DECISION_SCHEMA.items():
        if field not in rec or rec[field] is None:
            if required:
                raise ValueError(f"decision missing required field {field!r}")
            continue
        if not isinstance(rec[field], types):
            raise ValueError(
                f"decision field {field!r}: expected {types}, got "
                f"{type(rec[field]).__name__}"
            )
    if rec["winner"] not in rec["candidates"]:
        raise ValueError(
            f"winner {rec['winner']!r} not among candidates {rec['candidates']}"
        )
    return rec


def margin_of(scores: Dict[str, float], winner: str) -> Optional[float]:
    """Runner-up score / winner score (>= 1: how contested the win was)."""
    if winner not in scores or len(scores) < 2:
        return None
    w = scores[winner]
    runner = min(v for k, v in scores.items() if k != winner)
    if not math.isfinite(runner) or not math.isfinite(w):
        return None
    return runner / w if w > 0 else None


def sel_header_entry(
    candidates: Sequence[str],
    scores: Dict[str, float],
    winner: str,
    nfail: int,
    device: str,
) -> Dict[str, Any]:
    """Compact, msgpack-clean form of a decision embedded in a v2/v4 chunk
    table (key ``"sel"``).  Written only when a trace is active at compress
    time, so default-path containers stay byte-identical to the frame-stream
    reassembly (pinned by tests)."""
    entry: Dict[str, Any] = {
        "cands": [str(c) for c in candidates],
        "est": {k: round(float(v), 4) for k, v in scores.items()
                if math.isfinite(float(v))},
        "nfail": int(nfail),
        "dev": str(device),
    }
    m = margin_of(scores, winner)
    if m is not None:
        entry["margin"] = round(m, 4)
    if winner in scores and math.isfinite(float(scores[winner])):
        entry["est_bits"] = round(float(scores[winner]), 4)
    return entry


# ---------------------------------------------------------------------------
# explain(): decision records from a live trace or a container blob
# ---------------------------------------------------------------------------

def explain(obj: Union[Trace, bytes, bytearray, memoryview]) -> List[Dict[str, Any]]:
    """Selection-decision records for a trace or a compressed container.

    * :class:`Trace` — the records captured live (every engine, full detail:
      estimates, margins, realized bits).
    * container bytes — records reconstructed from the header alone, no body
      decode: v2/v4 chunk tables (including embedded ``"sel"`` entries and
      the quality controller's ``"q"`` records), v5 hybrid block-tag counts,
      v6 fast-tier constant/fixed-length stats, and single-pipeline v1/v3
      containers.  Blob-derived records carry whatever the header preserved;
      fields the header never stored come back ``None``.
    """
    if isinstance(obj, Trace):
        return [validate_decision(dict(r)) for r in obj.decisions]
    blob = bytes(obj)
    from . import pipeline as pl_mod  # local: pipeline imports telemetry

    header, _ = pl_mod.parse_header(blob)
    kind = header.get("kind", header.get("spec", {}).get("kind", "sz3"))
    shape = [int(s) for s in header.get("shape", [])]
    n_total = 1
    for s in shape:
        n_total *= s
    recs: List[Dict[str, Any]] = []
    if "chunks" in header:  # v2 chunked / v4 pwr (incl. quality-controlled)
        if "quality" in header:
            engine = "sz3_quality"
        else:
            # the candidate lists in embedded sel entries (or, failing
            # those, the winners actually used) reveal an auto-style
            # contest; a plain prediction-only container stays sz3_chunked
            used: set = set()
            for c in header["chunks"]:
                used.update((c.get("sel") or {}).get("cands") or ())
                used.add(str(c.get("pipeline", "")))
            engine = chunked_engine_name(kind, used)
        row = 1
        for s in shape[1:]:
            row *= s
        for i, c in enumerate(header["chunks"]):
            sel = c.get("sel") or {}
            q = c.get("q")
            n_elems = int(c.get("n0", 0)) * row
            extra = dict(sel.get("extra") or {})
            if q:
                extra["quality"] = q
            recs.append(make_decision(
                engine,
                c["pipeline"],
                index=i,
                candidates=sel.get("cands") or [c["pipeline"]],
                estimates=sel.get("est") or None,
                est_bits=sel.get("est_bits"),
                realized_bits=8.0 * int(c["len"]) / max(1, n_elems),
                margin=sel.get("margin"),
                n_elems=n_elems,
                fallbacks=int(sel.get("nfail", 0)),
                device=sel.get("dev", "host"),
                extra=extra or None,
            ))
    elif kind == "hybrid":  # v5: per-block tag contest, summarized
        meta = header.get("hyb_meta") or {}
        tag_names = ("zero", "lorenzo1", "lorenzo2", "regression")
        raw = meta.get("counts") or []
        counts = {tag_names[i]: int(c) for i, c in enumerate(raw[:4])}
        winner = max(counts, key=counts.get) if counts else "lorenzo1"
        recs.append(make_decision(
            "sz3_hybrid",
            winner,
            scope="block-summary",
            candidates=list(tag_names),
            estimates={k: float(v) for k, v in counts.items()} or None,
            realized_bits=8.0 * len(blob) / max(1, n_total),
            n_elems=n_total,
            fallbacks=int(meta.get("nfail", 0)),
            extra={"counts": counts, "n_reg": int(meta.get("n_reg", 0)),
                   "nb": int(meta.get("nb", 0))} if counts else None,
        ))
    elif kind == "fast":  # v6: constant vs fixed-length per block
        meta = header.get("fast_meta") or {}
        nb = int(meta.get("nb", 0))
        n_const = int(meta.get("n_const", 0))
        winner = "constant" if n_const * 2 > nb else "fixed_length"
        recs.append(make_decision(
            "sz3_fast",
            winner,
            scope="block-summary",
            candidates=["constant", "fixed_length"],
            estimates={"constant": float(n_const),
                       "fixed_length": float(nb - n_const)},
            realized_bits=8.0 * len(blob) / max(1, n_total),
            n_elems=n_total,
            fallbacks=int(meta.get("nfail", 0)),
            device="device" if meta.get("device") else "host",
        ))
    else:  # single-pipeline v1/v3 container
        meta = header.get("meta") or {}
        spec = header.get("spec") or {}
        name = _engine_name(kind, spec)
        recs.append(make_decision(
            name,
            name,
            scope="array",
            realized_bits=8.0 * len(blob) / max(1, n_total),
            n_elems=n_total,
            fallbacks=int(meta.get("nfail", 0)),
            device="device" if meta.get("device") else "host",
        ))
    return [validate_decision(r) for r in recs]


#: candidate families beyond Algorithm-1 prediction: their presence in a
#: chunked contest is what distinguishes the ``sz3_auto`` configuration
_WIDE_FAMILIES = frozenset(
    {"sz3_transform", "sz3_hybrid", "sz3_fast", "sz3_truncation"}
)


def chunked_engine_name(kind: str, candidates: Iterable[str]) -> str:
    """Engine label for a chunked contest: ``sz3_auto`` when whole-pipeline
    coder families (transform/hybrid/fast) contest alongside the prediction
    pipelines, ``sz3_<kind>`` otherwise.  Deterministic in (kind,
    candidates), so the live record and the blob-side reconstruction (which
    reads the candidate list from the embedded ``sel`` entries) agree."""
    if kind == "chunked" and any(c in _WIDE_FAMILIES for c in candidates):
        return "sz3_auto"
    return f"sz3_{kind}"


def _engine_name(kind: str, spec: Dict[str, Any]) -> str:
    if kind in ("transform", "truncation", "fast", "hybrid"):
        return f"sz3_{kind}"
    pred = spec.get("predictor")
    return {
        "composite": "sz3_lr", "interp": "sz3_interp", "lorenzo": "sz3_lorenzo",
    }.get(pred, f"sz3_{pred or kind}")


# ---------------------------------------------------------------------------
# global serving metrics (always-on; Prometheus text exposition)
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Process-wide counters and latency histograms for the serving layer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, StreamingHistogram] = {}

    def count(self, name: str, inc: Union[int, float] = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        """Set a gauge to an absolute value (last-write-wins)."""
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_add(self, name: str, delta: Union[int, float]) -> float:
        """Adjust a gauge by ``delta`` (e.g. queue depth +1/-1); returns the
        new value so callers can assert monotone invariants in tests."""
        with self._lock:
            val = self._gauges.get(name, 0.0) + delta
            self._gauges[name] = val
            return val

    def gauge_value(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = StreamingHistogram()
        hist.observe(value)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: h.snapshot() for k, h in hists.items()},
        }

    def prometheus_text(self) -> str:
        """Prometheus text exposition: counters as ``counter``, histograms as
        ``summary`` (quantile series + ``_sum``/``_count``)."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items())
        lines: List[str] = []
        for name, val in counters:
            n = _prom_name(name)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {val:g}")
        for name, val in gauges:
            n = _prom_name(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {val:g}")
        for name, hist in hists:
            n = _prom_name(name)
            lines.append(f"# TYPE {n} summary")
            for q in (0.5, 0.9, 0.99):
                v = hist.quantile(q)
                if not math.isnan(v):
                    lines.append(f'{n}{{quantile="{q:g}"}} {v:.9g}')
            lines.append(f"{n}_sum {hist.total:.9g}")
            lines.append(f"{n}_count {hist.n}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


METRICS = MetricsRegistry()


def metric_count(name: str, inc: Union[int, float] = 1) -> None:
    METRICS.count(name, inc)


def metric_observe(name: str, value: float) -> None:
    METRICS.observe(name, value)


def metric_gauge(name: str, value: float) -> None:
    METRICS.gauge(name, value)


def metric_gauge_add(name: str, delta: Union[int, float]) -> float:
    return METRICS.gauge_add(name, delta)


def prometheus_text() -> str:
    return METRICS.prometheus_text()


def reset_metrics() -> None:
    METRICS.reset()


# ---------------------------------------------------------------------------
# structured logging (repro_torch.telemetry namespace, key=value lines)
# ---------------------------------------------------------------------------

_LOG_ROOT = "repro_torch.telemetry"
_log_lock = threading.Lock()
_log_configured = False


def _fmt_value(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    return f'"{s}"' if (" " in s or "=" in s) else s


class KVLogger:
    """Thin wrapper emitting structured ``event key=value ...`` lines.

    Each record is a single ``logging`` call, so the stdlib handler lock
    guarantees whole-line atomicity: messages from concurrent offload and
    heartbeat threads never interleave mid-line.
    """

    __slots__ = ("_log",)

    def __init__(self, logger: logging.Logger):
        self._log = logger

    def _emit(self, level: int, event: str, fields: Dict[str, Any]) -> None:
        if not self._log.isEnabledFor(level):
            return
        parts = [event] + [f"{k}={_fmt_value(v)}" for k, v in fields.items()]
        self._log.log(level, " ".join(parts))

    def debug(self, event: str, **fields: Any) -> None:
        self._emit(logging.DEBUG, event, fields)

    def info(self, event: str, **fields: Any) -> None:
        self._emit(logging.INFO, event, fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit(logging.ERROR, event, fields)


def get_logger(name: str = "") -> KVLogger:
    """A ``repro_torch.telemetry``-namespaced structured logger.

    The namespace root gets one stream handler (idempotent) at the level
    named by ``$SZ3J_LOG_LEVEL`` (default INFO); child loggers propagate to
    it, so the whole subsystem is tuned with a single env var.
    """
    global _log_configured
    with _log_lock:
        if not _log_configured:
            root = logging.getLogger(_LOG_ROOT)
            if not root.handlers:
                handler = logging.StreamHandler()
                handler.setFormatter(logging.Formatter(
                    "%(asctime)s %(levelname)s %(name)s %(message)s"
                ))
                root.addHandler(handler)
            level = os.environ.get(LOG_LEVEL_ENV, "INFO").upper()
            root.setLevel(getattr(logging, level, logging.INFO))
            root.propagate = False
            _log_configured = True
    full = f"{_LOG_ROOT}.{name}" if name else _LOG_ROOT
    return KVLogger(logging.getLogger(full))
