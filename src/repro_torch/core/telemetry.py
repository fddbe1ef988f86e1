"""Telemetry surface used by the pipeline and the chunked engine: stage
spans, counters and selection-decision records.

Only the disabled surface exists so far: :func:`span` returns a no-op context
manager, the counters discard their increments and :func:`record_decision`
drops its record.  Call sites use the same names as the JAX package, so the
recording ``Trace`` can later slot in behind them without touching the
pipeline.  The functions that make records (:func:`make_decision`,
:func:`sel_header_entry`, :func:`chunked_engine_name`) are the JAX
package's, pure functions of their arguments.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, ContextManager, Dict, Iterable, Optional, Sequence, Union


#: the span every call site gets while tracing is not ported (reusable)
_NOOP_SPAN = contextlib.nullcontext()


def enabled() -> bool:
    """Is a trace recording?  Never, until tracing is ported; callers skip
    building decision records, as the JAX package does with tracing off."""
    return False


def span(name: str, **attrs: Any) -> ContextManager[None]:
    """Open a stage span; a no-op until tracing is ported."""
    return _NOOP_SPAN


def count(name: str, inc: Union[int, float] = 1) -> None:
    """Bump a counter of the active trace; a no-op until tracing is ported."""


def metric_count(name: str, inc: Union[int, float] = 1) -> None:
    """Bump a process-wide metric; a no-op until the registry is ported."""


def suppress_decisions() -> ContextManager[None]:
    """Mute :func:`record_decision` inside the scope (engines wrap their
    internal compressions: trial runoffs, a chunk winner's nested engine)."""
    return _NOOP_SPAN


def record_decision(rec: Dict[str, Any]) -> None:
    """Add a decision record to the active trace; a no-op until tracing is
    ported."""


def propagate(fn: Callable) -> Callable:
    """Bind the caller's active trace into worker threads; with no trace
    active (always, so far) the function is returned unchanged."""
    return fn


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
    """Compact, msgpack-clean form of a decision embedded in a v2 chunk
    table (key ``"sel"``), written only while a trace records."""
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


#: candidate families beyond Algorithm-1 prediction: their presence in a
#: chunked contest is what distinguishes the ``sz3_auto`` configuration
_WIDE_FAMILIES = frozenset(
    {"sz3_transform", "sz3_hybrid", "sz3_fast", "sz3_truncation"}
)


def chunked_engine_name(kind: str, candidates: Iterable[str]) -> str:
    """Engine label for a chunked contest: ``sz3_auto`` when whole-pipeline
    coder families contest alongside the prediction pipelines,
    ``sz3_<kind>`` otherwise."""
    if kind == "chunked" and any(c in _WIDE_FAMILIES for c in candidates):
        return "sz3_auto"
    return f"sz3_{kind}"
