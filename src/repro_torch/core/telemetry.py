"""Telemetry surface used by the pipeline: stage spans and counters.

Only the disabled surface exists so far: :func:`span` returns a no-op context
manager and the counters discard their increments.  Call sites use the same
names as the JAX package, so the recording ``Trace`` can later slot in behind
them without touching the pipeline.
"""
from __future__ import annotations

import contextlib
from typing import Any, ContextManager, Union


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
