"""Arithmetic the metric readers share: span totals, counter totals and
call totals."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple


def _walk(spans: Iterable[Dict], name: str, skip: Tuple[str, ...]):
    for sp in spans:
        if sp["name"] in skip:
            continue
        if sp["name"] == name:
            yield sp
        yield from _walk(sp.get("children", []), name, skip)


def span_totals(run, op: str, name: str, skip: Tuple[str, ...] = ("select",)) -> Tuple[int, float, int]:
    """(bytes, seconds, count) of the program's spans called ``name`` in
    the traces of every ``op`` call ("compress" or "decompress"), leaving
    out whatever runs under a span in ``skip``: the chunk contest's trial
    compressions are the contest's work, not the stage's."""
    nbytes, seconds, count = 0, 0.0, 0
    for call in run.done:
        for sp in _walk(call.spans.get(op, []), name, skip):
            nbytes += sp["bytes"]
            seconds += sp["seconds"]
            count += 1
    return nbytes, seconds, count


def span_MBps(run, op: str, name: str) -> Optional[float]:
    """MB/s of a stage: its spans' bytes over their seconds; None if absent."""
    nbytes, seconds, count = span_totals(run, op, name)
    if not count or seconds <= 0 or nbytes <= 0:
        return None
    return nbytes / 1e6 / seconds


def counter_total(run, op: str, name: str) -> Optional[float]:
    """The sum of the program's counter ``name`` over the traces of every
    finished ``op`` call; None where no call counted it (an untraced run
    keeps no counters)."""
    counts = [c.counters[op][name] for c in run.done if name in c.counters.get(op, {})]
    return sum(counts) if counts else None


def call_MBps(run, op: str) -> Optional[float]:
    """MB/s of every ``op`` call of the window: all field bytes over the
    summed seconds of the calls."""
    calls: List = run.done
    seconds = sum(getattr(c, f"{op}_s") for c in calls)
    if not calls or seconds <= 0:
        return None
    return sum(c.nbytes for c in calls) / 1e6 / seconds


def device_seconds(run, pattern) -> float:
    """Device time of the operations whose name ``pattern`` matches."""
    return sum(e - s for name, s, e in (run.ops or []) if pattern.search(name))
