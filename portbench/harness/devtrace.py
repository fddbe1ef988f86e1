"""The device's trace over a window, and what the benchmark reads from it.

``DeviceTrace`` runs ``torch.profiler`` with CUDA activity only (no host op
recording, which would slow the host-bound paths it traces) and returns each
device operation (kernel, copy, set) as ``(name, start, end)`` on the host's
``perf_counter`` clock.  The two clocks are tied by a marker kernel launched
right after a synchronise at a known host time: the alignment is off by about
one launch (some microseconds).  A marker is launched as the trace starts and
again as it ends; the profiler sometimes loses one of them, so either ties
the clocks (the first where both are kept).

The reductions are plain functions of those intervals and of the host spans:
``busy_seconds`` (the union of device operations), ``top_ops`` (device time by
name) and ``idle_by_host_span`` (the device's idle time inside the window,
split over the innermost host span that was open).
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

Interval = Tuple[str, float, float]
#: kineto's name for torch.cuda._sleep's kernel, the clock marker
_MARKER = "spin_kernel"


class DeviceTrace:
    def __init__(self):
        self._prof = None
        #: host times of the start and the end marker
        self._marks_host: List[float] = []

    @staticmethod
    def _mark() -> float:
        """Launch a marker on an idle device; its host launch time."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return t

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._marks_host = [self._mark()]
        return self

    def __exit__(self, *exc) -> bool:
        self._marks_host.append(self._mark())
        self._prof.__exit__(*exc)
        return False

    def operations(self) -> List[Interval]:
        """Device operations, earliest first, in host seconds."""
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                raw.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        return align(raw, self._marks_host)


def align(raw: Sequence[Tuple[str, int, int]], marks_host: Sequence[float]) -> List[Interval]:
    """The device operations ``raw`` (name, start and end in device ns) on the
    host's clock, earliest first, tied by the start marker, or by the end
    marker where the trace lost the start one.  Every other operation runs
    after the start marker and before the end one, which tells a lone marker's
    place."""
    marks = sorted(s for n, s, _ in raw if _MARKER in n)
    others = [s for n, s, _ in raw if _MARKER not in n]
    if not marks:
        raise RuntimeError("the profiler recorded no clock marker: no device trace to read")
    if len(marks) > 1 or not others or marks[0] <= min(others):
        offset = marks[0] * 1e-9 - marks_host[0]
    else:
        offset = marks[-1] * 1e-9 - marks_host[-1]
    ops = [(n, s * 1e-9 - offset, t * 1e-9 - offset) for n, s, t in raw if _MARKER not in n]
    return sorted(ops, key=lambda o: o[1])


def busy_seconds(ops: Sequence[Interval], t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` in which some device operation ran."""
    busy, edge = 0.0, t0
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, edge), min(e, t1)
        if e > s:
            busy += e - s
            edge = e
    return busy


def idle_intervals(ops: Sequence[Interval], t0: float, t1: float) -> List[Tuple[float, float]]:
    out, edge = [], t0
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > edge and edge < t1:
            out.append((edge, min(s, t1)))
        edge = max(edge, e)
    if edge < t1:
        out.append((edge, t1))
    return out


def top_ops(ops: Sequence[Interval], n: int = 10, width: int = 96) -> List[List]:
    """``[[name, seconds], ...]``: device time by operation name, largest first."""
    agg: Dict[str, float] = {}
    for name, s, e in ops:
        agg[name] = agg.get(name, 0.0) + (e - s)
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:width], sec] for name, sec in top]


def host_segments(spans: Sequence[Dict], prefix: str = "") -> List[Tuple[str, float, float]]:
    """The innermost open span at each moment, as ``(label, start, end)``:
    each span's interval less its children's, labelled by its path."""
    out = []
    for sp in spans:
        if sp.get("t0") is None:
            continue
        label = f"{prefix}/{sp['name']}" if prefix else sp["name"]
        start, end = sp["t0"], sp["t0"] + sp["seconds"]
        kids = sorted((c for c in sp.get("children", []) if c.get("t0") is not None), key=lambda c: c["t0"])
        edge = start
        for c in kids:
            if c["t0"] > edge:
                out.append((label, edge, min(c["t0"], end)))
            edge = max(edge, c["t0"] + c["seconds"])
        if edge < end:
            out.append((label, edge, end))
        out += host_segments(kids, label)
    return sorted(out, key=lambda s: s[1])


def idle_by_host_span(ops: Sequence[Interval], spans: Sequence[Dict], t0: float, t1: float,
                      n: int = 10, outside: str = "harness") -> List[List]:
    """``[[label, seconds], ...]``: the device's idle seconds in ``[t0, t1]``
    by the innermost host span open at the time, largest first; idle time
    outside every span goes to ``outside``."""
    gaps = idle_intervals(ops, t0, t1)
    segs = host_segments(spans)
    agg: Dict[str, float] = {}
    first = 0  # gaps come in order, so segments ending before one end before the next
    for gs, ge in gaps:
        while first < len(segs) and segs[first][2] <= gs:
            first += 1
        covered = 0.0
        for j in range(first, len(segs)):
            label, ss, se = segs[j]
            if ss >= ge:
                break
            part = min(ge, se) - max(gs, ss)
            if part > 0:
                agg[label] = agg.get(label, 0.0) + part
                covered += part
        if ge - gs - covered > 0:
            agg[outside] = agg.get(outside, 0.0) + (ge - gs - covered)
    return [[k, v] for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:n]]
