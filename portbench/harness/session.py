"""One run of one cell: set-up, the measured window, the judge, the result.

The window is a closed loop with one client: each field is compressed, then
its blob decompressed, each call timed on the host's clock and ended by a
synchronise.  Fields come in groups of one field of each kind, and the
window closes at the first group boundary after ``seconds``, so every
window holds whole groups.  With ``trace`` the program's spans are recorded
around each call and the device is traced over the window.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import resource
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

from . import devtrace, fields
from .catalog import Catalog
from .program import PortProgram


@dataclasses.dataclass
class Call:
    """One field's round trip in the window."""

    index: int  # position in the run's list of fields
    field: int
    kind: int
    elements: int
    nbytes: int
    compress_s: Optional[float] = None
    decompress_s: Optional[float] = None
    #: the process's user and system CPU seconds (all threads) over each
    #: call, by op: system time is mostly the faulting-in of fresh host memory
    host_use: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    blob: Optional[bytes] = None
    ratio: Optional[float] = None
    decoded: Optional[torch.Tensor] = None
    error: Optional[str] = None
    #: the program's span trees ("compress", "decompress"), traced runs only
    spans: Dict[str, List[Dict]] = dataclasses.field(default_factory=dict)
    #: the program's counters by op, as the trace of each call left them,
    #: traced runs only
    counters: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    #: the harness's own spans around the two calls, as span-tree roots
    host: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.error is None and self.decompress_s is not None


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: Dict
    config: Dict
    traffic: Dict
    device_name: str
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: List[Call] = dataclasses.field(default_factory=list)
    #: device operations in the window, traced runs only
    ops: Optional[List[devtrace.Interval]] = None
    #: kernel launches in the window, by ``<module>.<kernel>``
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> List[Call]:
        return [c for c in self.calls if c.done]


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _note(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


_USE = (("user_s", "ru_utime"), ("sys_s", "ru_stime"))


def _host_use(r0, r1) -> Dict[str, float]:
    return {k: getattr(r1, f) - getattr(r0, f) for k, f in _USE}


def _round_trip(program, x: torch.Tensor, call: Call, device: str, trace: bool) -> None:
    def timed(op: str, fn):
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        if trace:
            with program.traced() as rec:
                out = fn()
                _sync(device)
            call.spans[op], call.counters[op] = rec.spans, rec.counters
        else:
            out = fn()
            _sync(device)
        t1 = time.perf_counter()
        call.host_use[op] = _host_use(r0, resource.getrusage(resource.RUSAGE_SELF))
        call.host.append({"name": op, "t0": t0, "seconds": t1 - t0, "bytes": call.nbytes,
                          "children": call.spans.get(op, [])})
        return out, t1 - t0

    try:
        (call.blob, call.ratio), call.compress_s = timed("compress", lambda: program.compress(x))
        call.decoded, call.decompress_s = timed("decompress", lambda: program.decompress(call.blob))
    except Exception as e:  # noqa: BLE001 - a failed call is counted and the window goes on
        call.error = f"{type(e).__name__}: {e}"
        _note(f"field {call.field} failed: {call.error}")
        traceback.print_exc(limit=4, file=sys.stderr)


def _judge(reference, traffic: Dict, xs: List[torch.Tensor], seals: List, run: Run):
    """(checks, failed calls): the reference's numbers over every finished
    call beside their limits, and the calls that raised or failed one.  The
    reference gets the whole traffic mix, so that it can hold the program
    to what the mix asked for as well as to the bound."""
    limits = reference.LIMITS
    verdicts = [reference.judge_field(xs[c.index], c.decoded, c.blob, c.ratio, traffic, seals[c.index])
                for c in run.done]
    for v in verdicts:
        for f in v.blob_faults[:3]:
            _note(f"blob fault: {f}")
    numbers = reference.summarize(verdicts)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    unfinished = len(run.calls) - len(verdicts)
    checks["failed_calls"] = {"value": unfinished, "limit": 0}
    wrong = sum(1 for v in verdicts if any(x > limits[k] for k, x in reference.summarize([v]).items()))
    return checks, unfinished + wrong


def run_cell(catalog: Catalog, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             program_factory: Callable = PortProgram) -> Dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = catalog.cell(cell_name)
    config = catalog.json("configs", cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    gen = catalog.module("datagen", config["generator"])
    reference = catalog.module("reference", config["reference"])
    kinds = len(config["kinds"])
    device_name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"

    program = program_factory(traffic, device)
    libraries = program.prepare()
    if libraries:
        _note(f"kernel libraries: {libraries}")
    items = fields.plan(int(traffic["fields"]), kinds, seed)
    xs = gen.make(config, items, seed, device)
    # the bound and a digest of each input, before the program sees it
    seals = [reference.seal(x, traffic["mode"], float(traffic["eb"])) for x in xs]
    for i, x in enumerate(gen.make(config, fields.warmup_plan(kinds), seed, device)):
        _round_trip(program, x, Call(-1, fields.WARMUP_BASE + i, i, x.numel(), x.nbytes), device, False)

    run = Run(cell, config, traffic, device_name)
    groups = [list(range(i, i + kinds)) for i in range(0, len(items), kinds)]
    launches0 = program.launches()
    tracer = devtrace.DeviceTrace() if trace and device == "cuda" else None
    if tracer:
        tracer.__enter__()
    t_w0 = time.perf_counter()
    run.setup_s = t_w0 - t_start
    g = 0
    while g == 0 or time.perf_counter() - t_w0 < seconds:
        if g == len(groups):
            msg = f"window wrapped: field {groups[0][0]} again after {len(run.calls)} fields"
            print(f"portbench: {msg}", flush=True)
            _note(msg)
        for i in groups[g % len(groups)]:
            x = xs[i]
            call = Call(i, items[i][0], items[i][1], x.numel(), x.numel() * x.element_size())
            _round_trip(program, x, call, device, trace)
            run.calls.append(call)
        g += 1
    t_w1 = time.perf_counter()
    run.window_s = t_w1 - t_w0
    if tracer:
        tracer.__exit__(None, None, None)
        run.ops = [op for op in tracer.operations() if op[2] > t_w0 and op[1] < t_w1]
    elif trace:
        run.ops = []
    launches1 = program.launches()
    run.launches = {k: launches1[k] - launches0.get(k, 0) for k in launches1}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    program.close()
    del program
    gc.collect()
    checks, failed = _judge(reference, traffic, xs, seals, run)
    correct = bool(run.done) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for entry in catalog.metrics_for(cell_name, trace):
        value = catalog.module("metrics", entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {
        "platform": "gpu" if device == "cuda" else device,
        "kind": device_name,
        "count": int(cell.get("chips", 1)),
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": len(run.calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = devtrace.busy_seconds(run.ops, t_w0, t_w1)
        dev["window_s"] = run.window_s
        hosts = [h for c in run.calls for h in c.host]
        result["breakdown"] = {
            "device_ops": devtrace.top_ops(run.ops),
            "idle_gaps": devtrace.idle_by_host_span(run.ops, hosts, t_w0, t_w1),
        }
    _note("window calls (field:kind compress_s/decompress_s user+sys compress/decompress): " + " ".join(
        f"{c.field}:{c.kind} {c.compress_s:.4f}/{c.decompress_s:.4f} "
        + "/".join(f"{u['user_s']:.2f}+{u['sys_s']:.2f}" for u in (c.host_use["compress"], c.host_use["decompress"]))
        for c in run.done))
    for op in ("compress", "decompress"):
        use = {k: sum(c.host_use[op][k] for c in run.done) for k, _ in _USE}
        _note(f"window {op}: {sum(getattr(c, f'{op}_s') for c in run.done):.3f} s over {len(run.done)} calls; host "
              + " ".join(f"{k} {v:.6g}" for k, v in use.items()))
    result["checks"] = checks
    return result
