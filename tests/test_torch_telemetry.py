"""The port's telemetry spine (``repro_torch.core.telemetry``) held against
the JAX package's, on the CPU.

* the contracts of ``tests/test_telemetry.py``, run against the port: span
  nesting and the deterministic merge of parallel worker spans, the no-op
  disabled path, the streaming histogram against numpy's quantiles, the
  pinned decision-record schema on every contest engine (from the live
  trace and from the blob through ``explain``), the metrics registry and
  its Prometheus page, and the structured key=value logger;
* same input, same bytes: traced blobs of ``sz3_chunked``, ``sz3_auto``,
  ``sz3_hybrid``, ``sz3_quality`` and ``sz3_fast`` equal the reference's
  traced blobs byte for byte (``sel`` entries included), at one and four
  workers; the reference's ``explain`` reads the same records from the
  port's blob as from its own; the port's live decision records and its
  span trees (names, nesting, attribute keys), compress and decompress,
  equal the reference's;
* while a trace records, a span synchronises the current CUDA stream at
  exit; with no trace nothing does.
"""
import concurrent.futures as cf
import json
import logging

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import telemetry

try:  # the differential tests need the JAX package
    import repro.core as rc
    from repro.core import predictors as r_pred
    from repro.core import telemetry as r_tel
except ImportError:  # pragma: no cover - a machine without JAX
    rc = None

CPU = "cpu"
needs_reference = pytest.mark.skipif(rc is None, reason="the JAX package is not importable")


def _smooth(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(n)).astype(np.float32)


REL3 = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-3)


def _strip(spans, attrs=False):
    return [
        {
            "name": s["name"],
            **({"attrs": sorted((s.get("attrs") or {}).keys())} if attrs else {}),
            "children": _strip(s.get("children", []), attrs),
        }
        for s in spans
    ]


# ---------------------------------------------------------------------------
# span nesting + deterministic merge
# ---------------------------------------------------------------------------

def test_span_nesting_tree():
    with telemetry.trace("t") as tr:
        with telemetry.span("outer"):
            with telemetry.span("inner", bytes=4):
                pass
            with telemetry.span("inner2"):
                pass
    (outer,) = tr.root.children
    assert outer.name == "outer"
    assert [c.name for c in outer.children] == ["inner", "inner2"]
    assert outer.children[0].attrs["bytes"] == 4
    assert outer.seconds >= sum(c.seconds for c in outer.children) >= 0.0


def test_parallel_worker_spans_merge_deterministically():
    """Worker-thread spans land under the root and serialize in ``order``
    attr order, independent of completion order."""

    def work(i):
        with telemetry.span("chunk", order=i):
            with telemetry.span("predict"):
                pass
        return i

    trees = []
    for _ in range(3):
        with telemetry.trace("t") as tr:
            with cf.ThreadPoolExecutor(max_workers=4) as pool:
                list(pool.map(telemetry.propagate(work), range(8)))
        trees.append(tr.to_dict()["spans"])
    assert [s["attrs"]["order"] for s in trees[0]] == list(range(8))
    assert [s["name"] for s in trees[0]] == ["chunk"] * 8
    strip = [
        [{"attrs": s.get("attrs"), **t} for s, t in zip(tree, _strip(tree))] for tree in trees
    ]
    assert strip[0] == strip[1] == strip[2]


def test_contextvar_does_not_leak_without_propagate():
    """A worker task NOT wrapped in propagate() records nothing — the trace
    is context-scoped, not global."""
    def work(_):
        telemetry.count("leaked")
        with telemetry.span("leaked_span"):
            pass

    with telemetry.trace("t") as tr:
        with cf.ThreadPoolExecutor(max_workers=2) as pool:
            list(pool.map(work, range(4)))
    assert tr.counters == {}
    assert tr.root.children == []


def test_nested_traces_innermost_wins():
    with telemetry.trace("outer") as outer:
        telemetry.count("outer_only")
        with telemetry.trace("inner") as inner:
            telemetry.count("inner_only")
    assert "inner_only" in inner.counters
    assert "inner_only" not in outer.counters
    assert "outer_only" in outer.counters


# ---------------------------------------------------------------------------
# disabled-path no-op semantics; the CUDA sync of a recording span
# ---------------------------------------------------------------------------

def test_disabled_path_is_noop():
    assert telemetry.current() is None
    assert not telemetry.enabled()
    s = telemetry.span("predict", bytes=10)
    with s as sp:
        sp.set(extra=1)  # must not raise
    # the no-op span is a shared singleton: nothing allocated, nothing kept
    assert telemetry.span("huffman") is s
    telemetry.count("x")
    telemetry.observe("y", 1.0)
    telemetry.record_decision(telemetry.make_decision("e", "w"))
    assert telemetry.current() is None


def test_recording_span_syncs_cuda_and_disabled_span_does_not(monkeypatch):
    """A span of a recording trace waits for the current CUDA stream at
    exit (its seconds are then the stage's device time); the disabled path
    never touches CUDA."""
    synced = []

    class Stream:
        def synchronize(self):
            synced.append(1)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    with telemetry.span("predict"):
        pass
    assert synced == []
    with telemetry.trace("t"):
        with telemetry.span("predict"):
            with telemetry.span("device_transfer"):
                pass
    assert len(synced) == 2


def test_untraced_compress_deterministic_and_traced_roundtrips():
    """With no trace active the selection info is never computed and the
    container is byte-identical run to run; under a trace, ``sel`` entries
    embed in the chunk table but the reconstruction stays identical."""
    data = _smooth(1 << 14)
    comp = tc.sz3_chunked(chunk_bytes=1 << 14, device=CPU)
    plain = comp.compress(data, REL3).blob
    assert comp.compress(data, REL3).blob == plain
    with telemetry.trace("t"):
        traced = comp.compress(data, REL3).blob
    assert torch.equal(tc.decompress(plain, device=CPU), tc.decompress(traced, device=CPU))
    header, _ = tc.parse_header(plain)
    assert all("sel" not in c for c in header["chunks"])
    traced_header, _ = tc.parse_header(traced)
    assert any("sel" in c for c in traced_header["chunks"])


def test_serial_parallel_traces_structurally_identical():
    data = _smooth(1 << 15)
    trees, blobs = [], []
    for workers in (1, 4):
        comp = tc.sz3_chunked(chunk_bytes=1 << 13, workers=workers, device=CPU)
        with telemetry.trace("t") as tr:
            blobs.append(comp.compress(data, REL3).blob)
        trees.append(tr.to_dict()["spans"])
    assert blobs[0] == blobs[1]
    assert _strip(trees[0]) == _strip(trees[1])


# ---------------------------------------------------------------------------
# streaming histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential"])
def test_histogram_percentiles_vs_numpy(dist):
    rng = np.random.default_rng(7)
    vals = {
        "lognormal": rng.lognormal(0.0, 2.0, 20_000),
        "uniform": rng.uniform(1e-3, 1e3, 20_000),
        "exponential": rng.exponential(5.0, 20_000),
    }[dist]
    h = telemetry.StreamingHistogram()
    for v in vals:
        h.observe(v)
    # bucket width is 2**(1/16)-1 (~4.4%) relative — assert within 5%
    for q in (0.5, 0.9, 0.99):
        ref = float(np.quantile(vals, q))
        got = h.quantile(q)
        assert abs(got - ref) / ref < 0.05, (q, got, ref)
    snap = h.snapshot()
    assert snap["count"] == vals.size
    assert snap["min"] == pytest.approx(vals.min())
    assert snap["max"] == pytest.approx(vals.max())
    assert snap["sum"] == pytest.approx(vals.sum(), rel=1e-9)


def test_histogram_zero_and_negative_bucket():
    h = telemetry.StreamingHistogram()
    for v in [0.0, -1.0, 0.0, 5.0]:
        h.observe(v)
    assert h.n == 4
    assert h.quantile(0.0) <= 0.0
    assert h.quantile(1.0) == pytest.approx(5.0, rel=0.05)


def test_histogram_merge_equals_combined():
    rng = np.random.default_rng(11)
    a, b = rng.lognormal(0, 1, 5000), rng.lognormal(1, 1, 5000)
    ha, hb, hc = (telemetry.StreamingHistogram() for _ in range(3))
    for v in a:
        ha.observe(v)
        hc.observe(v)
    for v in b:
        hb.observe(v)
        hc.observe(v)
    ha.merge(hb)
    assert ha.n == hc.n
    assert ha.quantile(0.5) == pytest.approx(hc.quantile(0.5))
    assert ha.snapshot()["max"] == hc.snapshot()["max"]


@needs_reference
def test_histogram_snapshot_equals_the_references():
    vals = np.random.default_rng(12).lognormal(0.0, 3.0, 3000)
    ours, theirs = telemetry.StreamingHistogram(), r_tel.StreamingHistogram()
    for v in np.concatenate([vals, [0.0, -2.0]]):
        ours.observe(v)
        theirs.observe(v)
    assert ours.snapshot() == theirs.snapshot()


# ---------------------------------------------------------------------------
# pinned decision-record schema, every engine
# ---------------------------------------------------------------------------

SMOOTH2D = np.cumsum(np.random.default_rng(3).standard_normal((64, 256)).astype(np.float32), 0)
ABS3 = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=1e-3)
ENGINES = {
    "sz3_chunked": (lambda m, **k: m.sz3_chunked(chunk_bytes=1 << 14, **k), "rel"),
    "sz3_auto": (lambda m, **k: m.sz3_auto(chunk_bytes=1 << 14, **k), "rel"),
    "sz3_hybrid": (lambda m, **k: m.sz3_hybrid(**k), "rel"),
    "sz3_fast": (lambda m, **k: m.sz3_fast(**k), "abs"),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_decision_records_trace_and_blob(name):
    make, mode = ENGINES[name]
    conf = REL3 if mode == "rel" else ABS3
    with telemetry.trace("t") as tr:
        res = make(tc, device=CPU).compress(SMOOTH2D, conf)
    assert tr.decisions, f"{name}: no decision records in trace"
    for rec in tr.decisions:
        telemetry.validate_decision(rec)
        assert rec["engine"] == name
        assert rec["winner"] in rec["candidates"]
        assert json.loads(json.dumps(rec)) == rec  # JSON-serializable
    from_blob = telemetry.explain(res.blob)
    assert from_blob, f"{name}: explain(blob) returned nothing"
    for rec in from_blob:
        telemetry.validate_decision(rec)
        assert rec["engine"] == name
    assert [r["winner"] for r in from_blob] == [r["winner"] for r in tr.decisions]


def test_quality_decision_records():
    data = np.cumsum(np.random.default_rng(5).standard_normal((48, 128)).astype(np.float32), 0)
    q = tc.sz3_quality(target_psnr=55.0, chunk_bytes=1 << 14, device=CPU)
    with telemetry.trace("t") as tr:
        res = q.compress(data)
    assert tr.decisions
    for rec in tr.decisions:
        telemetry.validate_decision(rec)
        assert rec["engine"] == "sz3_quality"
        assert rec["extra"] and "quality" in rec["extra"]
    from_blob = telemetry.explain(res.blob)
    assert from_blob and all(r["engine"] == "sz3_quality" for r in from_blob)
    for rec in from_blob:
        telemetry.validate_decision(rec)


def test_explain_single_pipeline_blob():
    res = tc.sz3_lorenzo(device=CPU).compress(_smooth(4096), REL3)
    recs = telemetry.explain(res.blob)
    assert len(recs) == 1
    telemetry.validate_decision(recs[0])
    assert recs[0]["scope"] == "array"


def test_validate_decision_rejects_bad_records():
    good = telemetry.make_decision("e", "w", candidates=["w"])
    telemetry.validate_decision(good)
    with pytest.raises(ValueError):
        telemetry.validate_decision({**good, "unknown_field": 1})
    with pytest.raises(ValueError):
        bad = dict(good)
        del bad["engine"]
        telemetry.validate_decision(bad)
    with pytest.raises(ValueError):
        telemetry.validate_decision({**good, "winner": "not-a-candidate"})


def test_trial_runoffs_do_not_pollute_decision_stream():
    """Exactly one record per chunk, all from the outer engine, even when
    the winning sub-engine is itself a contest (hybrid, fast)."""
    data = _smooth(1 << 15)
    with telemetry.trace("t") as tr:
        res = tc.sz3_auto(chunk_bytes=1 << 13, device=CPU).compress(data, REL3)
    n_chunks = len([r for r in telemetry.explain(res.blob) if r["scope"] == "chunk"])
    assert len(tr.decisions) == n_chunks
    assert {r["engine"] for r in tr.decisions} == {"sz3_auto"}
    assert [r["index"] for r in tr.decisions] == list(range(n_chunks))


# ---------------------------------------------------------------------------
# stage spans on the engine paths + summary rendering
# ---------------------------------------------------------------------------

def test_compress_emits_stage_spans():
    with telemetry.trace("t") as tr:
        tc.sz3_chunked(chunk_bytes=1 << 13, device=CPU).compress(_smooth(1 << 14), REL3)
    totals = tr.stage_totals()
    for stage in ("chunk", "select", "predict", "huffman", "lossless", "integrity"):
        assert stage in totals, f"missing stage span: {stage}"
        assert totals[stage]["calls"] >= 1
    text = telemetry.trace_summary(tr)
    assert "predict" in text and "calls" in text
    assert tc.trace_summary is telemetry.trace_summary and tc.Trace is telemetry.Trace


def test_trace_json_roundtrip(tmp_path):
    with telemetry.trace("t") as tr:
        tc.sz3_fast(device=CPU).compress(_smooth(1 << 13), ABS3)
    p = tmp_path / "trace.json"
    tr.save_json(str(p))
    doc = json.loads(p.read_text())
    assert doc["name"] == "t"
    assert doc["decisions"] and doc["spans"]
    assert doc["seconds"] >= 0


# ---------------------------------------------------------------------------
# metrics registry + Prometheus exposition
# ---------------------------------------------------------------------------

def test_metrics_registry_and_prometheus_text():
    telemetry.reset_metrics()
    try:
        telemetry.metric_count("sz3_requests_total")
        telemetry.metric_count("sz3_requests_total", 2)
        for v in (0.01, 0.02, 0.04):
            telemetry.metric_observe("sz3_decode_step_seconds", v)
        text = telemetry.prometheus_text()
        assert "sz3_requests_total 3" in text
        assert "# TYPE sz3_requests_total counter" in text
        assert "# TYPE sz3_decode_step_seconds summary" in text
        assert 'sz3_decode_step_seconds{quantile="0.5"}' in text
        assert "sz3_decode_step_seconds_count 3" in text
    finally:
        telemetry.reset_metrics()


@needs_reference
def test_prometheus_text_equals_the_references():
    ours, theirs = telemetry.MetricsRegistry(), r_tel.MetricsRegistry()
    for reg in (ours, theirs):
        reg.count("sz3_serve_puts_total", 3)
        reg.count("weird name-1", 0.5)
        reg.gauge("sz3_serve_pages", 7)
        reg.gauge_add("sz3_serve_queue_depth", -2)
        for v in (0.5, 0.001, 3.0, 0.0):
            reg.observe("sz3_serve_request_seconds", v)
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.snapshot() == theirs.snapshot()


# ---------------------------------------------------------------------------
# structured logger
# ---------------------------------------------------------------------------

class _ListHandler(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _capture(name):
    """The telemetry namespace manages its own handler (propagate=False), so
    capture by attaching a handler to the named logger directly."""
    log = telemetry.get_logger(name)
    h = _ListHandler()
    py = logging.getLogger(f"repro_torch.telemetry.{name}")
    old = py.level
    py.addHandler(h)
    py.setLevel(logging.DEBUG)
    return log, h, (py, old)


def test_kv_logger_format():
    log, h, (py, old) = _capture("testmod")
    try:
        log.info("thing_done", n=3, rate=1234.5678, note="two words")
    finally:
        py.removeHandler(h)
        py.setLevel(old)
    assert len(h.records) == 1
    msg = h.records[0].getMessage()
    assert msg.startswith("thing_done ")
    assert "n=3" in msg
    assert "rate=1234.57" in msg
    assert 'note="two words"' in msg


def test_kv_logger_single_record_per_event():
    log, h, (py, old) = _capture("atomic")
    try:
        log.info("ev", a=1, b=2, c=3)
    finally:
        py.removeHandler(h)
        py.setLevel(old)
    assert len(h.records) == 1
    assert "\n" not in h.records[0].getMessage()


# ---------------------------------------------------------------------------
# against the reference: traced bytes, records, span trees
# ---------------------------------------------------------------------------

MIXED = np.concatenate([
    SMOOTH2D[:32],
    np.sin(0.9 * np.pi * np.arange(32 * 256)).reshape(32, 256).astype(np.float32),
    np.zeros((16, 256), np.float32),
    np.random.default_rng(9).standard_normal((16, 256)).astype(np.float32),
])

TRACED = {
    **{name: (make, mode) for name, (make, mode) in ENGINES.items()},
    "sz3_quality": (lambda m, **k: m.sz3_quality(target_psnr=55.0, chunk_bytes=1 << 14, **k), None),
}


def _traced(pkg, tel, name, data, workers=1, **kw):
    make, mode = TRACED[name]
    if name in ("sz3_chunked", "sz3_auto", "sz3_quality"):
        kw["workers"] = workers
    comp = make(pkg, **kw)
    with tel.trace("t") as tr:
        if mode is None:
            blob = comp.compress(data).blob
        else:
            conf = pkg.CompressionConfig(mode=pkg.ErrorBoundMode(mode), eb=1e-3)
            blob = comp.compress(data, conf).blob
    return blob, tr


@needs_reference
@pytest.mark.parametrize(
    "name,workers",
    [(name, 1) for name in TRACED] + [(name, 4) for name in ("sz3_chunked", "sz3_auto", "sz3_quality")],
)
def test_traced_blob_records_and_spans_equal_the_references(name, workers):
    rblob, rtr = _traced(rc, r_tel, name, MIXED, workers)
    tblob, ttr = _traced(tc, telemetry, name, MIXED, workers, device=CPU)
    assert tblob == rblob
    assert ttr.decisions == rtr.decisions
    assert r_tel.explain(tblob) == r_tel.explain(rblob) == telemetry.explain(tblob)
    assert _strip(ttr.to_dict()["spans"], attrs=True) == _strip(rtr.to_dict()["spans"], attrs=True)
    assert sorted(ttr.counters) == sorted(rtr.counters)
    # decode: the same span tree again
    with r_tel.trace("d") as rd:
        rc.decompress(rblob)
    with telemetry.trace("d") as td:
        tc.decompress(tblob, device=CPU)
    assert _strip(td.to_dict()["spans"], attrs=True) == _strip(rd.to_dict()["spans"], attrs=True)


@needs_reference
@pytest.mark.parametrize("pipeline", ["sz3_lorenzo", "sz3_transform", "sz3_lr", "sz3_interp"])
def test_single_pipeline_span_trees_equal_the_references(pipeline):
    x = SMOOTH2D[:48]
    conf = (rc.CompressionConfig(mode=rc.ErrorBoundMode.REL, eb=1e-3), REL3)
    with r_tel.trace("t") as rtr:
        rblob = rc.PIPELINES[pipeline]().compress(x, conf[0]).blob
    with telemetry.trace("t") as ttr:
        tblob = tc.PIPELINES[pipeline](device=CPU).compress(x, conf[1]).blob
    assert tblob == rblob
    assert _strip(ttr.to_dict()["spans"], attrs=True) == _strip(rtr.to_dict()["spans"], attrs=True)
    assert r_tel.explain(tblob) == telemetry.explain(tblob)


@needs_reference
def test_kernel_route_span_tree_equals_the_references_forced_route():
    """``route="force"`` (the kernel's plain version on the CPU) against the
    reference's ``device="force"`` (its kernel in interpret mode): the same
    ``device_transfer`` span under ``predict``, and the same bytes."""
    x = SMOOTH2D[:32]
    with r_tel.trace("t") as rtr:
        rblob = rc.SZ3Compressor(predictor=r_pred.LorenzoPredictor(device="force")).compress(
            x, rc.CompressionConfig(mode=rc.ErrorBoundMode.ABS, eb=1e-3)).blob
    with telemetry.trace("t") as ttr:
        tblob = tc.sz3_lorenzo(route="force", device=CPU).compress(x, ABS3).blob
    assert tblob == rblob
    tree = _strip(ttr.to_dict()["spans"], attrs=True)
    assert tree == _strip(rtr.to_dict()["spans"], attrs=True)
    assert tree[0]["name"] == "predict" and tree[0]["children"][0]["name"] == "device_transfer"


@needs_reference
def test_reference_traced_blobs_explain_alike_in_the_port():
    """The port's ``explain`` reads a reference-traced blob as the
    reference's does, for every record kind (v1, v2 with ``sel``, v2 with
    quality records, v5, v6)."""
    blobs = [_traced(rc, r_tel, name, SMOOTH2D)[0] for name in TRACED]
    blobs.append(rc.sz3_lorenzo().compress(_smooth(4096), rc.CompressionConfig(mode=rc.ErrorBoundMode.REL, eb=1e-3)).blob)
    for blob in blobs:
        assert telemetry.explain(blob) == r_tel.explain(blob)
