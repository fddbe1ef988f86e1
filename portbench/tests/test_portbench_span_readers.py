"""The readers of the program's copy, Huffman and fast-tier decode spans, on
a hand-built run: known spans give known MB/s, an absent span gives None,
and spans under the chunk contest (``select``) are left out.  Also the
counter totals, the Lorenzo encode roofline's guard against a trace that
lost kernels, and the fast cell's per-layer rates."""
import pytest

from portbench import roofline
from portbench.harness import readers, session
from portbench.harness.catalog import Catalog

#: metric -> (op, span name) it reads
READERS = {
    "fast_blocks_MBps.decompress": ("decompress", "unpack"),
    "huffman_pack_MBps.compress": ("compress", "huffman_pack"),
    "to_host_MBps.compress": ("compress", "to_host"),
    "to_device_MBps.decompress": ("decompress", "to_device"),
    "to_host_MBps.compress.fast": ("compress", "to_host"),
    "to_device_MBps.decompress.fast": ("decompress", "to_device"),
}


def _span(name, nbytes, seconds, children=()):
    return {"name": name, "t0": 0.0, "seconds": seconds, "bytes": nbytes, "children": list(children)}


def _run(spans_by_call):
    run = session.Run(cell={}, config={}, traffic={}, device_name="cpu")
    for i, spans in enumerate(spans_by_call):
        call = session.Call(i, i, 0, 1000, 4000, compress_s=1.0, decompress_s=1.0)
        call.spans = spans
        run.calls.append(call)
    return run


def _read(metric, run):
    return Catalog.load().module("metrics", metric).read(run)


@pytest.mark.parametrize("op", ["compress", "decompress"])
def test_the_fast_cells_per_layer_rates_read_the_end_to_end_ones(op):
    run = _run([{}, {}])
    run.calls[0].compress_s, run.calls[1].decompress_s = 3.0, 0.5  # 8000 B in 4 s and in 1.5 s
    want = {"compress": 0.002, "decompress": 0.008 / 1.5}[op]
    assert _read(f"{op}_MBps", run) == pytest.approx(want)
    assert _read(f"{op}_MBps.fast", run) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_known_spans_give_their_MBps(metric):
    op, name = READERS[metric]
    # two calls: 3 MB in 0.5 s and 1 MB nested one level down in 0.5 s -> 4 MB/s
    first = {op: [_span("outer", 0, 1.0, [_span(name, 3_000_000, 0.5)])]}
    second = {op: [_span("outer", 0, 1.0, [_span("inner", 0, 0.9, [_span(name, 1_000_000, 0.5)])])]}
    assert _read(metric, _run([first, second])) == pytest.approx(4.0)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_reader_returns_none_without_its_span(metric):
    op, name = READERS[metric]
    other = "decompress" if op == "compress" else "compress"
    assert _read(metric, _run([{op: [_span("huffman", 1_000_000, 1.0)]}])) is None
    # the span in the other op's calls is not this metric's
    assert _read(metric, _run([{other: [_span(name, 1_000_000, 1.0)]}])) is None
    assert _read(metric, _run([])) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_spans_under_select_are_left_out(metric):
    op, name = READERS[metric]
    spans = {op: [_span("chunk", 0, 2.0, [
        _span("select", 0, 1.0, [_span("huffman", 0, 0.5, [_span(name, 9_000_000, 0.25)])]),
        _span(name, 2_000_000, 1.0),
    ])]}
    assert _read(metric, _run([spans])) == pytest.approx(2.0)
    only_select = {op: [_span("select", 0, 1.0, [_span(name, 9_000_000, 0.25)])]}
    assert _read(metric, _run([only_select])) is None


def test_counter_totals_sum_over_the_calls_of_one_op():
    run = _run([{}, {}, {}])
    run.calls[0].counters = {"compress": {"interp_pass": 3.0, "other": 1.0}, "decompress": {"interp_pass": 7.0}}
    run.calls[1].counters = {"compress": {"interp_pass": 4.0}}
    run.calls[2].counters = {"compress": {"interp_pass": 100.0}}
    run.calls[2].error = "RuntimeError: failed"  # a call that failed is not read
    assert readers.counter_total(run, "compress", "interp_pass") == 7.0
    assert readers.counter_total(run, "decompress", "interp_pass") == 7.0
    assert readers.counter_total(run, "compress", "absent") is None
    assert readers.counter_total(_run([{}]), "compress", "interp_pass") is None


@pytest.mark.parametrize("events", [3, 4, 5])
def test_lorenzo_encode_roofline_reads_only_a_trace_that_kept_every_encode(events):
    """Four compress calls, four encode launches: a trace holding another
    number of encode kernels reads nothing (three of four once read 116.86%);
    four read the share of the bound over their time."""
    run = _run([{}] * 4)
    run.device_name = "NVIDIA H100 80GB HBM3"
    run.launches = {"lorenzo.encode_1d": 4, "lorenzo.decode_1d": 4}
    run.ops = [(f"void (anonymous namespace)::encode_1d_kernel<{i}>(float const*, int*)", i, i + 0.01)
               for i in range(events)]
    run.ops += [("void (anonymous namespace)::decode_1d_lookback_kernel<true, int>(int const*, float*)", 9.0, 9.5)]
    got = _read("lorenzo_encode_roofline", run)
    if events != 4:
        assert got is None
    else:
        want = 100.0 * roofline.lorenzo_encode_bytes(1000) * 4 / roofline.bandwidth(run.device_name) / 0.04
        assert got == pytest.approx(want)
    run.launches["lorenzo.encode_1d"] = 3  # a launch count that is not one a compress
    assert _read("lorenzo_encode_roofline", run) is None
