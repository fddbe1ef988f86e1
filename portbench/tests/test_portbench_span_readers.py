"""The readers of the program's copy, Huffman and fast-tier decode spans, on
a hand-built run: known spans give known MB/s, an absent span gives None,
and spans under the chunk contest (``select``) are left out."""
import pytest

from portbench.harness import session
from portbench.harness.catalog import Catalog

#: metric -> (op, span name) it reads
READERS = {
    "fast_blocks_MBps.decompress": ("decompress", "unpack"),
    "huffman_pack_MBps.compress": ("compress", "huffman_pack"),
    "to_host_MBps.compress": ("compress", "to_host"),
    "to_device_MBps.decompress": ("decompress", "to_device"),
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

