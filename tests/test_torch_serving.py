"""The port's KV-offload service and decode-state cache
(``repro_torch.serve.offload``) held to the contracts of
``tests/test_serving.py`` and against the JAX package's
``repro.serve.offload``, on the CPU.

* contracts: O(chunk) random access with per-chunk CRC isolation, the
  reusable Huffman decode-table handle and its LRU, gauges, the bounded
  decode-state cache, and the coalescing async service (concurrent fetches
  equal serial ones, eviction, typed fault isolation, two event loops, the
  spawned process executor);
* same requests, same answers: for the same puts and fetches the port's
  service holds the reference service's blobs and returns its decoded
  chunks bit for bit, at both executors; ``blob_key`` and the
  ``sz3_serve_*`` metric names are the reference's;
* without a card, the default device raises instead of running on the CPU.

The ``launch.serve`` accounting tests of ``tests/test_serving.py`` wait for
the serve launcher's port.  The ``cuda``-marked tests run the service on the
card with both executors
(``python -m pytest -q -m cuda tests/test_torch_serving.py``).
"""
import asyncio

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import encoders, faults, telemetry
from repro_torch.serve import DecodeStateCache, OffloadError, OffloadService, blob_key

try:  # the differential tests need the JAX package
    import repro.core as rc
    from repro.core import telemetry as r_tel
    from repro.serve import offload as r_off
except ImportError:  # pragma: no cover - a machine without JAX
    rc = None

CPU = "cpu"
needs_reference = pytest.mark.skipif(rc is None, reason="the JAX package is not importable")
ABS = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=1e-3)


def _field(shape=(96, 96), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    for ax in range(x.ndim):
        x = np.cumsum(x, axis=ax) / np.sqrt(x.shape[ax])
    return x.astype(np.float32)


def _service(**kw):
    return OffloadService(device=CPU, **kw)


def _chunk(blob, c, **kw):
    return tc.decompress_chunk(blob, c, device=CPU, **kw)


@pytest.fixture(scope="module")
def container():
    data = _field()
    blob = tc.sz3_chunked(chunk_bytes=4096, device=CPU).compress(data, ABS).blob
    return data, blob


def _corrupt_chunk(blob, idx, chunk):
    off, ln = idx.bounds[chunk]
    lo = idx.body_off + off + ln // 2
    return blob[:lo] + bytes([blob[lo] ^ 0xFF]) + blob[lo + 1 :]


# ---------------------------------------------------------------------------
# parse split + O(chunk) strict random access
# ---------------------------------------------------------------------------

class TestChunkedIndex:
    def test_parsed_reads_equal_unparsed(self, container):
        _, blob = container
        idx = tc.parse_chunked_index(blob)
        assert idx.n_chunks > 4
        assert idx.chunk_crcs is not None and idx.header_ok
        for c in (0, 1, idx.n_chunks - 1):
            assert torch.equal(_chunk(blob, c), _chunk(blob, c, parsed=idx))

    def test_chunks_reassemble_to_full_decode(self, container):
        data, blob = container
        idx = tc.parse_chunked_index(blob)
        parts = [_chunk(blob, c, parsed=idx) for c in range(idx.n_chunks)]
        whole = torch.cat(parts, dim=0).reshape(data.shape)
        assert torch.equal(whole, tc.decompress(blob, device=CPU))

    def test_corrupt_other_chunk_does_not_fail_read(self, container):
        _, blob = container
        idx = tc.parse_chunked_index(blob)
        bad = _corrupt_chunk(blob, idx, chunk=2)
        assert torch.equal(_chunk(bad, 0, verify="strict"), _chunk(blob, 0))
        with pytest.raises(tc.IntegrityError) as ei:
            _chunk(bad, 2, verify="strict")
        assert ei.value.chunk_index == 2
        with pytest.raises(tc.IntegrityError):
            tc.decompress(bad, verify="strict", device=CPU)

    def test_header_damage_fails_every_read(self, container):
        _, blob = container
        bad = blob[:22] + bytes([blob[22] ^ 0xFF]) + blob[23:]
        with pytest.raises(ValueError):
            _chunk(bad, 0, verify="strict")

    def test_verify_off_skips_crc(self, container):
        _, blob = container
        idx = tc.parse_chunked_index(blob)
        bad = _corrupt_chunk(blob, idx, chunk=1)
        assert torch.equal(_chunk(bad, 0, verify="off"), _chunk(blob, 0))

    def test_rejects_non_chunked_blob(self):
        with pytest.raises(ValueError):
            tc.parse_chunked_index(b"garbage not a container")


# ---------------------------------------------------------------------------
# huffman decode-table handle + LRU
# ---------------------------------------------------------------------------

class TestHuffmanHandle:
    def test_handle_decode_equals_plain(self):
        codes = np.random.default_rng(2).integers(0, 200, 5000)
        enc = encoders.HuffmanEncoder()
        buf = enc.encode(codes)
        h = encoders.huffman_decode_handle(buf)
        assert h is not None
        a = enc.decode(buf, codes.size)
        b = enc.decode(buf, codes.size, handle=h)
        c = enc.decode(buf, codes.size, handle=h)  # reuse
        assert np.array_equal(a, codes) and np.array_equal(b, codes) and np.array_equal(c, codes)

    def test_empty_stream_handle_is_none(self):
        enc = encoders.HuffmanEncoder()
        buf = enc.encode(np.zeros(0, np.int64))
        assert encoders.huffman_decode_handle(buf) is None
        assert enc.decode(buf, 0).size == 0

    def test_table_cache_lru_bound_and_stats(self):
        encoders.clear_table_cache()
        rng = np.random.default_rng(3)
        enc = encoders.HuffmanEncoder()
        bufs = []
        for k in range(5):
            codes = rng.integers(0, 10 + 17 * k, 2000)
            bufs.append((enc.encode(codes), codes))
        old_max = encoders._TABLE_CACHE_MAX
        encoders._TABLE_CACHE_MAX = 3
        try:
            encoders.clear_table_cache()
            for buf, codes in bufs:
                assert np.array_equal(enc.decode(buf, codes.size), codes)
            stats = encoders.table_cache_stats()
            assert stats["size"] <= 3
            assert stats["evictions"] >= 2
            enc.decode(bufs[-1][0], bufs[-1][1].size)
            assert encoders.table_cache_stats()["hits"] > stats["hits"] - 1
        finally:
            encoders._TABLE_CACHE_MAX = old_max
            encoders.clear_table_cache()

    @needs_reference
    def test_handle_fields_equal_the_references(self):
        from repro.core import encoders as r_enc

        codes = np.random.default_rng(8).integers(-300, 300, 7000)
        buf = r_enc.HuffmanEncoder().encode(codes)
        ours, theirs = encoders.huffman_decode_handle(buf), r_enc.huffman_decode_handle(buf)
        assert ours.stream_pos == theirs.stream_pos and np.array_equal(ours.vals, theirs.vals)
        assert np.array_equal(encoders.HuffmanEncoder().decode(buf, codes.size, handle=ours), codes)


# ---------------------------------------------------------------------------
# telemetry gauges
# ---------------------------------------------------------------------------

class TestGauges:
    def test_gauge_set_add_snapshot_prometheus(self):
        reg = telemetry.MetricsRegistry()
        reg.gauge("sz3_serve_queue_depth", 3)
        assert reg.gauge_add("sz3_serve_queue_depth", 2) == 5.0
        assert reg.gauge_add("sz3_serve_queue_depth", -5) == 0.0
        reg.gauge("sz3_serve_pages", 7)
        assert reg.snapshot()["gauges"]["sz3_serve_pages"] == 7.0
        text = reg.prometheus_text()
        assert "# TYPE sz3_serve_pages gauge" in text
        assert "sz3_serve_pages 7" in text
        reg.reset()
        assert reg.snapshot()["gauges"] == {}


# ---------------------------------------------------------------------------
# decode-state cache
# ---------------------------------------------------------------------------

class TestDecodeStateCache:
    def test_index_identity_and_hit(self, container):
        _, blob = container
        cache = DecodeStateCache(max_entries=4)
        assert cache.index_for(blob) is cache.index_for(blob)
        s = cache.stats()
        assert s["hits"] == 1 and s["misses"] == 1

    def test_lru_eviction_under_bound(self):
        comp = tc.sz3_chunked(chunk_bytes=4096, device=CPU)
        blobs = [comp.compress(_field(seed=s), ABS).blob for s in range(4)]
        assert len({blob_key(b) for b in blobs}) == 4
        cache = DecodeStateCache(max_entries=2)
        for b in blobs:
            cache.index_for(b)
        s = cache.stats()
        assert s["entries"] == 2 and s["evictions"] == 2
        cache.index_for(blobs[-1])
        assert cache.stats()["hits"] == 1
        cache.index_for(blobs[0])
        assert cache.stats()["misses"] == 5

    def test_chunk_result_cache_budget(self, container):
        _, blob = container
        idx = tc.parse_chunked_index(blob)
        arrs = [_chunk(blob, c, parsed=idx) for c in range(3)]
        budget = arrs[0].numel() * arrs[0].element_size() * 2  # room for two chunks, not three
        cache = DecodeStateCache(max_entries=4, max_chunk_bytes=budget)
        for c, a in enumerate(arrs):
            cache.put_chunk(blob, c, a)
        s = cache.stats()
        assert s["chunk_entries"] == 2 and s["chunk_evictions"] == 1
        assert s["chunk_bytes"] <= budget
        assert cache.get_chunk(blob, 0) is None
        hot = cache.get_chunk(blob, 2)
        assert hot is arrs[2]  # served without a copy

    def test_invalidate_drops_index_and_chunks(self, container):
        _, blob = container
        cache = DecodeStateCache()
        cache.index_for(blob)
        cache.put_chunk(blob, 0, _chunk(blob, 0))
        cache.invalidate(blob)
        s = cache.stats()
        assert s["entries"] == 0 and s["chunk_entries"] == 0


# ---------------------------------------------------------------------------
# the async service
# ---------------------------------------------------------------------------

class TestOffloadService:
    def test_put_fetch_roundtrip_and_report(self):
        data = _field(seed=5)

        async def run():
            async with _service(workers=2, chunk_bytes=4096) as svc:
                rep = await svc.put("t", "p", data)
                assert rep["n_in"] == data.nbytes and rep["chunks"] > 1
                assert rep["ratio"] == pytest.approx(data.nbytes / rep["n_out"])
                whole = await svc.fetch("t", "p")
                assert isinstance(whole, torch.Tensor) and whole.device.type == "cpu"
                np.testing.assert_allclose(whole.numpy(), data, atol=1e-3)
                rep16 = await svc.put("t", "h", torch.from_numpy(data).to(torch.bfloat16))
                assert rep16["n_in"] == data.size * 2  # the page's own dtype

        asyncio.run(run())

    def test_concurrent_fetches_byte_identical_to_serial(self, container):
        _, blob = container
        n = tc.parse_chunked_index(blob).n_chunks
        serial = [_chunk(blob, c) for c in range(n)]

        async def run():
            async with _service(workers=4, coalesce_ms=1.0) as svc:
                await svc.put_compressed("t", "p", blob)
                outs = await asyncio.gather(*[svc.fetch("t", "p", c) for c in range(n)])
                for a, b in zip(outs, serial):
                    assert a.dtype == b.dtype and torch.equal(a, b)

        asyncio.run(run())

    def test_coalesced_equals_unbatched(self, container):
        _, blob = container
        n = tc.parse_chunked_index(blob).n_chunks
        order = list(np.random.default_rng(7).integers(0, n, 24))

        async def run():
            telemetry.reset_metrics()
            async with _service(workers=2, coalesce_ms=3.0) as svc:
                await svc.put_compressed("t", "p", blob)
                batched = await asyncio.gather(*[svc.fetch("t", "p", int(c)) for c in order])
            async with _service(workers=2, coalesce_ms=0.0) as svc0:
                await svc0.put_compressed("t", "p", blob)
                unbatched = await asyncio.gather(*[svc0.fetch("t", "p", int(c)) for c in order])
            for a, b in zip(batched, unbatched):
                assert torch.equal(a, b)
            counters = telemetry.METRICS.snapshot()["counters"]
            assert counters["sz3_serve_batches_total"] < 2 * len(order)
            assert counters["sz3_serve_batched_requests_total"] >= 2 * len(order)

        asyncio.run(run())

    def test_fault_isolated_to_owning_request(self, container):
        _, blob = container
        idx = tc.parse_chunked_index(blob)
        bad = _corrupt_chunk(blob, idx, chunk=3)

        async def run():
            async with _service(workers=2, coalesce_ms=2.0) as svc:
                await svc.put_compressed("t", "bad", bad)
                results = await asyncio.gather(
                    *[svc.fetch("t", "bad", c) for c in range(5)], return_exceptions=True
                )
                for c, r in enumerate(results):
                    if c == 3:
                        assert isinstance(r, OffloadError)
                        assert r.cause_type == "IntegrityError"
                        assert r.chunk == 3 and r.chunk_index == 3
                        assert r.tenant == "t" and r.page == "bad"
                    else:
                        assert isinstance(r, torch.Tensor) and torch.equal(r, _chunk(blob, c))

        asyncio.run(run())

    def test_corrupt_chunk_from_faults_fails_exactly_its_requests(self, container):
        """``faults.corrupt_chunk`` damages one chunk: the requests that read
        it (by index or the whole page) fail, every other one completes."""
        _, blob = container
        bad = faults.corrupt_chunk(blob, 4)

        async def run():
            async with _service(workers=2, coalesce_ms=2.0) as svc:
                await svc.put_compressed("t", "p", bad)
                reqs = [4, 0, None, 4, 5, 1]
                results = await asyncio.gather(*[svc.fetch("t", "p", c) for c in reqs], return_exceptions=True)
            failed = [c for c, r in zip(reqs, results) if isinstance(r, OffloadError)]
            assert failed == [4, None, 4]

        asyncio.run(run())

    def test_service_lru_eviction_under_bound(self):
        comp = tc.sz3_chunked(chunk_bytes=4096, device=CPU)
        blobs = [comp.compress(_field(seed=10 + s), ABS).blob for s in range(3)]

        async def run():
            async with _service(workers=2, cache_entries=2) as svc:
                for i, b in enumerate(blobs):
                    await svc.put_compressed("t", f"p{i}", b)
                s = svc.cache.stats()
                assert s["entries"] == 2 and s["evictions"] >= 1
                out = await svc.fetch("t", "p0", 0)
                assert torch.equal(out, _chunk(blobs[0], 0))

        asyncio.run(run())

    def test_evict_and_unknown_page(self, container):
        _, blob = container

        async def run():
            async with _service(workers=1) as svc:
                await svc.put_compressed("t", "p", blob)
                assert await svc.evict("t", "p") is True
                assert await svc.evict("t", "p") is False
                with pytest.raises(OffloadError):
                    await svc.fetch("t", "p", 0)

        asyncio.run(run())

    def test_queue_depth_gauge_returns_to_zero(self, container):
        _, blob = container

        async def run():
            telemetry.reset_metrics()
            async with _service(workers=2, coalesce_ms=1.0) as svc:
                await svc.put_compressed("t", "p", blob)
                await asyncio.gather(*[svc.fetch("t", "p", c) for c in range(6)])
            assert telemetry.METRICS.gauge_value("sz3_serve_queue_depth") == 0.0
            hist = telemetry.METRICS.snapshot()["histograms"]
            assert hist["sz3_serve_request_seconds"]["count"] == 6

        asyncio.run(run())

    def test_process_executor_smoke(self, container):
        data, blob = container

        async def run():
            async with _service(workers=2, executor="process", coalesce_ms=1.0, chunk_bytes=4096) as svc:
                await svc.put_compressed("t", "p", blob)
                outs = await asyncio.gather(*[svc.fetch("t", "p", c) for c in range(3)])
                for c, a in enumerate(outs):
                    assert isinstance(a, torch.Tensor) and torch.equal(a, _chunk(blob, c))
                rep = await svc.put("t", "q", data)
                assert svc._pages[("t", "q")] == blob and rep["n_in"] == data.nbytes

        asyncio.run(run())

    def test_service_survives_two_event_loops(self, container):
        _, blob = container
        svc = _service(workers=1, coalesce_ms=0.5)

        async def put():
            await svc.put_compressed("t", "p", blob)

        async def fetch():
            out = await svc.fetch("t", "p", 0)
            assert torch.equal(out, _chunk(blob, 0))
            await svc.close()

        asyncio.run(put())
        asyncio.run(fetch())

    def test_rejects_bad_options_and_default_device_without_a_card(self):
        with pytest.raises(ValueError):
            _service(executor="fiber")
        with pytest.raises(ValueError):
            _service(verify="sometimes")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                OffloadService()


# ---------------------------------------------------------------------------
# against the reference service
# ---------------------------------------------------------------------------

def _drive(svc_cls, pages, requests, **kw):
    """Put ``pages``, then send ``requests`` ((tenant, page, chunk) each)
    concurrently; returns the blobs, the results and the metric names."""

    async def run():
        async with svc_cls(workers=2, chunk_bytes=8192, coalesce_ms=1.0, **kw) as svc:
            for (tenant, page), data in pages.items():
                await svc.put(tenant, page, data)
            blobs = dict(svc._pages)
            results = await asyncio.gather(*[svc.fetch(*r) for r in requests], return_exceptions=True)
            return blobs, results, svc.stats()

    return asyncio.run(run())


@needs_reference
@pytest.mark.parametrize("executor", ["thread", "process"])
def test_same_requests_same_blobs_and_chunks_as_the_reference(executor):
    pages = {("a", "k0"): _field((64, 128), 1), ("a", "v0"): _field((64, 128), 2),
             ("b", "k0"): np.random.default_rng(3).standard_normal((32, 256)).astype(np.float32)}
    rng = np.random.default_rng(4)
    requests = [(t, p, int(rng.integers(0, 4))) for _ in range(8) for (t, p) in pages] + [("a", "v0", None)]
    r_tel.reset_metrics()
    telemetry.reset_metrics()
    rblobs, rres, rstats = _drive(r_off.OffloadService, pages, requests, executor=executor)
    tblobs, tres, tstats = _drive(OffloadService, pages, requests, executor=executor, device=CPU)
    assert tblobs == rblobs
    for r, t in zip(rres, tres):
        assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), np.asarray(r))
    assert tstats["pages"] == rstats["pages"]
    if executor == "thread":
        assert tstats["index_cache"] == rstats["index_cache"]
    rsnap, tsnap = r_tel.METRICS.snapshot(), telemetry.METRICS.snapshot()
    serve = lambda snap, part: sorted(k for k in snap[part] if k.startswith("sz3_serve"))  # noqa: E731
    for part in ("counters", "gauges", "histograms"):
        assert serve(tsnap, part) == serve(rsnap, part)
    assert tsnap["counters"]["sz3_serve_puts_total"] == rsnap["counters"]["sz3_serve_puts_total"] == 3
    for blob in tblobs.values():
        assert blob_key(blob) == r_off.blob_key(blob)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("executor", ["thread", "process"])
def test_cuda_service_pages_on_the_card(executor):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import lorenzo as lorenzo_kernels

    data = torch.from_numpy(_field((256, 1024), 6)).cuda()  # 16-row chunks take the kernel route

    async def run():
        async with OffloadService(workers=2, executor=executor) as svc:
            lorenzo_kernels.reset_launches()
            await svc.put("t", "p", data)
            blob = svc._pages[("t", "p")]
            outs = await asyncio.gather(*[svc.fetch("t", "p", c) for c in range(4)], svc.fetch("t", "p"))
            return blob, outs

    blob, outs = asyncio.run(run())
    put_launches = lorenzo_kernels.LAUNCHES["encode_2d"]
    plain = tc.sz3_chunked(chunk_bytes=1 << 16, route="force", device=CPU).compress(data.cpu(), ABS).blob
    assert blob == plain
    picks = [c["pipeline"] for c in tc.parse_header(blob)[0]["chunks"]]
    assert picks.count("sz3_lorenzo") > 0
    if executor == "thread":  # a spawned worker counts its launches in its own process
        assert put_launches == picks.count("sz3_lorenzo")
    idx = tc.parse_chunked_index(blob)
    for c, out in enumerate(outs[:4]):
        off, ln = idx.bounds[c]
        want = tc.decompress(blob[idx.body_off + off : idx.body_off + off + ln], device=CPU, route="force")
        assert out.is_cuda and torch.equal(out.cpu(), want)
    assert outs[4].is_cuda and float((outs[4] - data).abs().max()) <= 1e-3
