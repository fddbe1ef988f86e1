"""The port's v2 chunked engine and its two new paper pipelines held against
the JAX package, on the CPU.

* the block sums that decide the regression predictors' bytes round as
  numpy rounds them (numpy's pairwise order, probed);
* ``RegressionPredictor``, ``InterpolationPredictor`` (linear and cubic) and
  ``CompositePredictor`` give the reference's codes, meta and decoded arrays
  on 1-D, 2-D and 3-D inputs, shapes not divisible by the block size,
  constant blocks, NaN and inf points and planar ramps (rint ties), and the
  ``sz3_lr``/``sz3_interp`` blobs are the reference's byte for byte;
* ``select_pipeline`` picks and scores as the reference does on a corpus
  where each default candidate wins somewhere, in both speed tiers;
* ``sz3_chunked`` blobs are the reference's byte for byte (ABS and REL, two
  chunk sizes, one and two workers); the stream API, random access, the
  committed v2 fixtures and salvage of a damaged chunk behave as pinned;
  each package decodes the other's v2 blobs within the bound;
* under pointwise-relative bounds (PW_REL), ``sz3_pwr`` (v4), ``sz3_chunked``
  and the stream API write the reference's bytes (one and four workers), the
  pointwise bound holds, and the committed v4 fixtures decode bit-equal to
  the reference or as ``tests/data/faults/manifest.json`` pins them.
"""
import io
import json
import pathlib
import sys
import threading
import types

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import chunking as r_ch
from repro.core import integrity as r_int
from repro.core import predictors as r_pred
from repro.core import quantizers as r_quant

import repro_torch.core as tc
from repro_torch.core import chunking as t_ch
from repro_torch.core import integrity as t_int
from repro_torch.core import predictors as t_pred
from repro_torch.core import quantizers as t_quant
from repro_torch.kernels import _build

DATA = pathlib.Path(__file__).parent / "data"
FAULTS = DATA / "faults"
CPU = "cpu"


def _fields():
    rng = np.random.default_rng(14)
    yy, xx = np.mgrid[0:37, 0:41]
    f2 = (np.sin(yy / 5.0) * np.cos(xx / 3.0) + 0.01 * rng.normal(size=yy.shape)).astype(np.float32)
    nan = f2.copy()
    nan[3, 4], nan[10, 11], nan[20, 30] = np.nan, np.inf, -np.inf
    const = np.full((30, 25), 3.5, np.float32)
    const[:12, :12] = -1.25  # constant blocks of two values
    # a plane on the 2*eb grid at eb = 0.125: coefficients land on rint ties
    ramp = (0.5 * yy + 0.25 * xx + 0.125).astype(np.float32)
    f3 = np.cumsum(rng.normal(size=(7, 9, 13)), axis=2).astype(np.float32)
    f3n = f3.copy()
    f3n[1, 2, 3] = np.nan
    f1 = np.cumsum(rng.normal(size=1001) * 0.1).astype(np.float32)
    f64 = np.cumsum(rng.normal(size=(20, 33)), axis=1)
    return {"2d": f2, "nan": nan, "const": const, "ramp": ramp, "3d": f3, "3d-nan": f3n, "1d": f1, "f64": f64}


FIELDS = _fields()
EBS = {"2d": 1e-3, "nan": 1e-3, "const": 1e-3, "ramp": 0.125, "3d": 1e-2, "3d-nan": 1e-2, "1d": 1e-3, "f64": 1e-3}
PREDICTORS = {
    "regression": (lambda: r_pred.RegressionPredictor(), lambda: t_pred.RegressionPredictor()),
    "composite": (lambda: r_pred.CompositePredictor(), lambda: t_pred.CompositePredictor()),
    "interp-linear": (lambda: r_pred.InterpolationPredictor("linear"), lambda: t_pred.InterpolationPredictor("linear")),
    "interp-cubic": (lambda: r_pred.InterpolationPredictor("cubic"), lambda: t_pred.InterpolationPredictor("cubic")),
}


@pytest.fixture(autouse=True)
def reference_verifies_crc32c(monkeypatch):
    """Where ``google_crc32c`` is missing, the JAX package cannot verify the
    committed fixtures' CRC32C trailers (ROADMAP queue 3); lend it the port's
    numpy CRC32C, which the pipeline tests hold equal to the module's."""
    if r_int._crc32c_mod is None:
        monkeypatch.setattr(r_int, "_crc32c_mod", types.SimpleNamespace(
            extend=lambda value, data: t_int.crc32c_numpy(data, value)))


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _confs(mode, eb):
    return (
        rc.CompressionConfig(mode=rc.ErrorBoundMode(mode), eb=eb),
        tc.CompressionConfig(mode=tc.ErrorBoundMode(mode), eb=eb),
    )


# ---------------------------------------------------------------------------
# numpy's summation order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6,), (2,), (2, 2), (2, 2, 2), (6, 6), (3, 3, 3), (6, 6, 6), (8, 8), (129,), (300,)])
def test_block_sums_round_as_numpy_sums(shape):
    rng = np.random.default_rng(len(shape) * 1000 + int(np.prod(shape)))
    x = rng.standard_normal((4000,) + shape) * 10.0 ** rng.uniform(-6, 6, (4000,) + (1,) * len(shape))
    axes = tuple(range(1, x.ndim))
    got = t_pred.block_sums(torch.from_numpy(x)).numpy()
    _same_bits(got, x.sum(axis=axes))
    _same_bits(t_quant.true_div(torch.from_numpy(got), float(np.prod(shape))).numpy(), x.mean(axis=axes))
    # a sequential sum would not do: the order is observable
    if int(np.prod(shape)) >= 8:
        seq = np.cumsum(x.reshape(4000, -1), axis=1)[:, -1]
        assert not np.array_equal(_bits(seq), _bits(x.sum(axis=axes)))


def test_negative_zero_sums_to_positive_zero_as_in_numpy():
    x = torch.full((3, 36), -0.0, dtype=torch.float64)
    got = t_quant.pairwise_rowsum(x).numpy()
    _same_bits(got, np.full((3, 36), -0.0).sum(axis=1))


def test_numpy_sum_order_probe_passes_here():
    t_quant.check_numpy_sum_order()


def test_rint_int64_takes_x86_numpy_cast_for_non_finite():
    v = np.asarray([np.nan, np.inf, -np.inf, 2.0**63, -(2.0**63), 2.5, -3.5, 1e300])
    with np.errstate(invalid="ignore"):
        want = np.rint(v).astype(np.int64)
    if want[0] != np.iinfo(np.int64).min:
        pytest.skip("this CPU's float->int64 cast is not x86's")
    np.testing.assert_array_equal(t_pred.rint_int64(torch.from_numpy(v)).numpy(), want)


# ---------------------------------------------------------------------------
# the predictors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("which", list(PREDICTORS))
def test_predictor_codes_meta_and_decode_equal_reference(which, field):
    x = FIELDS[field]
    eb = EBS[field]
    make_r, make_t = PREDICTORS[which]
    rconf, tconf = rc.CompressionConfig(), tc.CompressionConfig()
    rq, tq = r_quant.LinearScaleQuantizer(), t_quant.LinearScaleQuantizer()
    rq.begin(eb, x.dtype)
    rcodes, rmeta = make_r().compress(x, rq, rconf)
    tq.begin(eb, torch.from_numpy(x).dtype)
    tcodes, tmeta = make_t().compress(torch.from_numpy(x), tq, tconf)
    np.testing.assert_array_equal(tcodes.numpy().astype(np.int64), rcodes.astype(np.int64))
    assert tmeta == {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in rmeta.items()}
    assert tq.save() == rq.save()
    # decode the reference's codes in the port
    payload = rq.save()
    rq2, tq2 = r_quant.LinearScaleQuantizer(), t_quant.LinearScaleQuantizer()
    rq2.begin(eb, x.dtype)
    rq2.load(payload)
    tq2.begin(eb, torch.from_numpy(x).dtype)
    tq2.load(payload)
    want = make_r().decompress(rcodes, x.shape, x.dtype, rq2, rconf, rmeta)
    got = make_t().decompress(
        torch.from_numpy(rcodes.astype(np.int32)), x.shape, torch.from_numpy(x).dtype, tq2, tconf, tmeta
    )
    _same_bits(got.numpy(), want)
    if which == "regression" and not np.isfinite(x).all():
        # a fault both packages share (ROADMAP queue 3): a non-finite block's
        # coefficient casts to INT64_MIN, whose delta passes the code-range
        # test (|INT64_MIN| wraps negative) and is stored wrapped, so the
        # decoded plane, and the block, are wrong
        return
    fin = np.isfinite(x)
    assert np.all(np.abs(want[fin].astype(np.float64) - x[fin]) <= eb)


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("pipeline,kw", [("sz3_lr", {}), ("sz3_interp", {}), ("sz3_interp", {"kind": "linear"})])
@pytest.mark.parametrize("mode", ["abs", "rel"])
def test_paper_pipeline_blobs_equal_reference(pipeline, kw, field, mode):
    x = FIELDS[field]
    rconf, tconf = _confs(mode, EBS[field] if mode == "abs" else 1e-4)
    ref = rc.PIPELINES[pipeline](**kw).compress(x, rconf).blob
    port = tc.PIPELINES[pipeline](device=CPU, **kw).compress(x, tconf).blob
    assert port == ref
    _same_bits(tc.decompress(ref, device=CPU).numpy(), rc.decompress(ref))


def test_v1_lr_fixture_decodes_like_the_reference():
    blob = (DATA / "v1_lr_rel.sz3").read_bytes()
    assert tc.parse_header(blob)[0]["spec"]["predictor"] == "composite"
    _same_bits(tc.decompress(blob, device=CPU).numpy(), rc.decompress(blob))


THIN_SHAPES = [(1, 5000), (5000, 1), (1, 1, 5000), (2, 5000)]


def _thin_field(shape):
    rng = np.random.default_rng(sum(shape))
    return np.cumsum(rng.normal(size=shape), axis=-1).astype(np.float32)


def _lr_codes_cap(pshape, b=6):
    """What CompositePredictor writes at most: every axis padded to a
    multiple of b, b**ndim codes and ndim + 1 coefficients per block."""
    blocks = int(np.prod([-(-s // b) for s in pshape]))
    return blocks * (b ** len(pshape) + len(pshape) + 1)


@pytest.mark.parametrize("shape", THIN_SHAPES)
def test_thin_lr_blobs_equal_reference_and_decode_in_the_port(shape):
    """A field with an axis of 1 or 2 makes ``sz3_lr`` write more codes
    than 2 n + 4096; the reference's decoder refuses its own blob there
    (ROADMAP queue 3), the port's decodes it within the bound."""
    x = _thin_field(shape)
    rconf, tconf = _confs("abs", 1e-2)
    ref = rc.sz3_lr().compress(x, rconf).blob
    assert tc.sz3_lr(device=CPU).compress(x, tconf).blob == ref
    header = tc.parse_header(ref)[0]
    assert 2 * x.size + 4096 < header["n_codes"] <= _lr_codes_cap(shape)
    out = tc.decompress(ref, device=CPU).numpy()
    assert out.shape == x.shape and out.dtype == np.float32
    assert np.max(np.abs(out.astype(np.float64) - x)) <= header["abs_eb"]


@pytest.mark.parametrize("shape", [(1, 5000), (1, 1, 5000)])
def test_thin_lr_guard_refuses_one_code_past_the_cap(shape):
    from repro_torch.core import pipeline as t_pipe

    blob = tc.sz3_lr(device=CPU).compress(_thin_field(shape), _confs("abs", 1e-2)[1]).blob
    header, off = tc.parse_header(blob)
    body = t_pipe.container_body(blob, off)
    header = {k: v for k, v in header.items() if k != "itg"}
    header["n_codes"] = _lr_codes_cap(header["pshape"]) + 1
    with pytest.raises(tc.ContainerError, match="n_codes"):
        tc.decompress(t_pipe.pack_container(header, body), device=CPU)


def test_default_chunked_lr_column_round_trips_in_the_port():
    """Default ``sz3_chunked()`` picks ``sz3_lr`` for a smooth (100000, 1)
    column; the port decodes the blob it writes, byte for byte the
    reference's."""
    x = np.sin(np.arange(100000) / 700.0).astype(np.float32).reshape(-1, 1)
    rconf, tconf = _confs("abs", 1e-3)
    res = tc.sz3_chunked(device=CPU).compress(x, tconf, with_stats=True)
    assert "sz3_lr" in [c["pipeline"] for c in res.meta["chunks"]]
    assert res.blob == rc.sz3_chunked().compress(x, rconf).blob
    out = tc.decompress(res.blob, device=CPU).numpy()
    assert out.shape == x.shape
    assert np.max(np.abs(out.astype(np.float64) - x)) <= 1e-3


def test_estimators_equal_reference_exactly():
    x = FIELDS["2d"]
    conf, rconf = tc.CompressionConfig(), rc.CompressionConfig()
    for t, r in ((t_pred.RegressionPredictor(), r_pred.RegressionPredictor()),
                 (t_pred.CompositePredictor(), r_pred.CompositePredictor()),
                 (t_pred.InterpolationPredictor(), r_pred.InterpolationPredictor())):
        assert t.estimate_error(torch.from_numpy(x), 1e-3, conf) == r.estimate_error(x, 1e-3, rconf)
    np.testing.assert_array_equal(t_pred.interp_residuals(x), r_pred.interp_residuals(x))
    np.testing.assert_array_equal(t_pred.regression_residuals(x, 1e-3, 6), r_pred.regression_residuals(x, 1e-3, 6))


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def _corpus():
    """Chunks where the reference picks each default candidate: blocky
    piecewise-constant data (sz3_lr), a smooth field (sz3_interp), a rough
    random walk at a coarse bound (sz3_lorenzo), constants (near-ties)."""
    rng = np.random.default_rng(3)
    blocky = (np.kron(rng.normal(size=(16, 11)) * 10, np.ones((6, 6)))[:96, :64]
              + rng.normal(size=(96, 64)) * 0.2).astype(np.float32)
    yy, xx = np.mgrid[0:96, 0:64] / 16.0
    smooth = (np.sin(yy) * np.cos(1.3 * xx)).astype(np.float32)
    walk = np.cumsum(rng.normal(size=(96, 64)), axis=1).astype(np.float32)
    const = np.full((96, 64), 2.0, np.float32)
    series = np.cumsum(rng.normal(size=20000) * 0.05).astype(np.float32)
    return [(blocky, 0.1), (smooth, 1e-3), (walk, 0.5), (walk, 1e-3), (const, 1e-3), (series, 1e-3),
            (blocky[:7, :9], 0.1), (smooth[None, :40, :40].repeat(3, 0), 1e-3)]


@pytest.mark.parametrize("speed_tier", ["ratio", "throughput"])
def test_select_pipeline_picks_and_scores_equal_reference(speed_tier):
    rconf, tconf = rc.CompressionConfig(), tc.CompressionConfig()
    cands = r_ch.DEFAULT_CANDIDATES + (("sz3_fast",) if speed_tier == "throughput" else ())
    winners = set()
    for x, eb in _corpus():
        for sl in r_ch.chunk_slices(x.shape, 4, 4096):
            chunk = x[sl]
            rwin, rscores = r_ch.select_pipeline(chunk, eb, rconf, cands, speed_tier=speed_tier)
            twin, tscores = t_ch.select_pipeline(torch.from_numpy(chunk), eb, tconf, cands, speed_tier=speed_tier)
            assert (twin, tscores) == (rwin, rscores)
            winners.add(rwin)
    if speed_tier == "ratio":
        assert winners == set(r_ch.DEFAULT_CANDIDATES)  # the corpus covers every entrant


def test_sample_block_equals_reference():
    for shape in [(5000,), (64, 64), (3, 4000), (9, 9, 9), (1, 4097), (30, 30, 30), (8, 8, 64)]:
        x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        _same_bits(t_ch._sample_block(torch.from_numpy(x)).numpy(), r_ch._sample_block(x))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine_inputs():
    rng = np.random.default_rng(7)
    blocky = (np.kron(rng.normal(size=(16, 11)) * 10, np.ones((6, 6)))[:90, :64]
              + rng.normal(size=(90, 64)) * 0.2).astype(np.float32)
    yy, xx = np.mgrid[0:90, 0:64] / 16.0
    smooth = (np.sin(yy) * np.cos(1.3 * xx) + 0.001 * rng.normal(size=yy.shape)).astype(np.float32)
    return {
        "2d": np.concatenate([blocky, smooth], axis=0),
        "1d": np.cumsum(rng.normal(size=12003) * 0.05).astype(np.float32),
    }


ENGINE = _engine_inputs()


@pytest.mark.parametrize("field", list(ENGINE))
@pytest.mark.parametrize("chunk_bytes", [2048, 1 << 22])
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("mode", ["abs", "rel"])
def test_chunked_blob_equals_reference(field, chunk_bytes, workers, mode):
    x = ENGINE[field]
    rconf, tconf = _confs(mode, 0.05 if mode == "abs" else 1e-4)
    ref = rc.sz3_chunked(chunk_bytes=chunk_bytes, workers=workers).compress(x, rconf, with_stats=True)
    port = tc.sz3_chunked(chunk_bytes=chunk_bytes, workers=workers, device=CPU).compress(x, tconf, with_stats=True)
    assert [c["pipeline"] for c in port.meta["chunks"]] == [c["pipeline"] for c in ref.meta["chunks"]]
    assert port.blob == ref.blob
    out = tc.decompress(ref.blob, workers=workers, device=CPU).numpy()
    _same_bits(out, rc.decompress(ref.blob))


def test_engine_corpus_picks_every_candidate():
    picks = set()
    for x in ENGINE.values():
        res = rc.sz3_chunked(chunk_bytes=2048).compress(x, _confs("abs", 0.05)[0], with_stats=True)
        picks |= {c["pipeline"] for c in res.meta["chunks"]}
    assert picks == set(r_ch.DEFAULT_CANDIDATES)


@pytest.mark.parametrize("shape", [(), (0,), (1,), (5, 0)])
def test_degenerate_shapes_equal_reference(shape):
    x = np.full(shape, 1.5, np.float32)
    rconf, tconf = _confs("abs", 1e-3)
    ref = rc.sz3_chunked(chunk_bytes=2048).compress(x, rconf).blob
    port = tc.sz3_chunked(chunk_bytes=2048, device=CPU).compress(x, tconf).blob
    assert port == ref
    _same_bits(tc.decompress(port, device=CPU).numpy(), rc.decompress(port))


def test_throughput_tier_equals_reference():
    x = ENGINE["1d"]
    rconf, tconf = _confs("rel", 1e-4)
    ref = rc.sz3_chunked(chunk_bytes=8192, speed_tier="throughput").compress(x, rconf, with_stats=True)
    port = tc.sz3_chunked(chunk_bytes=8192, speed_tier="throughput", device=CPU).compress(x, tconf, with_stats=True)
    assert port.blob == ref.blob
    assert "sz3_fast" in {c["pipeline"] for c in ref.meta["chunks"]}


def test_forced_kernel_route_decodes_in_both_packages():
    """``route="force"`` sends the Lorenzo chunks through the kernels' plain
    versions (the bytes a card writes); both packages decode them alike."""
    x = ENGINE["1d"]
    tconf = _confs("abs", 1e-3)[1]
    res = tc.sz3_chunked(chunk_bytes=16384, route="force", device=CPU).compress(x, tconf, with_stats=True)
    picks = [c["pipeline"] for c in res.meta["chunks"]]
    assert "sz3_lorenzo" in picks
    want = rc.decompress(res.blob)
    _same_bits(tc.decompress(res.blob, device=CPU).numpy(), want)
    assert np.max(np.abs(want.astype(np.float64) - x)) <= 1e-3
    # the kernel route takes chunks of at least 4096 elements; the 3811-element
    # tail chunk takes the host route, as in the JAX package
    body_off = tc.parse_header(res.blob)[1]
    routes = []
    for c in res.meta["chunks"]:
        chunk = res.blob[body_off + c["off"] : body_off + c["off"] + c["len"]]
        routes.append((c["n0"], tc.parse_header(chunk)[0]["pred_meta"].get("device")))
    assert routes == [(4096, 1), (4096, 1), (3811, None)]


def test_stream_reassembles_the_one_shot_blob_and_random_access():
    x = ENGINE["2d"]
    tconf = _confs("rel", 1e-4)[1]
    one = tc.sz3_chunked(chunk_bytes=4096, device=CPU).compress(x, tconf).blob
    frames = list(tc.compress_stream(x, tconf, chunk_bytes=4096, workers=2, device=CPU))
    assert tc.frames_to_blob(frames) == one
    assert r_ch.frames_to_blob(frames) == one
    buf = io.BytesIO()
    tc.write_frames(frames, buf)
    buf.seek(0)
    assert list(tc.read_frames(buf)) == frames
    parts = [p.numpy() for p in tc.decompress_stream(frames, workers=2, device=CPU)]
    full = tc.decompress(one, device=CPU).numpy()
    _same_bits(np.concatenate(parts, axis=0), full)
    idx = tc.parse_chunked_index(one)
    r0 = 0
    for i in range(idx.n_chunks):
        part = tc.decompress_chunk(one, i, parsed=idx, device=CPU).numpy()
        _same_bits(part, full[r0 : r0 + part.shape[0]])
        r0 += part.shape[0]
    assert r0 == x.shape[0]


def test_cross_package_decode_within_bound():
    for field, x in ENGINE.items():
        for mode, eb in (("abs", 1e-3), ("rel", 1e-4)):
            rconf, tconf = _confs(mode, eb)
            port = tc.sz3_chunked(chunk_bytes=8192, device=CPU).compress(x, tconf).blob
            ref = rc.sz3_chunked(chunk_bytes=8192).compress(x, rconf).blob
            abs_eb = eb if mode == "abs" else eb * float(x.max() - x.min())
            for out in (rc.decompress(port), tc.decompress(ref, device=CPU).numpy()):
                assert out.shape == x.shape and out.dtype == x.dtype
                assert np.max(np.abs(out.astype(np.float64) - x)) <= abs_eb


def test_v2_fixtures_decode_as_pinned():
    for name in ("v2_chunked_rel", "v2_quality_psnr"):
        blob = (DATA / f"{name}.sz3").read_bytes()
        header = tc.parse_header(blob)[0]
        assert header["kind"] == "chunked"
        _same_bits(tc.decompress(blob, workers=2, device=CPU).numpy(), np.load(DATA / f"{name}.npy"))
    assert "q" in tc.parse_header((DATA / "v2_quality_psnr.sz3").read_bytes())[0]["chunks"][0]


def _fault_fixture_as_pinned(name, workers):
    man = json.loads((FAULTS / "manifest.json").read_text())[name]
    pristine = (FAULTS / f"{name}.sz3").read_bytes()
    want = np.load(FAULTS / f"{name}.npy")
    _same_bits(tc.decompress(pristine, workers=workers, device=CPU).numpy(), want)
    corrupt = (FAULTS / f"{name}_corrupt.sz3").read_bytes()
    with pytest.raises(tc.IntegrityError) as err:
        tc.decompress(corrupt, workers=workers, device=CPU)
    assert err.value.chunk_index == man["damaged_chunks"][0]
    data, report = tc.decompress(corrupt, verify="salvage", workers=workers, device=CPU)
    rdata, rreport = rc.decompress(corrupt, verify="salvage")
    assert report.total_chunks == man["n_chunks"]
    assert [d.index for d in report.damage] == man["damaged_chunks"]
    assert [(d.index, d.start, d.stop, d.reason) for d in report.damage] == [
        (d.index, d.start, d.stop, d.reason) for d in rreport.damage
    ]
    assert report.recovered == rreport.recovered
    _same_bits(data.numpy(), rdata)
    # random access reads the intact chunks and names the damaged one
    for i in range(man["n_chunks"]):
        if i in man["damaged_chunks"]:
            with pytest.raises(tc.IntegrityError):
                tc.decompress_chunk(corrupt, i, device=CPU)
        else:
            _same_bits(tc.decompress_chunk(corrupt, i, device=CPU).numpy(),
                       r_ch.decompress_chunk(corrupt, i))


@pytest.mark.parametrize("workers", [1, 2])
def test_v2_fault_fixture_as_the_manifest_pins_it(workers):
    _fault_fixture_as_pinned("v2_chunked", workers)


@pytest.mark.parametrize("workers", [1, 2])
def test_v4_fault_fixture_as_the_manifest_pins_it(workers):
    _fault_fixture_as_pinned("v4_pwr", workers)


def test_v4_conformance_fixture_decodes_like_the_reference():
    blob = (DATA / "v4_pwr.sz3").read_bytes()
    assert tc.parse_header(blob)[0]["kind"] == "pwr"
    out = tc.decompress(blob, device=CPU).numpy()
    _same_bits(out, rc.decompress(blob))
    _same_bits(out, np.load(DATA / "v4_pwr.npy"))
    index = tc.parse_chunked_index(blob)
    for i in range(index.n_chunks):
        _same_bits(tc.decompress_chunk(blob, i, parsed=index, device=CPU).numpy(), r_ch.decompress_chunk(blob, i))


# ---------------------------------------------------------------------------
# pointwise-relative bounds: sz3_pwr (v4), sz3_chunked and the stream API
# ---------------------------------------------------------------------------

def _signed(x, seed):
    """A PW_REL input: positive magnitudes with negatives, zeros and
    non-finite values written in."""
    rng = np.random.default_rng(seed)
    y = np.exp(x.astype(np.float64) / 4.0).astype(x.dtype).reshape(-1)
    pick = rng.permutation(y.size)
    y[pick[: y.size // 5]] *= -1
    y[pick[y.size // 5 : y.size // 5 + 4]] = [0.0, np.nan, np.inf, -np.inf]
    return y.reshape(x.shape)


PWR = {
    "2d": _signed(ENGINE["2d"], 1),
    "1d": _signed(ENGINE["1d"], 2),
    "f64": _signed(FIELDS["f64"], 3),
}


def _pw_bound_holds(out, x, eb):
    x64, o64 = np.asarray(x, np.float64), np.asarray(out, np.float64)
    fin = np.isfinite(x64) & (x64 != 0)
    assert np.all(np.abs(o64[fin] - x64[fin]) <= eb * np.abs(x64[fin]))
    assert np.all(o64[x64 == 0] == 0)
    _same_bits(np.asarray(out)[~np.isfinite(x64)], np.asarray(x)[~np.isfinite(x64)])


@pytest.mark.parametrize("field", list(PWR))
@pytest.mark.parametrize("chunk_bytes", [2048, 1 << 22])
@pytest.mark.parametrize("workers", [1, 4])
def test_pwr_blob_equals_reference(field, chunk_bytes, workers):
    x = PWR[field]
    ref = rc.sz3_pwr(chunk_bytes=chunk_bytes, workers=workers).compress(x, with_stats=True)
    port = tc.sz3_pwr(chunk_bytes=chunk_bytes, workers=workers, device=CPU).compress(x, with_stats=True)
    assert [c["pipeline"] for c in port.meta["chunks"]] == [c["pipeline"] for c in ref.meta["chunks"]]
    assert port.blob == ref.blob
    header = tc.parse_header(port.blob)[0]
    assert (header["v"], header["kind"]) == (4, "pwr")
    out = tc.decompress(ref.blob, workers=workers, device=CPU).numpy()
    _same_bits(out, rc.decompress(port.blob))
    _pw_bound_holds(out, x, 1e-3)


@pytest.mark.parametrize("field", list(PWR))
def test_chunked_and_stream_under_pw_rel_equal_reference(field):
    x = PWR[field]
    rconf, tconf = _confs("pw_rel", 1e-3)
    ref = rc.sz3_chunked(chunk_bytes=2048).compress(x, rconf).blob
    port = tc.sz3_chunked(chunk_bytes=2048, device=CPU).compress(x, tconf).blob
    assert port == ref
    _same_bits(tc.decompress(ref, device=CPU).numpy(), rc.decompress(port))
    r_frames = list(rc.compress_stream(x, rconf, chunk_bytes=2048))
    t_frames = list(tc.compress_stream(x, tconf, chunk_bytes=2048, device=CPU))
    assert t_frames == r_frames
    v4 = tc.frames_to_blob(t_frames)
    assert v4 == rc.frames_to_blob(r_frames)
    assert v4 == tc.sz3_pwr(chunk_bytes=2048, device=CPU).compress(x).blob
    parts = list(tc.decompress_stream(t_frames, device=CPU))
    _same_bits(np.concatenate([p.numpy() for p in parts]), rc.decompress(v4))


def test_pwr_candidates_equal_reference():
    cands = ("sz3_lorenzo", "sz3_transform", "sz3_fast", "sz3_lr", "sz3_truncation", "sz3_aps")
    ref = rc.ChunkedCompressor(candidates=cands)._pwr_candidates()
    assert tc.ChunkedCompressor(candidates=cands, device=CPU)._pwr_candidates() == ref
    assert ref == ("sz3_lorenzo", "sz3_fast", "sz3_lr")
    x = PWR["2d"]
    rconf, tconf = _confs("pw_rel", 1e-3)
    port = tc.sz3_chunked(candidates=cands, chunk_bytes=4096, device=CPU).compress(x, tconf, with_stats=True)
    ref_res = rc.sz3_chunked(candidates=cands, chunk_bytes=4096).compress(x, rconf, with_stats=True)
    assert [c["pipeline"] for c in port.meta["chunks"]] == [c["pipeline"] for c in ref_res.meta["chunks"]]
    assert port.blob == ref_res.blob


def test_pwr_refuses_other_modes():
    with pytest.raises(ValueError, match="pointwise-relative"):
        tc.sz3_pwr(device=CPU).compress(PWR["1d"], tc.CompressionConfig())


def test_sz3_auto_builds_a_chunked_engine_over_auto_candidates():
    eng = t_ch._make_pipeline("sz3_auto", device=CPU)
    assert isinstance(eng, t_ch.ChunkedCompressor) and eng.kind == "chunked"
    assert eng.candidates == tc.AUTO_CANDIDATES == rc.AUTO_CANDIDATES
    assert eng.device == CPU


def test_launch_counter_is_thread_safe():
    counts = {"k": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(counts, "k") for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 16 * 2000
