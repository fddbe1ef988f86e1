"""The paper's customized pipelines in the port, held against the JAX
package on the CPU: GAMESS (§4: ``sz_pastri``, ``sz_pastri_zstd``,
``sz3_pastri``), APS (§5.2: ``sz3_aps``, both branches) and truncation
(§6.2: ``sz3_truncation``), and the modules they are built from.

* same input, same bytes, and each package decodes the other's blobs to the
  same bits; ``sz3_aps``'s low branch also on the kernel route
  (``route="force"``, the plain torch versions, against the reference's
  ``device="force"``, interpret-mode Pallas);
* the encoders (raw, bitpack, the v1-stream Huffman oracle, the fixed
  Huffman table) write the reference's bytes and read its streams;
* ``UnpredAwareQuantizer.save()`` bytes; ``PatternPredictor.detect_period``;
  the ``register`` hooks and ``lossless.effective_backend``;
* ``LorenzoSequentialPredictor`` (the paper-faithful scan, a host loop here,
  a float64 ``jax.lax.scan`` there): codes, blobs and decodes bit for bit
  at <= 4096 elements in 1-D, 2-D and 3-D, with the linear quantizer and
  the unpred-aware one (its aligned mode).

Inputs are made from a seed with numpy at small sizes, with the structure
of ``benchmarks/datasets.py``'s generators.  Tolerance: 0 (bits).  The
``cuda``-marked test runs on a card (``python -m pytest -q -m cuda
tests/test_torch_paper_pipelines.py``) and needs no JAX.
"""
import threading

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import encoders as t_enc
from repro_torch.core import lossless as t_ll
from repro_torch.core import predictors as t_pred
from repro_torch.core import preprocess as t_pre
from repro_torch.core import quantizers as t_quant

try:  # the card's test below needs no JAX
    import repro.core as rc
    from repro.core import encoders as r_enc
    from repro.core import lossless as r_ll
    from repro.core import predictors as r_pred
    from repro.core import preprocess as r_pre
    from repro.core import quantizers as r_quant
except ImportError:  # pragma: no cover - a machine without JAX
    rc = None

CPU = "cpu"


def gamess_like(n_blocks, seed, pattern=96, eb=1e-10, unpred_frac=0.15):
    """ERI-like stream: a periodic pattern scaled per block (log-normal
    scales), residuals a few bins wide, and non-conforming blocks."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, pattern)
    base = np.exp(-6 * t) * np.sin(24 * t) + 0.3 * np.exp(-9 * t) * np.cos(53 * t)
    x = np.exp(rng.normal(-6.0, 2.5, n_blocks))[:, None] * base[None, :]
    x = x + rng.normal(0.0, 15.0 * eb, (n_blocks, pattern))
    bad = rng.random(n_blocks) < unpred_frac
    alt = np.exp(-3 * t) * np.cos(31 * t + 0.7)
    x[bad] += np.exp(rng.normal(-9.0, 1.5, n_blocks))[bad, None] * alt[None, :]
    return np.ascontiguousarray(x.reshape(-1))


def aps_like(frames, h, w, seed):
    """Photon-count stack: Poisson counts under a bright centre, a speckle
    field that drifts slowly in time (strong temporal correlation)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2) / (0.08 * h * w)
    envelope = 40.0 * np.exp(-r2)
    phase = rng.standard_normal((h, w))
    drift = rng.standard_normal((h, w)) * 0.05
    out = np.empty((frames, h, w), np.float32)
    for t in range(frames):
        speckle = np.abs(np.fft.ifft2(np.fft.fft2(np.exp(1j * (phase + t * drift))) * np.exp(-r2)))
        out[t] = rng.poisson(envelope * (0.2 + speckle / max(1e-9, speckle.max()))).astype(np.float32)
    return out


GAMESS = {
    "f64": gamess_like(400, 7),
    "f64_tail": gamess_like(150, 8)[:-37],  # the last block is cut: a tail
    "f32": gamess_like(200, 9).astype(np.float32),
}
APS = aps_like(48, 16, 24, 11)


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _assert_same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _confs(mode, eb):
    return rc.CompressionConfig(mode=rc.ErrorBoundMode(mode), eb=eb), tc.CompressionConfig(
        mode=tc.ErrorBoundMode(mode), eb=eb
    )


def _cross_decode(port, ref):
    for blob in (port, ref):
        _assert_same_bits(tc.decompress(blob, device=CPU).numpy(), rc.decompress(blob))


# ---------------------------------------------------------------------------
# GAMESS: the pastri family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sz_pastri", "sz_pastri_zstd", "sz3_pastri"])
@pytest.mark.parametrize("field", list(GAMESS))
@pytest.mark.parametrize("pattern_size", [None, 96, 50])
def test_pastri_family_same_bytes_and_cross_decode(name, field, pattern_size):
    x = GAMESS[field]
    rconf, tconf = _confs("abs", 1e-10)
    ref = rc.PIPELINES[name](pattern_size=pattern_size).compress(x, rconf).blob
    port = tc.PIPELINES[name](pattern_size=pattern_size, device=CPU).compress(x, tconf).blob
    assert port == ref
    _cross_decode(port, ref)
    out = tc.decompress(port, device=CPU).numpy()
    assert np.max(np.abs(out.astype(np.float64) - x)) <= 1e-10


GAMESS_NONFINITE = GAMESS["f64"].copy()
GAMESS_NONFINITE[[5, 777, 5000, 20000]] = [np.nan, np.nan, -np.inf, np.nan]


@pytest.mark.parametrize("name", ["sz_pastri", "sz_pastri_zstd", "sz3_pastri"])
def test_pastri_family_on_nan_input_same_bytes_and_cross_decode(name):
    """A NaN's prediction error reaches the unpred-aware quantizer's integer
    cast (the reference stores INT64_MIN, ROADMAP queue 3): the port writes
    and reads the same bytes."""
    x = GAMESS_NONFINITE
    rconf, tconf = _confs("abs", 1e-10)
    with np.errstate(invalid="ignore"):
        ref = rc.PIPELINES[name](pattern_size=96).compress(x, rconf).blob
    port = tc.PIPELINES[name](pattern_size=96, device=CPU).compress(x, tconf).blob
    assert port == ref
    _cross_decode(port, ref)


def test_pastri_sections_and_ratio_order():
    """The three code sections of paper Fig 3 sit in the meta, and the
    unpred-aware pipeline beats the two baselines (paper Table 1 order)."""
    x = GAMESS["f64"]
    _, tconf = _confs("abs", 1e-10)
    res = tc.sz3_pastri(pattern_size=96, device=CPU).compress(x, tconf, with_stats=True)
    P, nb = res.meta["P"], res.meta["nb"]
    assert P == 96 and res.meta["sections"] == [P, nb, nb * P]
    names = ("sz3_pastri", "sz_pastri_zstd", "sz_pastri")
    ratios = [tc.PIPELINES[n](pattern_size=96, device=CPU).compress(x, tconf).ratio for n in names]
    assert ratios[0] >= ratios[1] >= ratios[2]


@pytest.mark.parametrize("kind", ["pattern", "noise", "short", "ramp"])
def test_detect_period_matches(kind):
    rng = np.random.default_rng(4)
    x = {
        "pattern": GAMESS["f64"],
        "noise": rng.normal(size=70000),
        "short": rng.normal(size=12),
        "ramp": np.sin(np.arange(5000) * 2 * np.pi / 37.0),
    }[kind]
    want = r_pred.PatternPredictor.detect_period(x)
    assert t_pred.PatternPredictor.detect_period(torch.from_numpy(x)) == want
    assert t_pred.PatternPredictor.detect_period(x) == want


def test_pattern_decode_refuses_inconsistent_meta():
    x = GAMESS["f64"]
    _, tconf = _confs("abs", 1e-10)
    blob = tc.sz3_pastri(device=CPU).compress(x, tconf).blob
    header, _ = tc.parse_header(blob)
    q = t_quant.UnpredAwareQuantizer()
    q.begin(header["abs_eb"], torch.float64)
    meta = dict(header["pred_meta"], nb=header["pred_meta"]["nb"] + 1)
    with pytest.raises(ValueError, match="pattern meta"):
        t_pred.PatternPredictor().decompress(torch.zeros(x.size, dtype=torch.int32), x.shape, torch.float64, q, tconf, meta)


# ---------------------------------------------------------------------------
# APS: both branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eb,branch", [(0.25, "low"), (0.1, "low"), (2.0, "high"), (0.5, "high")])
@pytest.mark.parametrize("time_axis", [0, 2])
def test_aps_same_bytes_and_cross_decode(eb, branch, time_axis):
    rconf, tconf = _confs("abs", eb)
    ref = rc.sz3_aps(time_axis=time_axis).compress(APS, rconf).blob
    port = tc.sz3_aps(time_axis=time_axis, device=CPU).compress(APS, tconf).blob
    assert port == ref
    header = tc.parse_header(port)[0]
    assert header["spec"]["predictor"] == ("lorenzo" if branch == "low" else "composite")
    _cross_decode(port, ref)
    out = tc.decompress(port, device=CPU).numpy()
    if branch == "low":  # integer counts, restricted bin: exact
        assert header["abs_eb"] == 0.5
        _assert_same_bits(out, APS)
    else:
        assert np.max(np.abs(out.astype(np.float64) - APS)) <= eb


def test_aps_low_branch_on_non_integral_data_keeps_the_bound():
    x = APS + np.float32(0.3)
    rconf, tconf = _confs("abs", 0.2)
    ref = rc.sz3_aps().compress(x, rconf).blob
    port = tc.sz3_aps(device=CPU).compress(x, tconf).blob
    assert port == ref and tc.parse_header(port)[0]["abs_eb"] == 0.2
    _cross_decode(port, ref)


@pytest.mark.parametrize("frames", [72, 200])
def test_aps_low_branch_kernel_route_same_bytes(frames):
    """route="force" (the plain 1-D kernels on CPU tensors) against the
    reference low pipeline with device="force" (interpret-mode Pallas)."""
    x = aps_like(frames, 8, 8, 13)
    rconf, tconf = _confs("abs", 0.25)
    perm = (1, 2, 0)
    low = rc.SZ3Compressor(
        preprocessor=r_pre.Transpose(perm=perm, flatten=True),
        predictor=r_pred.LorenzoPredictor(order=1, device="force"),
        quantizer=r_quant.UnpredAwareQuantizer(),
        encoder=r_enc.FixedHuffmanEncoder(),
        lossless=r_ll.Zstd(),
    )
    ref = low.compress(x, rconf.replace(eb=0.5)).blob
    port = tc.sz3_aps(route="force", device=CPU).compress(x, tconf).blob
    assert tc.parse_header(port)[0]["pred_meta"]["device"] == 1
    assert port == ref
    _cross_decode(port, ref)
    _assert_same_bits(tc.decompress(port, device=CPU).numpy(), x)


def test_aps_kernel_route_stores_out_of_range_diffs():
    """A jump beyond the code radius: the kernel route hands the
    out-of-range diffs to the unpred-aware quantizer's bitplane stream."""
    x = aps_like(64, 8, 8, 14)
    x[30, 3, 3] = 9.0e4  # diff of 9e4 bins past the radius
    rconf, tconf = _confs("abs", 0.25)
    perm = (1, 2, 0)
    low = rc.SZ3Compressor(
        preprocessor=r_pre.Transpose(perm=perm, flatten=True),
        predictor=r_pred.LorenzoPredictor(order=1, device="force"),
        quantizer=r_quant.UnpredAwareQuantizer(),
        encoder=r_enc.FixedHuffmanEncoder(),
        lossless=r_ll.Zstd(),
    )
    port = tc.sz3_aps(route="force", device=CPU).compress(x, tconf).blob
    assert port == low.compress(x, rconf.replace(eb=0.5)).blob
    _assert_same_bits(tc.decompress(port, device=CPU).numpy(), x)


# ---------------------------------------------------------------------------
# truncation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lossless", ["none", "zstd"])
def test_truncation_same_bytes_and_cross_decode(k, dtype, lossless):
    x = (APS[:5] * 1.37 - 3.0).astype(dtype)
    x.reshape(-1)[:3] = [np.nan, -np.inf, 0.0]
    ref = rc.TruncationCompressor(keep_bytes=k, lossless=lossless).compress(x).blob
    port = tc.TruncationCompressor(keep_bytes=k, lossless=lossless, device=CPU).compress(x).blob
    assert port == ref
    _cross_decode(port, ref)
    if k >= np.dtype(dtype).itemsize:
        _assert_same_bits(tc.decompress(port, device=CPU).numpy(), x)


def test_truncation_factory_and_salvage():
    x = APS[:3]
    blob = tc.sz3_truncation(2, device=CPU).compress(x).blob
    assert blob == rc.sz3_truncation(2).compress(x).blob
    out, report = tc.decompress(blob, verify="salvage", device=CPU)
    assert report.recovered == [0] and not report.damage
    _assert_same_bits(out.numpy(), rc.decompress(blob))


# ---------------------------------------------------------------------------
# encoders, quantizer, registries
# ---------------------------------------------------------------------------

def _codes(seed, n=20000, radius=32768):
    rng = np.random.default_rng(seed)
    c = (radius + np.rint(rng.laplace(0, 3, n))).astype(np.int64)
    c[rng.random(n) < 0.02] = 0
    c[rng.random(n) < 0.01] = radius + 2000  # beyond the fixed table's span
    return c.astype(np.uint16)


@pytest.mark.parametrize("name", ["raw", "bitpack", "legacy_huffman", "fixed_huffman"])
@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_bytes_and_reference_streams(name, seed):
    codes = _codes(seed)
    make = {
        "raw": (r_enc.RawEncoder, t_enc.RawEncoder),
        "bitpack": (r_enc.BitpackEncoder, t_enc.BitpackEncoder),
        "legacy_huffman": (r_enc.LegacyHuffmanEncoder, t_enc.LegacyHuffmanEncoder),
        "fixed_huffman": (r_enc.FixedHuffmanEncoder, t_enc.FixedHuffmanEncoder),
    }[name]
    ref = make[0]().encode(codes)
    port = make[1]().encode(codes)
    assert port == ref
    np.testing.assert_array_equal(np.asarray(make[1]().decode(ref, codes.size), np.int64), codes.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(make[0]().decode(port, codes.size), np.int64), codes.astype(np.int64))


def _frequencies(kind, n, rng):
    if kind == "ties":
        return rng.integers(0, 5, n)
    if kind == "uniform":
        return rng.integers(0, 1000, n)
    if kind == "heavy_tail":  # deep trees: the length cap's rebuilds
        return np.round(np.exp(rng.normal(0, 4, n))).astype(np.int64)
    if kind == "powers_of_two":  # one leaf per level, past the length cap
        return 2 ** np.minimum(np.arange(n), 40)
    if kind == "constant":
        return np.full(n, 7)
    return rng.poisson(np.exp(-np.abs(np.arange(n) - n / 2) / max(1, n / 40)) * 1e5)  # quantization codes


@pytest.mark.parametrize("kind", ["ties", "uniform", "heavy_tail", "powers_of_two", "constant", "codes"])
def test_huffman_lengths_and_canonical_codes_are_the_references(kind):
    """The port builds the tree by a two-queue merge, the reference by a
    heap: the lengths (ties, the length cap's rebuilds) and canonical codes
    must be the same for every alphabet size."""
    rng = np.random.default_rng(len(kind))
    for n in [1, 2, 3, 5, 17, *rng.integers(1, 3000, 12).tolist()]:
        f = np.asarray(_frequencies(kind, n, rng), np.int64)
        (t_lens, t_sym), (r_lens, r_sym) = t_enc._huffman_code_lengths(f), r_enc._huffman_code_lengths(f)
        np.testing.assert_array_equal(t_sym, r_sym)
        np.testing.assert_array_equal(t_lens, r_lens)
        assert t_lens.dtype == r_lens.dtype
        if r_lens.size:
            lens = r_lens[np.lexsort((r_sym, r_lens))]
            t_codes, r_codes = t_enc._canonical_codes(lens), r_enc._canonical_codes(lens)
            np.testing.assert_array_equal(t_codes, r_codes)
            assert t_codes.dtype == r_codes.dtype


def test_legacy_huffman_stream_reads_through_the_fast_decoder():
    codes = _codes(3)
    v1 = t_enc.LegacyHuffmanEncoder().encode(codes)
    assert v1 == r_enc.LegacyHuffmanEncoder().encode(codes)
    np.testing.assert_array_equal(t_enc.HuffmanEncoder().decode(v1, codes.size), codes)


def test_fixed_huffman_table_is_shared_across_threads():
    codes = _codes(5)
    t_enc.FixedHuffmanEncoder._cache.clear()
    want = r_enc.FixedHuffmanEncoder(decay=0.6).encode(codes)
    got, tables = [], []
    barrier = threading.Barrier(4)

    def work():
        barrier.wait()
        enc = t_enc.FixedHuffmanEncoder(decay=0.6)
        got.append(enc.encode(codes))
        tables.append(enc._table()[0])

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == [want] * 4
    assert all(t is tables[0] for t in tables)


def _drive_quantizer(mod, dtype):
    rng = np.random.default_rng(6)
    x = np.cumsum(rng.normal(size=3000)).astype(dtype)
    x[::97] *= 1e6  # out of range: float unpredictables
    x[5] = np.inf
    pred = np.roll(x, 1).astype(np.float64)
    pred[5] = 0.0
    d = np.diff(np.rint(x.astype(np.float64) / 2e-3), prepend=0).astype(np.int64)
    q = mod.UnpredAwareQuantizer()
    q.begin(1e-3, dtype if mod is r_quant else {np.float32: torch.float32, np.float64: torch.float64}[dtype])
    if mod is r_quant:
        codes, recon = q.quantize(x, pred)
        icodes = q.quantize_int_diff(d)
    else:
        codes, recon = q.quantize(torch.from_numpy(x), torch.from_numpy(pred))
        icodes = q.quantize_int_diff(torch.from_numpy(d))
        codes, recon, icodes = codes.numpy(), recon.numpy(), icodes.numpy()
    return q, x, pred, codes, recon, icodes


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_unpred_aware_save_bytes_and_recover(dtype):
    rq, x, pred, r_codes, r_recon, r_icodes = _drive_quantizer(r_quant, dtype)
    tq, _, _, t_codes, t_recon, t_icodes = _drive_quantizer(t_quant, dtype)
    np.testing.assert_array_equal(t_codes.astype(np.int64), r_codes.astype(np.int64))
    np.testing.assert_array_equal(t_icodes.astype(np.int64), r_icodes.astype(np.int64))
    _assert_same_bits(t_recon, r_recon)
    saved = tq.save()
    assert saved == rq.save()
    assert np.frombuffer(saved, np.int64, count=3)[2] > 0  # escape bits written
    q2 = t_quant.UnpredAwareQuantizer()
    q2.begin(1e-3, torch.float32 if dtype == np.float32 else torch.float64)
    q2.load(saved)
    back = q2.recover(torch.from_numpy(pred), torch.from_numpy(t_codes.astype(np.int32)))
    _assert_same_bits(back.numpy(), r_recon)
    rq2 = r_quant.UnpredAwareQuantizer()
    rq2.begin(1e-3, dtype)
    rq2.load(saved)
    rq2.recover(pred, r_codes)
    want = rq2.recover_int_diff(r_icodes)
    np.testing.assert_array_equal(q2.recover_int_diff(torch.from_numpy(t_icodes.astype(np.int32))).numpy(), want)


def test_register_hooks_extend_every_module():
    class Twice(t_ll.Gzip):
        name = "gzip_twice_test"

    hooks = [
        (t_ll, "gzip_twice_test", Twice),
        (t_enc, "raw_test", t_enc.RawEncoder),
        (t_quant, "unpred_test", t_quant.UnpredAwareQuantizer),
        (t_pred, "pattern_test", t_pred.PatternPredictor),
        (t_pre, "linearize_test", t_pre.Linearize),
    ]
    try:
        for mod, name, cls in hooks:
            mod.register(name, cls)
            assert isinstance(mod.make(name), cls)
    finally:
        for mod, name, _ in hooks:
            mod._REGISTRY.pop(name, None)


@pytest.mark.parametrize("name", ["zstd", "gzip", "lzma", "none"])
def test_effective_backend_matches_reference(name):
    assert t_ll.effective_backend(name) == r_ll.effective_backend(name)
    assert t_ll.effective_backend() == r_ll.effective_backend()


# ---------------------------------------------------------------------------
# the sequential Lorenzo oracle
# ---------------------------------------------------------------------------

def _seq_field(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(size=shape), axis=-1)
    if len(shape) > 1:
        x = np.cumsum(x, axis=0)
    return x.astype(dtype)


SEQ_FIELDS = {
    "1d_f32": _seq_field((4096,), np.float32, 1),
    "2d_f32": _seq_field((48, 80), np.float32, 2),
    "2d_f64": _seq_field((40, 50), np.float64, 3),
    "3d_f64": _seq_field((12, 16, 20), np.float64, 4),
    "3d_f32": _seq_field((8, 9, 10), np.float32, 5),
}
_nf = SEQ_FIELDS["2d_f32"].copy()
_nf[3, 3], _nf[10, 10], _nf[20, 5], _nf[30, 30] = np.inf, np.nan, 1e30, -np.inf
SEQ_FIELDS["2d_nonfinite"] = _nf


@pytest.mark.parametrize("field", list(SEQ_FIELDS))
@pytest.mark.parametrize("quantizer", ["linear", "unpred_aware"])
@pytest.mark.parametrize("eb", [1e-3, 0.5])
def test_lorenzo_sequential_codes_and_decodes_bit_for_bit(field, quantizer, eb):
    x = SEQ_FIELDS[field]
    rconf, tconf = _confs("abs", eb)
    ref = rc.SZ3Compressor(predictor=r_pred.LorenzoSequentialPredictor(), quantizer=r_quant.make(quantizer)).compress(
        x, rconf, with_stats=True
    )
    port = tc.SZ3Compressor(
        predictor=t_pred.LorenzoSequentialPredictor(), quantizer=t_quant.make(quantizer), device=CPU
    ).compress(x, tconf, with_stats=True)
    np.testing.assert_array_equal(port.codes.astype(np.int64), ref.codes.astype(np.int64))
    assert port.blob == ref.blob
    _cross_decode(port.blob, ref.blob)
    if quantizer == "unpred_aware" and np.isnan(x).any():
        # the reference stores a NaN's prediction error as rint(NaN) cast to
        # int64, so its own decode loses the bound from there on (ROADMAP
        # queue 3); the port writes and reads the same bytes
        return
    out = tc.decompress(port.blob, device=CPU).numpy().astype(np.float64)
    fin = np.isfinite(x)
    assert np.max(np.abs(out[fin] - x[fin])) <= eb


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_aps_low_branch_launches_the_1d_kernels_and_writes_the_cpu_bytes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels.lorenzo import kernel as K

    x = aps_like(64, 16, 16, 15)  # 16384 elements: over the 1-D kernel floor
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=0.25)
    K.reset_launches()
    card = tc.sz3_aps(device="cuda").compress(x, conf).blob
    out = tc.decompress(card, device="cuda")
    torch.cuda.synchronize()
    assert K.LAUNCHES["encode_1d"] == 1 and K.LAUNCHES["decode_1d"] == 2
    assert card == tc.sz3_aps(device="cpu", route="force").compress(x, conf).blob
    assert torch.equal(out.cpu(), torch.from_numpy(x))


@pytest.mark.cuda
def test_cuda_sz3_pastri_on_nan_input_writes_the_cpu_bytes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's float-to-int cast is the point")
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=1e-10)
    x = torch.from_numpy(GAMESS_NONFINITE)
    card = tc.sz3_pastri(pattern_size=96, device="cuda").compress(x.cuda(), conf).blob
    assert card == tc.sz3_pastri(pattern_size=96, device="cpu").compress(x, conf).blob
    out = tc.decompress(card, device="cuda").cpu()
    assert torch.equal(out.view(torch.int64), tc.decompress(card, device="cpu").view(torch.int64))
