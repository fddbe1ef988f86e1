"""The port's widest chunked contest (``sz3_auto``) and its quality
controller (``sz3_quality``) held against the JAX package, on the CPU.

* ``AUTO_CANDIDATES`` is the reference's tuple, in the reference's order,
  and consumers read it at call time;
* same input, same bytes: ``sz3_auto`` writes the reference's v2 blob and
  picks on a mixed-regime field (Lorenzo, transform and hybrid chunks) at
  one and four workers, in both speed tiers; ``sz3_quality`` writes the
  reference's blob at PSNR, ratio and bitrate targets — exact equality, so
  every float decision of the controller (``m > budget``, ``len(blob) <
  best``) fell the reference's way — including ``gen_conformance.py``'s own
  ``sz3_quality(target_psnr=50.0, chunk_bytes=2048)`` call on its input;
* each package decodes the other's blobs; ``achieved_quality`` reads the
  record back; ``QualityTarget`` refuses zero or two targets.

The ``cuda``-marked tests hold the card's blobs against the plain route's
(``python -m pytest -q -m cuda tests/test_torch_quality.py``).
"""
import math
import types

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import integrity as t_int
from repro_torch.core import quality as t_q
from repro_torch.core import transform as t_tr

try:  # the card's tests below need no JAX
    import repro.core as rc
    from repro.core import integrity as r_int
    from repro.core import quality as r_q
except ImportError:  # pragma: no cover - a machine without JAX
    rc = None

CPU = "cpu"


@pytest.fixture(autouse=True)
def reference_verifies_crc32c(monkeypatch):
    """Where ``google_crc32c`` is missing, the JAX package cannot verify
    CRC32C trailers (ROADMAP queue 3); lend it the port's numpy CRC32C."""
    if rc is not None and r_int._crc32c_mod is None:
        monkeypatch.setattr(r_int, "_crc32c_mod", types.SimpleNamespace(
            extend=lambda value, data: t_int.crc32c_numpy(data, value)))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def smooth(shape, seed, dtype=np.float32):
    """``tests/data/gen_conformance.py``'s input recipe."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    for ax in range(len(shape)):
        x = np.cumsum(x, axis=ax) / np.sqrt(shape[ax])
    return x.astype(dtype)


def mixed_field(seed=7):
    """Six 16-row regimes of 64 columns: a smooth walk, an oscillation (the
    transform's turf), piecewise tiles of ramps, noise and zeros (the
    hybrid's), constant rows, a smooth surface and white noise."""
    rng = np.random.default_rng(seed)
    c = np.arange(64.0)
    walk = np.cumsum(np.cumsum(rng.standard_normal((16, 64)), axis=1), axis=0) * 0.01
    osc = np.sin(0.9 * np.pi * np.arange(16 * 64)).reshape(16, 64) + 0.01 * rng.standard_normal((16, 64))
    tiles = np.zeros((16, 64))
    tiles[:, 16:32] = 0.5 * c[16:32] / 16 + 0.002 * rng.standard_normal((16, 16))
    tiles[:, 32:48] = 0.3 * rng.standard_normal((16, 16))
    tiles[:, 48:] = np.cumsum(rng.standard_normal((16, 16)), axis=1) * 0.05
    const = np.repeat(rng.integers(-3, 4, (16, 1)) * 0.75, 64, axis=1)
    yy, xx = np.mgrid[0:16, 0:64] / 8.0
    surface = np.sin(yy) * np.cos(xx)
    noise = rng.standard_normal((16, 64))
    return np.concatenate([walk, osc, tiles, const, surface, noise]).astype(np.float32)


MIXED = mixed_field()
Z = smooth((48, 32), seed=14)  # gen_conformance.py's v2 input


def _confs(mode, eb):
    return (
        rc.CompressionConfig(mode=rc.ErrorBoundMode(mode), eb=eb),
        tc.CompressionConfig(mode=tc.ErrorBoundMode(mode), eb=eb),
    )


# ---------------------------------------------------------------------------
# sz3_auto
# ---------------------------------------------------------------------------

def test_auto_candidates_are_the_references():
    assert tc.AUTO_CANDIDATES == rc.AUTO_CANDIDATES == (
        "sz3_lorenzo", "sz3_lr", "sz3_interp", "sz3_transform", "sz3_hybrid", "sz3_fast",
    )
    assert t_tr.AUTO_CANDIDATES is tc.AUTO_CANDIDATES
    assert t_q._auto_candidates() == tc.AUTO_CANDIDATES
    assert tc.sz3_quality(device=CPU).candidates == tc.AUTO_CANDIDATES


def test_auto_candidates_are_read_at_call_time(monkeypatch):
    monkeypatch.setattr(t_tr, "AUTO_CANDIDATES", ("sz3_lorenzo", "sz3_hybrid"))
    assert tc.sz3_auto(device=CPU).candidates == ("sz3_lorenzo", "sz3_hybrid")
    assert t_q.QualityCompressor(target_psnr=40, device=CPU).candidates == ("sz3_lorenzo", "sz3_hybrid")
    assert tc.sz3_auto(candidates=("sz3_fast",), device=CPU).candidates == ("sz3_fast",)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("mode,eb", [("abs", 1e-3), ("rel", 1e-3), ("abs", 1e-2)], ids=["abs", "rel", "abs-coarse"])
def test_sz3_auto_same_bytes_and_picks(mode, eb, workers):
    rconf, tconf = _confs(mode, eb)
    ref = rc.sz3_auto(chunk_bytes=4096, workers=workers).compress(MIXED, rconf, with_stats=True)
    got = tc.sz3_auto(chunk_bytes=4096, workers=workers, device=CPU).compress(MIXED, tconf, with_stats=True)
    assert got.blob == ref.blob
    assert got.meta == ref.meta
    picks = {c["pipeline"] for c in got.meta["chunks"]}
    assert len(picks) >= 3 and "sz3_lorenzo" in picks
    _same_bits(tc.decompress(ref.blob, device=CPU).numpy(), rc.decompress(got.blob))


def test_sz3_auto_picks_every_family_on_the_mixed_field():
    """Over both bounds, the contest sends chunks to the transform and the
    block hybrid as well as to the prediction pipelines."""
    picks = set()
    for mode, eb in (("abs", 1e-3), ("rel", 1e-3)):
        _, tconf = _confs(mode, eb)
        res = tc.sz3_auto(chunk_bytes=4096, device=CPU).compress(MIXED, tconf, with_stats=True)
        picks |= {c["pipeline"] for c in res.meta["chunks"]}
    assert {"sz3_lorenzo", "sz3_transform", "sz3_hybrid"} <= picks


@pytest.mark.parametrize("workers", [1, 4])
def test_sz3_auto_throughput_tier_same_bytes(workers):
    rconf, tconf = _confs("abs", 1e-3)
    ref = rc.sz3_auto(chunk_bytes=4096, workers=workers, speed_tier="throughput").compress(MIXED, rconf)
    got = tc.sz3_auto(chunk_bytes=4096, workers=workers, speed_tier="throughput", device=CPU).compress(MIXED, tconf)
    assert got.blob == ref.blob


def test_sz3_auto_under_pw_rel_same_bytes():
    """PW_REL keeps the candidates with a preprocessor slot (the hybrid and
    the fast tier among them) and composes LogTransform per chunk."""
    x = np.exp(smooth((64, 24), seed=16, dtype=np.float64))
    x[5, 5] = 0.0
    x[::9, 3] *= -1
    rconf, tconf = _confs("pw_rel", 1e-3)
    ref = rc.sz3_auto(chunk_bytes=4096).compress(x, rconf, with_stats=True)
    got = tc.sz3_auto(chunk_bytes=4096, device=CPU).compress(x, tconf, with_stats=True)
    assert got.blob == ref.blob and got.meta == ref.meta


def test_auto_pipeline_is_registered():
    assert tc.PIPELINES["sz3_auto"] is tc.sz3_auto
    assert tc.PIPELINES["sz3_quality"] is tc.sz3_quality
    assert tc.PIPELINES["sz3_hybrid"] is tc.sz3_hybrid
    assert sorted(tc.PIPELINES) == sorted(rc.PIPELINES)


# ---------------------------------------------------------------------------
# sz3_quality
# ---------------------------------------------------------------------------

QUALITY_CASES = {
    "psnr-40": dict(target_psnr=40.0, chunk_bytes=4096),
    "psnr-60": dict(target_psnr=60.0, chunk_bytes=4096),
    "psnr-90": dict(target_psnr=90.0, chunk_bytes=8192),
    "ratio-8": dict(target_ratio=8.0, chunk_bytes=4096),
    "ratio-20": dict(target_ratio=20.0, chunk_bytes=4096),
    "bitrate-4": dict(target_bitrate=4.0, chunk_bytes=4096),
    "bitrate-1.5": dict(target_bitrate=1.5, chunk_bytes=8192),
}


@pytest.mark.parametrize("case", list(QUALITY_CASES))
def test_sz3_quality_same_bytes_and_cross_decode(case):
    kw = QUALITY_CASES[case]
    ref = rc.sz3_quality(**kw).compress(MIXED)
    got = tc.sz3_quality(device=CPU, **kw).compress(MIXED)
    assert got.blob == ref.blob
    assert got.meta == ref.meta
    _same_bits(tc.decompress(ref.blob, device=CPU).numpy(), rc.decompress(got.blob))


def test_sz3_quality_conformance_call_same_bytes():
    """``gen_conformance.py``'s own call, on its own input, writes the
    reference's bytes; the port decodes the committed fixture too."""
    ref = rc.sz3_quality(target_psnr=50.0, chunk_bytes=2048).compress(Z)
    got = tc.sz3_quality(target_psnr=50.0, chunk_bytes=2048, device=CPU).compress(Z)
    assert got.blob == ref.blob
    assert len(got.meta["chunks"]) == 3


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("candidates", [None, ("sz3_lorenzo", "sz3_transform")], ids=["auto", "two"])
def test_sz3_quality_workers_and_candidates(workers, candidates):
    ref = rc.sz3_quality(target_psnr=55.0, chunk_bytes=4096, workers=workers, candidates=candidates).compress(MIXED)
    got = tc.sz3_quality(target_psnr=55.0, chunk_bytes=4096, workers=workers, candidates=candidates,
                         device=CPU).compress(MIXED)
    assert got.blob == ref.blob


@pytest.mark.parametrize("name", ["const", "nan", "zero-d", "empty", "f64-3d"])
def test_sz3_quality_edge_inputs_same_bytes(name):
    rng = np.random.default_rng(9)
    x = {
        "const": np.full((40, 30), 1.25, np.float32),
        "nan": np.where(rng.random((40, 30)) < 0.01, np.nan, smooth((40, 30), 3)).astype(np.float32),
        "zero-d": np.float32(2.5).reshape(()),
        "empty": np.zeros((0, 4), np.float32),
        "f64-3d": smooth((6, 10, 12), 4, np.float64),
    }[name]
    ref = rc.sz3_quality(target_psnr=50.0, chunk_bytes=2048).compress(x)
    got = tc.sz3_quality(target_psnr=50.0, chunk_bytes=2048, device=CPU).compress(x)
    assert got.blob == ref.blob


def test_psnr_target_is_met():
    res = tc.sz3_quality(target_psnr=60.0, chunk_bytes=4096, device=CPU).compress(MIXED)
    out = tc.decompress(res.blob, device=CPU).numpy().astype(np.float64)
    x = MIXED.astype(np.float64)
    mse = float(np.mean((out - x) ** 2))
    psnr = 20 * math.log10(float(MIXED.max() - MIXED.min())) - 10 * math.log10(mse)
    q = res.meta["quality"]
    assert q["achieved_psnr"] >= 60.0 and psnr >= 60.0 - 1e-9
    budget = float(MIXED.max() - MIXED.min()) ** 2 * 10.0 ** (-60.0 / 10.0)
    assert all(c["q"]["mse"] <= budget for c in res.meta["chunks"])


def test_achieved_quality_reads_the_record_back():
    res = tc.sz3_quality(target_ratio=10.0, chunk_bytes=4096, device=CPU).compress(MIXED)
    rec = tc.achieved_quality(res.blob)
    assert rec == res.meta["quality"] == r_q.achieved_quality(res.blob)
    assert rec["target"] == {"kind": "ratio", "value": 10.0}
    assert rec["achieved_ratio"] == MIXED.nbytes / len(res.blob)
    header, _ = tc.parse_header(res.blob)
    assert [c["q"] for c in header["chunks"]] == [c["q"] for c in res.meta["chunks"]]
    assert list(header["chunks"][0]) == ["off", "len", "n0", "pipeline", "q"]
    assert tc.achieved_quality(tc.sz3_lorenzo(device=CPU).compress(MIXED).blob) is None


@pytest.mark.parametrize("kw", [{}, {"psnr": 40.0, "ratio": 5.0}, {"psnr": 0.0}, {"bitrate": -1.0},
                                {"psnr": 1.0, "ratio": 2.0, "bitrate": 3.0}],
                         ids=["none", "two", "zero", "negative", "three"])
def test_quality_target_refuses_zero_or_two_targets(kw):
    with pytest.raises(ValueError):
        tc.QualityTarget(**kw)
    with pytest.raises(ValueError):
        r_q.QualityTarget(**kw)


def test_quality_target_header_and_default():
    assert tc.QualityTarget(bitrate=2.5).to_header() == {"kind": "bitrate", "value": 2.5}
    assert tc.sz3_quality(device=CPU).target == tc.QualityTarget(psnr=60.0)


def test_finite_mse_equals_reference():
    rng = np.random.default_rng(4)
    a = rng.standard_normal(5000).astype(np.float32)
    a[7] = np.nan
    a[9] = np.inf
    b = a + rng.standard_normal(5000).astype(np.float32) * 1e-3
    assert t_q._finite_mse(a, b) == r_q._finite_mse(a, b)
    assert t_q._finite_mse(torch.from_numpy(a), torch.from_numpy(b)) == r_q._finite_mse(a, b)
    assert t_q._finite_mse(np.full(3, np.nan), np.zeros(3)) == 0.0


def test_decompress_route_picks_the_lorenzo_decode(monkeypatch):
    """``route="force"`` decodes a kernel-route Lorenzo blob through the
    kernel's plain version (as the card's kernel decodes it), in v1 and in
    every chunk of a v2 container; ``"auto"`` on the CPU takes the host
    route.  The controller confirms on its own route, so its plain-route
    run on the CPU measures what the card decodes."""
    from repro_torch.kernels.lorenzo import ops as lops

    calls = []
    plain = lops.decode_pipeline
    monkeypatch.setattr(lops, "decode_pipeline", lambda d, eb: calls.append(tuple(d.shape)) or plain(d, eb=eb))
    x = np.ascontiguousarray(np.tile(MIXED[:32], (4, 1)) * 100.0)
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=1e-3)
    blob = tc.sz3_lorenzo(route="force", device=CPU).compress(x, conf).blob
    assert tc.parse_header(blob)[0]["pred_meta"]["device"] == 1
    calls.clear()
    host = tc.decompress(blob, device=CPU).numpy()
    assert calls == []
    forced = tc.decompress(blob, device=CPU, route="force").numpy()
    assert calls == [x.shape]
    assert np.abs(forced - x).max() <= 1e-3 and np.abs(host - x).max() <= 1e-3
    v2 = tc.sz3_chunked(candidates=("sz3_lorenzo",), chunk_bytes=1 << 14, route="force", device=CPU).compress(x, conf)
    calls.clear()
    out = tc.decompress(v2.blob, device=CPU, route="force").numpy()
    assert len(calls) == len(tc.parse_header(v2.blob)[0]["chunks"]) == 2
    assert np.abs(out - x).max() <= 1e-3
    with pytest.raises(ValueError, match="route"):
        tc.decompress(blob, device=CPU, route="sometimes")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these tests run the engines on a card")
    return torch.device("cuda")


def _card_field():
    """Large enough that every routed candidate takes its kernel route."""
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:256, 0:512] / 40.0
    f = np.sin(yy) * np.cos(1.3 * xx) + 0.01 * rng.standard_normal(yy.shape)
    f[128:] += np.sin(0.9 * np.pi * np.arange(128 * 512)).reshape(128, 512)
    return f.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["abs", "rel"])
def test_cuda_sz3_auto_equals_the_plain_route(cuda_device, mode):
    x = _card_field()
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode(mode), eb=1e-3)
    card = tc.sz3_auto(chunk_bytes=1 << 17, device=cuda_device).compress(x, conf)
    plain = tc.sz3_auto(chunk_bytes=1 << 17, device=CPU, route="force").compress(x, conf)
    assert card.blob == plain.blob


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"target_psnr": 60.0}, {"target_ratio": 10.0}], ids=["psnr", "ratio"])
def test_cuda_sz3_quality_equals_the_plain_route(cuda_device, kw):
    x = _card_field()
    card = tc.sz3_quality(chunk_bytes=1 << 17, device=cuda_device, **kw).compress(x)
    plain = tc.sz3_quality(chunk_bytes=1 << 17, device=CPU, route="force", **kw).compress(x)
    assert card.blob == plain.blob


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512), (1 << 17,)], ids=["2d", "1d"])
def test_cuda_lorenzo_decode_equals_the_forced_cpu_decode(cuda_device, shape):
    """The card's kernel decode and the CPU's ``route="force"`` decode (the
    kernel's plain version) give the same bits: what lets the controller's
    plain-route run measure the card's MSEs."""
    x = _card_field().reshape(-1)[: math.prod(shape)].reshape(shape) * 40.0
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    blob = tc.sz3_lorenzo(device=cuda_device).compress(x, conf).blob
    _same_bits(tc.decompress(blob, device=cuda_device).cpu().numpy(), tc.decompress(blob, device=CPU, route="force").numpy())
