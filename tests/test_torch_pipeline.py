"""The port's ``sz3_lorenzo`` slice and the container layer held against the
JAX package, on the CPU.

* same input, same bytes: the port's blob equals the reference's on the host
  route (``route="off"`` vs ``device="off"``) and on the kernel route
  (``route="force"`` with the plain torch versions vs ``device="force"``
  with interpret-mode Pallas);
* containers work both ways: each package decodes the other's blobs, bit
  for bit on the host route, and the committed v1 conformance and fault
  fixtures behave as ``tests/data/faults/manifest.json`` pins them, also
  where ``google_crc32c`` is missing (CRC32C trailers then verify through the
  port's numpy CRC32C);
* the modules under the pipeline (msgpack, Huffman, lossless backends,
  quantizer, metrics) match their reference counterparts;
* the error contract, the import boundary and the device default hold.
"""
import json
import pathlib
import subprocess
import sys
import types
import zlib

import msgpack
import numpy as np
import pytest
import torch

from repro.core import CompressionConfig as RConf
from repro.core import ErrorBoundMode as RMode
from repro.core import decompress as ref_decompress
from repro.core import encoders as r_enc
from repro.core import integrity as r_int
from repro.core import lossless as r_ll
from repro.core import metrics as r_metrics
from repro.core import quantizers as r_quant
from repro.core.pipeline import SZ3Compressor as RSZ3
from repro.core.predictors import LorenzoPredictor as RLorenzo
from repro.core.predictors import ZeroPredictor as RZero

import repro_torch.core as tc
from repro_torch.core import _msgpack
from repro_torch.core import faults
from repro_torch.core import encoders as t_enc
from repro_torch.core import integrity as t_int
from repro_torch.core import lossless as t_ll
from repro_torch.core import metrics as t_metrics
from repro_torch.core import predictors as t_pred
from repro_torch.core import quantizers as t_quant

DATA = pathlib.Path(__file__).parent / "data"
FAULTS = DATA / "faults"
CORPUS = sorted(DATA.rglob("*.sz3"))
LORENZO_FIXTURES = {"v1_lorenzo_abs.sz3", "v1_lorenzo.sz3"}
#: v1 composite and v2 chunked fixtures, decoded since the chunked engine
#: was ported (``test_ported_fixture_decodes_like_the_reference``)
CHUNKED_FIXTURES = ("v1_lr_rel.sz3", "v2_chunked_rel.sz3", "v2_quality_psnr.sz3", "faults/v2_chunked.sz3")
#: corpus files of the kinds the port decodes (v1 Lorenzo, composite and
#: log-preprocessed, v2, v3, v4, v5, v6): all of them
PORTED_FIXTURES = LORENZO_FIXTURES | {pathlib.PurePath(f).name for f in CHUNKED_FIXTURES} | {
    "v3_transform_abs.sz3", "v3_transform.sz3",
    "v6_fast_mixed_abs.sz3", "v6_fast_const_rel.sz3", "v6_fast.sz3",
    "v1_log_pwrel.sz3", "v4_pwr.sz3",
    "v5_hybrid_const_rel.sz3", "v5_hybrid_mixed_abs.sz3", "v5_hybrid.sz3",
}
CPU = "cpu"

MODES = {
    "abs": ("abs", 1e-3, None),
    "rel": ("rel", 1e-4, None),
    "abs-and-rel": ("abs-and-rel", 1e-3, 1e-4),
    "abs-or-rel": ("abs-or-rel", 1e-3, 1e-4),
}


def _make_fields():
    rng = np.random.default_rng(2021)
    yy, xx = np.mgrid[0:64, 0:96] / 16.0
    f2 = (np.sin(yy) * np.cos(1.3 * xx) + 0.01 * rng.normal(size=(64, 96))).astype(np.float32)
    f1 = np.cumsum(rng.normal(size=5000) * 0.05).astype(np.float32)
    f3 = np.cumsum(rng.normal(size=(8, 10, 12)), axis=2).astype(np.float32)
    fnan = f2.copy()
    fnan[3, 4], fnan[5, 6], fnan[7, 8] = np.nan, np.inf, -np.inf
    # |x| / (2 eb) near PIPELINE_SAFE at eb=1e-3: float32 rounding sends
    # points through the kernel route's fail channel
    big = (8000.0 * np.sin(yy / 2.0) * np.cos(xx / 3.0)).astype(np.float32)
    return {"2d": f2, "1d": f1, "3d": f3, "nan": fnan, "big": big}


FIELDS = _make_fields()


def _confs(mode):
    name, eb, eb_rel = MODES[mode]
    return (
        RConf(mode=RMode(name), eb=eb, eb_rel=eb_rel),
        tc.CompressionConfig(mode=tc.ErrorBoundMode(name), eb=eb, eb_rel=eb_rel),
    )


def _ref_blob(x, rconf, device="off", order=1):
    return RSZ3(predictor=RLorenzo(order=order, device=device)).compress(x, rconf).blob


def _port_blob(x, tconf, route="off", order=1):
    return tc.sz3_lorenzo(order=order, route=route, device=CPU).compress(x, tconf).blob


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _assert_same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# same input, same bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["2d", "1d", "3d", "nan"])
@pytest.mark.parametrize("mode", list(MODES))
def test_host_route_same_bytes(field, mode):
    rconf, tconf = _confs(mode)
    x = FIELDS[field]
    assert _port_blob(x, tconf) == _ref_blob(x, rconf)


@pytest.mark.parametrize("field", ["2d", "1d", "3d", "nan"])
@pytest.mark.parametrize("mode", list(MODES))
def test_cross_decode_host_route(field, mode):
    """Each package decodes the other's blob to the same bits."""
    rconf, tconf = _confs(mode)
    x = FIELDS[field]
    port, ref = _port_blob(x, tconf), _ref_blob(x, rconf)
    for blob in (port, ref):
        _assert_same_bits(tc.decompress(blob, device=CPU).numpy(), ref_decompress(blob))


@pytest.mark.parametrize("field,mode", [("2d", "abs"), ("2d", "rel"), ("1d", "abs"), ("big", "abs")])
def test_kernel_route_same_bytes(field, mode):
    """route="force" (plain torch versions) writes the reference's
    device="force" (interpret-mode Pallas) bytes: codes, fail mask and all."""
    rconf, tconf = _confs(mode)
    x = FIELDS[field]
    port, ref = _port_blob(x, tconf, route="force"), _ref_blob(x, rconf, device="force")
    meta = tc.parse_header(port)[0]["pred_meta"]
    assert meta["device"] == 1
    if field == "big":
        assert meta["nfail"] > 0, "the case must exercise the fail channel"
    assert port == ref
    abs_eb = tc.parse_header(port)[0]["abs_eb"]
    out = tc.decompress(port, device=CPU).numpy()
    assert np.max(np.abs(out.astype(np.float64) - x)) <= abs_eb
    _assert_same_bits(out, ref_decompress(port))


def test_kernel_route_decodes_within_bound_on_both_routes():
    """A device=1 stream decodes through the kernel decode (its plain version
    here) and through the host int64 route; both keep the bound, though they
    may differ in the last bit."""
    x = torch.from_numpy(FIELDS["big"])
    conf = tc.CompressionConfig()
    q = t_quant.LinearScaleQuantizer()
    q.begin(1e-3, torch.float32)
    pred = t_pred.LorenzoPredictor(order=1, route="force")
    codes, meta = pred.compress(x, q, conf)
    assert meta["device"] == 1 and meta["nfail"] > 0
    for route in ("force", "off"):
        q2 = t_quant.LinearScaleQuantizer()
        q2.begin(1e-3, torch.float32)
        q2.load(q.save())
        out = t_pred.LorenzoPredictor(order=1, route=route).decompress(
            codes, tuple(x.shape), torch.float32, q2, conf, meta
        )
        assert float((out.double() - x.double()).abs().max()) <= 1e-3


def test_order_two_host_route_same_bytes():
    rconf, tconf = _confs("abs")
    x = FIELDS["3d"]
    assert _port_blob(x, tconf, order=2) == _ref_blob(x, rconf, order=2)


def test_zero_predictor_same_bytes():
    rconf, tconf = _confs("abs")
    x = FIELDS["nan"]
    ref = RSZ3(predictor=RZero()).compress(x, rconf).blob
    port = tc.SZ3Compressor(predictor=t_pred.ZeroPredictor(), device=CPU).compress(x, tconf).blob
    assert port == ref
    _assert_same_bits(tc.decompress(port, device=CPU).numpy(), ref_decompress(ref))


def test_zero_d_rel_field_same_bytes_and_decodes():
    """A 0-d field under REL: the port writes the reference's bytes and
    decodes them to the value.  The reference itself raises on this blob
    (it assigns its fail values into a 0-d numpy scalar; ROADMAP queue 3)."""
    x = np.float32(3.5).reshape(())
    rconf = RConf(mode=RMode.REL, eb=1e-3)
    tconf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-3)
    ref = RSZ3().compress(x, rconf).blob
    port = tc.sz3_lorenzo(device=CPU).compress(x, tconf).blob
    assert port == ref
    out = tc.decompress(port, device=CPU).numpy()
    assert out.shape == () and out.dtype == np.float32 and float(out) == 3.5


def test_compress_accepts_tensors_and_casts_like_numpy():
    rconf, tconf = _confs("abs")
    x16 = FIELDS["2d"].astype(np.float16)
    ref = _ref_blob(x16, rconf)
    assert _port_blob(torch.from_numpy(x16), tconf) == ref
    assert _port_blob(x16, tconf) == ref


def test_legacy_blobs_without_trailer_same_bytes():
    rconf, tconf = _confs("rel")
    x = FIELDS["2d"]
    with r_int.trailers_disabled(), t_int.trailers_disabled():
        ref, port = _ref_blob(x, rconf), _port_blob(x, tconf)
    assert port == ref and t_int.read_trailer(port) is None
    _assert_same_bits(tc.decompress(port, device=CPU).numpy(), ref_decompress(port))


# ---------------------------------------------------------------------------
# committed fixtures
# ---------------------------------------------------------------------------

def test_v1_conformance_blob_decodes():
    blob = (DATA / "v1_lorenzo_abs.sz3").read_bytes()
    want = np.load(DATA / "v1_lorenzo_abs.npy")
    assert t_int.read_trailer(blob) is None  # written before trailers
    _assert_same_bits(tc.decompress(blob, device=CPU).numpy(), want)


@pytest.fixture(params=["google_crc32c", "numpy"])
def crc32c(request, monkeypatch):
    """Verify CRC32C trailers through ``google_crc32c`` and, with the module
    hidden as on a machine without it, through the port's numpy CRC32C."""
    if request.param == "numpy":
        monkeypatch.setattr(t_int, "_crc32c_mod", None)
        monkeypatch.setattr(t_int, "_HAVE_CRC32C", False)
    return request.param


def test_fault_fixtures_carry_crc32c_trailers():
    for name in ("v1_lorenzo.sz3", "v1_lorenzo_corrupt.sz3", "v2_chunked.sz3"):
        assert t_int.read_trailer((FAULTS / name).read_bytes()).algo == "crc32c"


def test_v1_fault_fixture_pristine_decodes_strict(crc32c):
    blob = (FAULTS / "v1_lorenzo.sz3").read_bytes()
    _assert_same_bits(
        tc.decompress(blob, verify="strict", device=CPU).numpy(),
        np.load(FAULTS / "v1_lorenzo.npy"),
    )


def test_v1_fault_fixture_corrupt_strict_raises(crc32c):
    corrupt = (FAULTS / "v1_lorenzo_corrupt.sz3").read_bytes()
    with pytest.raises(tc.IntegrityError):
        tc.decompress(corrupt, verify="strict", device=CPU)


def test_v1_fault_fixture_corrupt_salvage_loses_everything(crc32c):
    man = json.loads((FAULTS / "manifest.json").read_text())["v1_lorenzo"]
    assert man["generation"] == "v1" and "damaged_chunks" not in man
    corrupt = (FAULTS / "v1_lorenzo_corrupt.sz3").read_bytes()
    data, report = tc.decompress(corrupt, verify="salvage", device=CPU)
    assert isinstance(report, tc.SalvageReport)
    assert not report.ok and report.checksummed
    assert sorted(d.index for d in report.damage) == [0] and report.recovered == []
    want = np.load(FAULTS / "v1_lorenzo.npy")
    assert data.shape == want.shape and not bool(data.any())


@pytest.mark.parametrize("name", CHUNKED_FIXTURES)
def test_ported_fixture_decodes_like_the_reference(name, monkeypatch):
    """Decodes to the reference's bits and to the fixture's pinned array.
    Where ``google_crc32c`` is missing the JAX package cannot verify the
    fixtures' CRC32C trailers (ROADMAP queue 3): it borrows the port's."""
    if r_int._crc32c_mod is None:
        monkeypatch.setattr(r_int, "_crc32c_mod", types.SimpleNamespace(
            extend=lambda value, data: t_int.crc32c_numpy(data, value)))
    blob = (DATA / name).read_bytes()
    got = tc.decompress(blob, device=CPU).numpy()
    _assert_same_bits(got, ref_decompress(blob))
    _assert_same_bits(got, np.load((DATA / name).with_suffix(".npy")))


def test_mutation_grid_contract_through_the_port():
    """Every grid mutation of a trailer-carrying v1, v3 (both routes) or v6
    (both routes) port blob decodes to the pristine bits or raises a
    ValueError subclass; strict catches most."""
    conf = _confs("abs")[1]
    blobs = [
        _port_blob(FIELDS["2d"], conf),
        tc.sz3_transform(device=CPU).compress(FIELDS["2d"], conf).blob,
        tc.sz3_transform(route="force", device=CPU).compress(FIELDS["nan"], conf).blob,
        tc.sz3_fast(device=CPU).compress(FIELDS["nan"], conf).blob,
        tc.sz3_fast(route="force", device=CPU).compress(FIELDS["1d"], conf).blob,
    ]
    for blob in blobs:
        pristine = tc.decompress(blob, device=CPU).numpy()
        n = strict_errors = 0
        for name, mut in faults.mutation_grid(blob, seed=7):
            n += 1
            for verify in ("strict", "salvage", "off"):
                try:
                    got = tc.decompress(mut, verify=verify, device=CPU)
                except ValueError:
                    strict_errors += verify == "strict"
                    continue
                if verify == "salvage":
                    got, report = got
                    assert isinstance(report, tc.SalvageReport)
                elif verify == "strict":
                    _assert_same_bits(got.numpy(), pristine)
        assert n >= 15 and strict_errors >= n // 2


# ---------------------------------------------------------------------------
# error contract
# ---------------------------------------------------------------------------

def _real_blob():
    return _port_blob(FIELDS["2d"], _confs("abs")[1])


MALFORMED = {
    "empty": lambda: b"",
    "garbage": lambda: bytes(range(256)) * 2,
    "bad-magic": lambda: b"XXXX" + b"\x00" * 40,
    "truncated-prologue": lambda: _real_blob()[:15],
    "truncated-header": lambda: _real_blob()[:40],
    "hostile-body-length": lambda: faults.inflate_length(_real_blob(), "body"),
    "hostile-header-length": lambda: faults.inflate_length(_real_blob(), "header"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
@pytest.mark.parametrize("verify", ["strict", "off"])
def test_malformed_input_raises_value_error(case, verify):
    with pytest.raises(ValueError):
        tc.decompress(MALFORMED[case](), verify=verify, device=CPU)


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: str(p.relative_to(DATA)))
def test_every_corpus_file_is_ported_and_decodes(path, monkeypatch):
    """Every kind in the corpus is ported: each pristine file decodes to the
    reference's bits and to its pinned array; each ``*_corrupt`` file fails
    strict verification as ``faults/manifest.json`` pins it."""
    if r_int._crc32c_mod is None:
        monkeypatch.setattr(r_int, "_crc32c_mod", types.SimpleNamespace(
            extend=lambda value, data: t_int.crc32c_numpy(data, value)))
    blob = path.read_bytes()
    if "corrupt" in path.name:
        man = json.loads((FAULTS / "manifest.json").read_text())[path.stem.replace("_corrupt", "")]
        with pytest.raises(tc.IntegrityError):
            tc.decompress(blob, device=CPU)
        _, report = tc.decompress(blob, verify="salvage", device=CPU)
        assert sorted(d.index for d in report.damage) == man.get("damaged_chunks", [0])
        return
    assert path.name in PORTED_FIXTURES
    got = tc.decompress(blob, device=CPU).numpy()
    _assert_same_bits(got, ref_decompress(blob))
    _assert_same_bits(got, np.load(path.with_suffix(".npy")))


def _respec(blob, **spec):
    """``blob``'s v1 container with spec fields replaced (no trailer)."""
    header, body_off = tc.parse_header(blob)
    header = dict(header, spec=dict(header["spec"], **spec))
    header.pop("itg", None)
    h = _msgpack.packb(header)
    body = blob[body_off : body_off + int.from_bytes(blob[12:20], "little")]
    return b"SZ3J" + np.asarray([len(h), len(body)], np.int64).tobytes() + h + body


@pytest.mark.parametrize("spec", [{"kind": "wavelet"}, {"predictor": "spline"}, {"encoder": "arithmetic"}],
                         ids=["kind", "predictor", "encoder"])
def test_unported_kinds_raise_container_error(spec):
    """A container kind or module this package does not know (none of the
    JAX package's is left unported) raises a typed error naming it."""
    with pytest.raises(tc.ContainerError, match="unknown container"):
        tc.decompress(_respec(_real_blob(), **spec), verify="off", device=CPU)


def test_unknown_verify_policy_raises():
    with pytest.raises(ValueError, match="verify"):
        tc.decompress(_real_blob(), verify="sometimes", device=CPU)


def test_stripped_trailer_is_refused_in_strict():
    blob = _real_blob()
    stripped = blob[: t_int.read_trailer(blob).start]
    with pytest.raises(tc.IntegrityError, match="trailer"):
        tc.decompress(stripped, device=CPU)


# ---------------------------------------------------------------------------
# device default and import boundary
# ---------------------------------------------------------------------------

def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works there")
    x = FIELDS["2d"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.sz3_lorenzo().compress(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.decompress(_real_blob())


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels.lorenzo.ops\n"
        "import repro_torch.core.transform, repro_torch.core.fastmode\n"
        "import repro_torch.kernels.transform.ops, repro_torch.kernels.fastmode.ops\n"
        "import repro_torch.core.jitmode, repro_torch.compression, repro_torch.optim, repro_torch.tree\n"
        "import repro_torch.kernels.kvquant.ops, repro_torch.core.chunking\n"
        "import repro_torch.kernels.bitplane.ops\n"
        "import repro_torch.codec, repro_torch.ft, repro_torch.serve, repro_torch.core.faults\n"
        "import repro_torch.models, repro_torch.parallel, repro_torch.configs, repro_torch.data\n"
        "import repro_torch.train.step, repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh\n"
        "import repro_torch.models.moe, repro_torch.models.mamba2, repro_torch.models.encdec\n"
        "import repro_torch.parallel.comm, repro_torch.parallel.specs, repro_torch.launch.plans\n"
        "import repro_torch.serve.step\n"
        "import repro_torch.ft.elastic, repro_torch.launch.cost, repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
    )
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------

def _blob_parts(blob):
    hlen = int.from_bytes(blob[4:12], "little")
    parts = [blob[20 : 20 + hlen]]
    tr = r_int.read_trailer(blob)
    if tr is not None:
        parts.append(blob[tr.start : len(blob) - 9])
    return parts


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: str(p.relative_to(DATA)))
def test_msgpack_matches_on_corpus_headers(path):
    for raw in _blob_parts(path.read_bytes()):
        want = msgpack.unpackb(raw, raw=False)
        got = _msgpack.unpackb(raw)
        assert got == want
        assert _msgpack.packb(got) == msgpack.packb(want, use_bin_type=True) == raw


EDGE_INTS = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
]
EDGE_LENS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("kind", ["int", "str", "bin", "array", "map", "misc"])
def test_msgpack_edge_values(kind):
    if kind == "int":
        values = EDGE_INTS
    elif kind == "str":
        values = ["a" * n for n in EDGE_LENS] + ["héllo ∑"]
    elif kind == "bin":
        values = [b"\x01" * n for n in EDGE_LENS]
    elif kind == "array":
        values = [list(range(n % 300)) for n in EDGE_LENS] + [[0] * 65536, (1, "x")]
    elif kind == "map":
        values = [{f"k{i}": i for i in range(n)} for n in (0, 15, 16, 300)]
    else:
        values = [None, True, False, 0.0, -1.5, 1e300, float("inf"), {"a": [1, {"b": b"c"}]}]
    for v in values:
        packed = _msgpack.packb(v)
        assert packed == msgpack.packb(v, use_bin_type=True)
        assert _msgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False)


@pytest.mark.parametrize(
    "raw",
    [b"", b"\x92\x01", b"\x01\x02", b"\xc1", b"\xd4\x01\x02", b"\x81\x01\x02", b"\xa2\xff\xfe"],
    ids=["empty", "truncated", "extra", "never-used", "ext", "int-key", "bad-utf8"],
)
def test_msgpack_rejects_malformed_with_value_error(raw):
    with pytest.raises(ValueError):
        _msgpack.unpackb(raw)


# ---------------------------------------------------------------------------
# modules under the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version", [1, 2])
def test_huffman_same_bytes_and_reads_reference_streams(version):
    rng = np.random.default_rng(version)
    codes = (32768 + np.rint(rng.normal(scale=30, size=20000))).astype(np.uint16)
    codes[::97] = 0
    ref = r_enc.HuffmanEncoder(stream_version=version).encode(codes)
    port = t_enc.HuffmanEncoder(stream_version=version).encode(codes)
    assert port == ref
    np.testing.assert_array_equal(t_enc.HuffmanEncoder().decode(ref, codes.size), codes)
    legacy = r_enc.LegacyHuffmanEncoder().encode(codes)  # the oldest v1 stream writer
    np.testing.assert_array_equal(t_enc.HuffmanEncoder().decode(legacy, codes.size), codes)
    assert t_enc.HuffmanEncoder().encode(codes[:0]) == r_enc.HuffmanEncoder().encode(codes[:0])


def test_huffman_table_cache_counts_hits():
    t_enc.clear_table_cache()
    codes = np.arange(500, dtype=np.uint16) % 7
    blob = t_enc.HuffmanEncoder().encode(codes)
    t_enc.HuffmanEncoder().decode(blob, codes.size)
    stats = t_enc.table_cache_stats()
    assert stats["misses"] == 1 and stats["hits"] == 1 and stats["size"] == 1


@pytest.mark.parametrize("name", ["none", "gzip", "lzma", "zstd"])
def test_lossless_same_bytes_and_bounded(name):
    data = np.random.default_rng(3).integers(0, 8, 50000).astype(np.uint8).tobytes()
    port, ref = t_ll.make(name), r_ll.make(name)
    assert port.name == ref.name
    packed = port.compress(data)
    assert packed == ref.compress(data)
    assert port.decompress_bounded(packed, len(data)) == data
    # every backend refuses to inflate past the declared size; for zstd the
    # frame's declared content size is checked before inflating
    with pytest.raises(tc.ContainerError):
        port.decompress_bounded(packed, len(data) // 2)


def test_zstd_damage_raises_typed_error():
    """A damaged zstd frame raises ContainerError (the reference leaks the
    backend's own exception type here)."""
    backend = t_ll.make("zstd")
    if backend.name != "zstd":
        pytest.skip("zstandard is not installed; zstd writes zlib here")
    packed = bytearray(backend.compress(b"abc" * 1000))
    packed[len(packed) // 2] ^= 0xFF
    with pytest.raises(tc.ContainerError):
        backend.decompress_bounded(bytes(packed[:-3]), 3000)


def test_float_quantizer_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=4000).astype(np.float32)
    pred = np.roll(x, 1).astype(np.float64)
    x[::501] = 1e30  # out of range -> unpredictable
    rq, tq = r_quant.LinearScaleQuantizer(), t_quant.LinearScaleQuantizer()
    rq.begin(1e-3, np.float32)
    tq.begin(1e-3, torch.float32)
    rc, rr = rq.quantize(x, pred)
    tcodes, tr = tq.quantize(torch.from_numpy(x), torch.from_numpy(pred))
    np.testing.assert_array_equal(tcodes.numpy(), rc)
    _assert_same_bits(tr.numpy(), rr)
    assert tq.save() == rq.save()


def test_metrics_match_reference():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(50, 40)).astype(np.float32)
    b = (a + rng.normal(scale=1e-3, size=a.shape)).astype(np.float32)
    for fn in ("max_abs_error", "max_pw_rel_error", "mse", "psnr", "nrmse", "value_range"):
        args = (a,) if fn == "value_range" else (a, b)
        want = getattr(r_metrics, fn)(*args)
        got = getattr(t_metrics, fn)(*(torch.from_numpy(v) for v in args))
        assert got == pytest.approx(want, rel=1e-12), fn
    assert t_metrics.bit_rate(a, 100) == r_metrics.bit_rate(a, 100)
    assert t_metrics.compression_ratio(8000, 100) == r_metrics.compression_ratio(8000, 100)
    assert t_metrics.psnr(a, a) == r_metrics.psnr(a, a) == float("inf")


def test_estimators_match_reference():
    from repro.core import predictors as r_pred

    x = FIELDS["2d"]
    want = r_pred.lorenzo_residuals(x, 1e-3)
    got = t_pred.lorenzo_residuals(torch.from_numpy(x), 1e-3)
    np.testing.assert_array_equal(got, want)
    conf = tc.CompressionConfig()
    # scored on the host in numpy, so equal to the last bit
    assert t_pred.LorenzoPredictor(order=1).estimate_error(
        torch.from_numpy(x), 1e-3, conf
    ) == RLorenzo(order=1).estimate_error(x, 1e-3, RConf())
    assert t_pred.ZeroPredictor().estimate_error(
        torch.from_numpy(x), 1e-3, conf
    ) == RZero().estimate_error(x, 1e-3, RConf())


def test_crc_rule_matches_reference():
    assert t_int.CHECKSUM_ALGO == r_int.CHECKSUM_ALGO
    data = b"sz3" * 1000
    for algo in ("crc32",) + (("crc32c",) if r_int.CHECKSUM_ALGO == "crc32c" else ()):
        assert t_int.checksum(data, algo=algo) == r_int.checksum(data, algo=algo)
    assert t_int.checksum(data, algo="crc32") == zlib.crc32(data)


@pytest.mark.parametrize("start", [0, 0x9E3779B9])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 4095, 65537, (1 << 20) + 3])
def test_numpy_crc32c_equals_google_crc32c(n, start, monkeypatch):
    google_crc32c = pytest.importorskip("google_crc32c")
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    want = google_crc32c.extend(start, data)
    assert t_int.crc32c_numpy(data, start) == want
    monkeypatch.setattr(t_int, "_crc32c_mod", None)
    assert t_int.checksum(data, start, algo="crc32c") == want
