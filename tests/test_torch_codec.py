"""The port's numcodecs-compatible codec facade (``repro_torch.codec``) held
to the contracts of ``tests/test_codec.py`` and against the JAX package's
``repro.codec``, on the CPU.

* the plain-object contract (numcodecs is optional and absent here): the
  bound of every mode, pointwise-relative bounds, decoding into a caller's
  buffer, the config round trip, and the rejections;
* same input, same bytes: ``Sz3Codec(..., device="cpu")`` writes the
  reference codec's bytes for every mode and engine tried, each codec
  decodes the other's bytes to the same bits, and the two configs are
  equal key for key;
* the zarr round trip runs where numcodecs and zarr are importable;
* without a card, the default device raises instead of running on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.codec import Sz3Codec

try:  # the differential tests need the JAX package
    from repro.codec import Sz3Codec as RCodec
except ImportError:  # pragma: no cover - a machine without JAX
    RCodec = None

CPU = "cpu"
needs_reference = pytest.mark.skipif(RCodec is None, reason="the JAX package is not importable")


def _smooth(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    for ax in range(x.ndim):
        x = np.cumsum(x, axis=ax)
    return np.ascontiguousarray(x.astype(dtype))


BOUNDS = [
    ({"eb_mode": "abs", "eb_abs": 1e-3}, lambda x: 1e-3),
    ({"eb_mode": "rel", "eb_rel": 1e-4}, lambda x: 1e-4 * np.ptp(x)),
    ({"eb_mode": "abs-and-rel", "eb_abs": 1e-3, "eb_rel": 1e-4}, lambda x: min(1e-3, 1e-4 * np.ptp(x))),
    ({"eb_mode": "abs", "eb_abs": 1e-3, "predictor": "fast"}, lambda x: 1e-3),
    ({"eb_mode": "abs", "eb_abs": 1e-3, "predictor": "hybrid"}, lambda x: 1e-3),
]


@pytest.mark.parametrize("kwargs,tol_of", BOUNDS)
def test_encode_decode_bound(kwargs, tol_of):
    codec = Sz3Codec(**kwargs, device=CPU)
    x = _smooth((64, 48), seed=3)
    out = np.asarray(codec.decode(codec.encode(x)))
    assert out.shape == x.shape and out.dtype == x.dtype
    tol = tol_of(np.asarray(x, np.float64))
    assert np.abs(out.astype(np.float64) - x).max() <= tol * (1 + 1e-6)


def test_pw_rel_bound_nonzero_pointwise():
    codec = Sz3Codec(eb_mode="pw_rel", eb_rel=1e-3, device=CPU)
    rng = np.random.default_rng(5)
    x = np.exp(rng.normal(0, 2, 4000)).astype(np.float32)
    x[rng.random(4000) < 0.3] *= -1
    x[::97] = 0.0
    out = np.asarray(codec.decode(codec.encode(x)))
    nz = x != 0
    rel = np.abs(out[nz].astype(np.float64) - x[nz]) / np.abs(x[nz])
    assert rel.max() <= 1e-3 * (1 + 1e-6)
    assert np.all(out[~nz] == 0.0)


def test_decode_into_out_buffer():
    codec = Sz3Codec(eb_mode="abs", eb_abs=1e-3, device=CPU)
    x = _smooth((1000,), seed=1)
    blob = codec.encode(x)
    out = np.empty_like(x)
    ret = codec.decode(blob, out=out)
    assert ret is out
    assert np.abs(out - x).max() <= 1e-3 * (1 + 1e-6)
    buf = bytearray(x.nbytes)
    codec.decode(blob, out=buf)
    assert np.abs(np.frombuffer(buf, x.dtype) - x).max() <= 1e-3 * (1 + 1e-6)


def test_config_roundtrip_identity():
    codec = Sz3Codec(eb_mode="abs-or-rel", eb_abs=2e-3, eb_rel=1e-5, predictor="fast", device=CPU)
    cfg = codec.get_config()
    assert cfg["id"] == "repro.sz3"
    clone = Sz3Codec.from_config(cfg, device=CPU)
    assert clone.get_config() == cfg
    assert clone.decode(codec.encode(_smooth((500,), seed=2))) is not None


@pytest.mark.parametrize(
    "bad",
    [
        {"eb_mode": "nope"},
        {"predictor": "nope"},
        {"eb_mode": "abs-and-rel"},  # composite without eb_rel
        {"eb_mode": "psnr"},  # psnr without eb_psnr
    ],
)
def test_validation_rejections(bad):
    with pytest.raises(ValueError):
        Sz3Codec(**bad, device=CPU)


def test_non_float_buffer_rejected():
    codec = Sz3Codec(device=CPU)
    with pytest.raises((TypeError, ValueError)):
        codec.encode(np.array(["a", "b"]))
    with pytest.raises((TypeError, ValueError)):
        codec.encode(torch.zeros(4, dtype=torch.complex64))


def test_zarr_roundtrip():
    pytest.importorskip("numcodecs")
    zarr = pytest.importorskip("zarr")

    x = _smooth((128, 96), seed=9)
    codec = Sz3Codec(eb_mode="abs", eb_abs=1e-3, predictor="fast", device=CPU)
    try:
        z = zarr.array(x, chunks=(64, 48), compressor=codec)
    except TypeError:  # zarr v3 spells the kwarg differently
        z = zarr.array(x, chunks=(64, 48), compressors=[codec])
    out = np.asarray(z[:])
    assert out.shape == x.shape
    assert np.abs(out.astype(np.float64) - x).max() <= 1e-3 * (1 + 1e-6)


def test_encode_accepts_tensors():
    codec = Sz3Codec(eb_mode="abs", eb_abs=1e-3, device=CPU)
    x = _smooth((40, 30), seed=4)
    assert codec.encode(torch.from_numpy(x)) == codec.encode(x)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sz3Codec().encode(_smooth((100,)))


# ---------------------------------------------------------------------------
# against the reference codec
# ---------------------------------------------------------------------------

SAME_BYTES = [
    {"eb_mode": "abs", "eb_abs": 1e-3},
    {"eb_mode": "rel", "eb_rel": 1e-4},
    {"eb_mode": "abs-and-rel", "eb_abs": 1e-3, "eb_rel": 1e-4},
    {"eb_mode": "abs-or-rel", "eb_abs": 1e-3, "eb_rel": 1e-4, "predictor": "lorenzo"},
    {"eb_mode": "abs", "eb_abs": 1e-3, "predictor": "fast"},
    {"eb_mode": "abs", "eb_abs": 1e-3, "predictor": "hybrid"},
    {"eb_mode": "abs", "eb_abs": 1e-3, "predictor": "sz3_transform"},
    {"eb_mode": "rel", "eb_rel": 1e-3, "predictor": "lr"},
    {"eb_mode": "pw_rel", "eb_rel": 1e-3},
    {"eb_mode": "pw_rel", "eb_rel": 1e-3, "predictor": "lorenzo"},
    {"eb_mode": "psnr", "eb_psnr": 50.0},
    {"eb_mode": "psnr", "eb_psnr": 50.0, "predictor": "lorenzo"},
]


@needs_reference
@pytest.mark.parametrize("kwargs", SAME_BYTES, ids=lambda k: "-".join(str(v) for v in k.values()))
def test_same_bytes_and_cross_decode(kwargs):
    x = _smooth((64, 48), seed=6)
    ours, theirs = Sz3Codec(**kwargs, device=CPU), RCodec(**kwargs)
    blob = ours.encode(x)
    assert blob == theirs.encode(x)
    a, b = ours.decode(blob), np.asarray(theirs.decode(blob))
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8))
    assert ours.get_config() == theirs.get_config()
    assert RCodec.from_config(ours.get_config()).get_config() == ours.get_config()
