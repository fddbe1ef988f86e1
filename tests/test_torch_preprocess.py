"""The port's preprocessors (``repro_torch.core.preprocess``) and the v1
pointwise-relative (PW_REL) composition held against the JAX package, on
the CPU.

* ``Transpose`` and ``Linearize``: the same output array and meta as the
  reference's, and the inverse restores the input;
* ``pw_rel_log_eb`` and ``log_domain_view``: bit-equal;
* ``LogTransform``: the forward log field, the ABS bound it resolves to and
  every meta byte (sign, zero and non-finite bitmaps, the raw values) are
  the reference's on float32 and float64 fields with zeros, negatives, NaN,
  +-inf and subnormals; the inverse gives the reference's bits;
* v1 ``SZ3Compressor(preprocessor=LogTransform(), ...)`` blobs equal the
  reference's, each package decodes the other's blob to the same bits, and
  the pointwise bound holds; the committed ``v1_log_pwrel.sz3`` fixture
  decodes bit-equal to ``repro.core.decompress``.

Fields are made from a seed with numpy at small sizes.  Tolerance: 0 (bits)
everywhere; the pointwise bound is checked as ``|x^ - x| <= eb * |x|``.
"""
import pathlib

import numpy as np
import pytest
import torch

from repro.core import CompressionConfig as RConf
from repro.core import ErrorBoundMode as RMode
from repro.core import decompress as ref_decompress
from repro.core import predictors as r_pred
from repro.core import preprocess as r_pre
from repro.core.pipeline import SZ3Compressor as RSZ3

import repro_torch.core as tc
from repro_torch.core import predictors as t_pred
from repro_torch.core import preprocess as t_pre

DATA = pathlib.Path(__file__).parent / "data"
CPU = "cpu"


def _signed_field(shape, seed, dtype):
    """A positive smooth field with negatives, exact zeros, NaN, +-inf,
    a negative zero and storage-dtype subnormals written in."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 3, s) for s in shape], indexing="ij")
    base = np.exp(sum(np.sin((k + 1.3) * g) for k, g in enumerate(grids)))
    f = (base * (1 + 0.01 * rng.normal(size=shape))).astype(dtype).reshape(-1)
    n = f.size
    pick = rng.permutation(n)
    f[pick[: n // 7]] *= -1
    tiny = np.finfo(dtype).tiny
    f[pick[n // 7 : n // 7 + 3]] = 0.0
    f[pick[n // 7 + 3]] = -0.0
    f[pick[n // 7 + 4]] = np.nan
    f[pick[n // 7 + 5]] = np.inf
    f[pick[n // 7 + 6]] = -np.inf
    f[pick[n // 7 + 7]] = tiny / 4  # subnormal
    f[pick[n // 7 + 8]] = -tiny / 1024
    f[pick[n // 7 + 9]] = tiny  # the smallest normal: logged, not escaped
    return f.reshape(shape)


FIELDS = {
    "f32_2d": _signed_field((37, 53), 1, np.float32),
    "f64_2d": _signed_field((29, 41), 2, np.float64),
    "f32_1d": _signed_field((3001,), 3, np.float32),
    "f64_3d": _signed_field((9, 10, 11), 4, np.float64),
}


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _assert_same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _pw_confs(eb=1e-3):
    return RConf(mode=RMode.PW_REL, eb=eb), tc.CompressionConfig(mode=tc.ErrorBoundMode.PW_REL, eb=eb)


def _assert_pointwise_bound(out, x, eb):
    x64, o64 = np.asarray(x, np.float64), np.asarray(out, np.float64)
    fin = np.isfinite(x64) & (x64 != 0)
    assert np.all(np.abs(o64[fin] - x64[fin]) <= eb * np.abs(x64[fin]))
    assert np.all(o64[x64 == 0] == 0)
    nf = ~np.isfinite(x64)
    _assert_same_bits(np.asarray(out)[nf], np.asarray(x)[nf])


# ---------------------------------------------------------------------------
# Transpose and Linearize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perm", [None, (1, 2, 0), (2, 0, 1), (0, 1, 2)])
@pytest.mark.parametrize("flatten", [False, True])
def test_transpose_meta_and_round_trip(perm, flatten):
    x = FIELDS["f64_3d"]
    conf = tc.CompressionConfig()
    r_out, _, r_meta = r_pre.Transpose(perm=perm, flatten=flatten).forward(x, RConf())
    t_out, conf2, t_meta = t_pre.Transpose(perm=perm, flatten=flatten).forward(torch.from_numpy(x), conf)
    assert conf2 is conf and t_meta == r_meta
    assert t_out.is_contiguous()
    _assert_same_bits(t_out.numpy(), r_out)
    back = t_pre.make("transpose").inverse(t_out, conf, t_meta)
    _assert_same_bits(back.numpy(), x)
    _assert_same_bits(back.numpy(), r_pre.make("transpose").inverse(r_out, RConf(), r_meta))


def test_linearize_meta_and_round_trip():
    x = FIELDS["f32_2d"]
    r_out, _, r_meta = r_pre.Linearize().forward(x, RConf())
    t_out, _, t_meta = t_pre.Linearize().forward(torch.from_numpy(x), tc.CompressionConfig())
    assert t_meta == r_meta and tuple(t_out.shape) == r_out.shape
    _assert_same_bits(t_out.numpy(), r_out)
    _assert_same_bits(t_pre.Linearize().inverse(t_out, None, t_meta).numpy(), x)


# ---------------------------------------------------------------------------
# the log-domain helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eb", [1e-1, 1e-3, 1e-6, 0.5, 0.999, 2.0**-40])
def test_pw_rel_log_eb_bit_equal(eb):
    _assert_same_bits(np.float64(t_pre.pw_rel_log_eb(eb)), np.float64(r_pre.pw_rel_log_eb(eb)))


@pytest.mark.parametrize("eb", [0.0, 1.0, -1e-3, 3.0])
def test_pw_rel_log_eb_rejects_out_of_range(eb):
    with pytest.raises(ValueError, match="pointwise-relative"):
        t_pre.pw_rel_log_eb(eb)


@pytest.mark.parametrize("field", list(FIELDS))
def test_log_domain_view_bit_equal(field):
    x = FIELDS[field]
    want = r_pre.log_domain_view(x)
    _assert_same_bits(t_pre.log_domain_view(torch.from_numpy(x)), want)
    _assert_same_bits(t_pre.log_domain_view(x), want)


# ---------------------------------------------------------------------------
# LogTransform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("eb,thr", [(1e-3, 0.0), (1e-2, 0.0), (1e-5, 0.0), (1e-3, 0.5)])
def test_log_transform_forward_bits_and_meta(field, eb, thr):
    x = FIELDS[field]
    rconf, tconf = _pw_confs(eb)
    r_log, r_conf2, r_meta = r_pre.LogTransform(zero_threshold=thr).forward(x, rconf)
    t_log, t_conf2, t_meta = t_pre.LogTransform(zero_threshold=thr).forward(torch.from_numpy(x), tconf)
    assert t_log.dtype == torch.float64 and tuple(t_log.shape) == x.shape
    _assert_same_bits(t_log.numpy(), r_log)
    assert t_conf2.mode == tc.ErrorBoundMode.ABS and r_conf2.mode == RMode.ABS
    _assert_same_bits(np.float64(t_conf2.eb), np.float64(r_conf2.eb))
    assert t_meta == r_meta
    assert "nonfinite" in t_meta  # NaN, +-inf and the subnormals


@pytest.mark.parametrize("field", list(FIELDS))
def test_log_transform_inverse_bit_equal(field):
    x = FIELDS[field]
    rconf, tconf = _pw_confs()
    r_log, _, meta = r_pre.LogTransform().forward(x, rconf)
    # a perturbed log field, as a lossy decode hands it back
    noisy = r_log + np.random.default_rng(9).uniform(-1e-4, 1e-4, r_log.shape)
    want = r_pre.LogTransform().inverse(noisy, rconf, meta).astype(x.dtype)
    got = t_pre.LogTransform().inverse(torch.from_numpy(noisy), tconf, meta)
    _assert_same_bits(got.numpy().astype(x.dtype), want)
    exact = t_pre.LogTransform().inverse(torch.from_numpy(r_log), tconf, meta).numpy().astype(x.dtype)
    _assert_pointwise_bound(exact, x, 1e-3)


def test_log_transform_refuses_other_modes_and_eb_below_the_floor():
    x = torch.from_numpy(FIELDS["f32_2d"])
    with pytest.raises(ValueError, match="PW_REL"):
        t_pre.LogTransform().forward(x, tc.CompressionConfig())
    with pytest.raises(ValueError, match="rounding floor"):
        t_pre.LogTransform().forward(x, tc.CompressionConfig(mode=tc.ErrorBoundMode.PW_REL, eb=1e-8))


# ---------------------------------------------------------------------------
# v1 PW_REL blobs
# ---------------------------------------------------------------------------

PREDICTORS = {
    "lorenzo": (lambda: r_pred.LorenzoPredictor(), lambda: t_pred.LorenzoPredictor()),
    "lorenzo_seq": (lambda: r_pred.LorenzoSequentialPredictor(), lambda: t_pred.LorenzoSequentialPredictor()),
    "composite": (lambda: r_pred.CompositePredictor(), lambda: t_pred.CompositePredictor()),
    "interp": (lambda: r_pred.InterpolationPredictor(), lambda: t_pred.InterpolationPredictor()),
}


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("pred", list(PREDICTORS))
def test_v1_pw_rel_same_bytes_and_cross_decode(field, pred):
    x = FIELDS[field]
    if pred == "lorenzo_seq" and x.size > 2048:
        x = x.reshape(-1)[:2048]
    rconf, tconf = _pw_confs()
    make_r, make_t = PREDICTORS[pred]
    ref = RSZ3(preprocessor=r_pre.LogTransform(), predictor=make_r()).compress(x, rconf).blob
    port = tc.SZ3Compressor(preprocessor=t_pre.LogTransform(), predictor=make_t(), device=CPU).compress(x, tconf).blob
    assert port == ref
    header = tc.parse_header(port)[0]
    assert header["spec"]["preprocessor"] == "log" and header["pdtype"] == "<f8"
    out = tc.decompress(ref, device=CPU).numpy()
    _assert_same_bits(out, ref_decompress(port))
    assert out.dtype == x.dtype and out.shape == x.shape
    _assert_pointwise_bound(out, x, 1e-3)


def test_v1_log_pwrel_fixture_decodes_like_the_reference():
    blob = (DATA / "v1_log_pwrel.sz3").read_bytes()
    assert tc.parse_header(blob)[0]["spec"]["preprocessor"] == "log"
    out = tc.decompress(blob, device=CPU).numpy()
    _assert_same_bits(out, ref_decompress(blob))
    _assert_same_bits(out, np.load(DATA / "v1_log_pwrel.npy"))


def test_preprocess_register_extends_the_decoder():
    class Negate(t_pre.Preprocessor):
        name = "negate_test"

        def forward(self, data, conf):
            return -data, conf, {}

        def inverse(self, data, conf, meta):
            return -data

    t_pre.register("negate_test", Negate)
    try:
        x = FIELDS["f32_2d"].copy()
        x[~np.isfinite(x)] = 1.0
        conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=1e-2)
        blob = tc.SZ3Compressor(preprocessor=t_pre.make("negate_test"), device=CPU).compress(x, conf).blob
        out = tc.decompress(blob, device=CPU).numpy()
        assert np.max(np.abs(out.astype(np.float64) - x)) <= 1e-2
    finally:
        del t_pre._REGISTRY["negate_test"]
