"""The port's transform coder (``sz3_transform``, v3) held against the JAX
package, on the CPU.

* same input, same bytes: on the host route (float64, numpy's rounding)
  the port's blob equals the reference's, and each package decodes the
  other's blob to the same bits;
* the plain float32 transform equals the JAX kernel (interpret mode) within
  ``2e-6 * max|x|``: XLA reassociates the JAX kernel's sums, the port's
  kernel and plain version keep the written order;
* kernel-route blobs (``route="force"``: the plain versions on the CPU)
  decode within the bound in both packages; the reference decodes them
  through its float64 host inverse (the ``device_backend`` tag is never a
  JAX backend name); their bands differ from the reference's
  ``device="force"`` bands only by one, where the reference's scaled
  coefficient lies within the tolerance of a rounding tie;
* committed v3 fixtures and fault fixtures behave as pinned;
* the rotation reads float32 or float64 and writes either (``out_dtype``):
  on float64 grids with values float32 does not hold, +-inf and
  subnormals it equals the JAX pipelines (which cast to float32 first)
  within the same tolerance, equals the old cast, rotate, cast sequence bit
  for bit, and the coder hands it its float64 grids with no cast around it.

The ``cuda``-marked tests hold the CUDA kernels against their plain versions
and run on a card (``python -m pytest -q -m cuda tests/test_torch_transform.py``).
"""
import json
import pathlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro.core import CompressionConfig as RConf
from repro.core import ErrorBoundMode as RMode
from repro.core import decompress as ref_decompress
from repro.core import transform as r_tr
from repro.core.transform import TransformCompressor as RTransform

import repro_torch.core as tc
from repro_torch.core import transform as t_tr
from repro_torch.kernels.transform import kernel as K
from repro_torch.kernels.transform import ops as tops
from repro_torch.kernels.transform import ref as tref

DATA = pathlib.Path(__file__).parent / "data"
FAULTS = DATA / "faults"
CPU = "cpu"
JAX_BACKENDS = ("cpu", "gpu", "cuda", "tpu", "rocm")
#: float32 transform: |port - JAX kernel| <= TOL * max|x| elementwise (a few
#: float32 ulps of the largest coefficient, from XLA's reassociation)
TOL = 2e-6


def _make_fields():
    rng = np.random.default_rng(2022)
    yy, xx = np.mgrid[0:64, 0:96] / 9.0
    f2 = (np.sin(yy) * np.cos(1.3 * xx) * 50 + 0.01 * rng.normal(size=yy.shape)).astype(np.float32)
    rag = np.cumsum(rng.normal(size=(61, 99)), axis=1).astype(np.float32)
    f1 = np.cumsum(rng.normal(size=5003) * 0.05).astype(np.float32)
    f3 = np.cumsum(rng.normal(size=(7, 10, 13)), axis=2).astype(np.float32)
    fnan = f2.copy()
    fnan[3, 4], fnan[5, 6], fnan[7, 8] = np.nan, np.inf, -np.inf
    osc = (np.sin(0.93 * np.pi * np.arange(8192)) + 0.1 * rng.normal(size=8192)).astype(np.float32)
    # three rows or columns pad to an axis of exactly 4 (numpy: BLAS dgemv)
    short = np.cumsum(rng.normal(size=(3, 5000)), axis=1).astype(np.float32)
    return {
        "2d": f2, "ragged": rag, "1d": f1, "3d": f3, "nan": fnan,
        "f64": rag.astype(np.float64) * 1e3, "osc": osc, "tiny": f2[:3, :5],
        "short": short, "column": np.ascontiguousarray(short.T),
    }


FIELDS = _make_fields()
MODES = {"abs": ("abs", 1e-3), "rel": ("rel", 1e-4)}


def _confs(mode):
    name, eb = MODES[mode]
    return RConf(mode=RMode(name), eb=eb), tc.CompressionConfig(mode=tc.ErrorBoundMode(name), eb=eb)


def _port(x, conf, route="auto", **kw):
    return tc.sz3_transform(route=route, device=CPU).compress(x, conf, **kw)


def _ref(x, conf, device="auto", **kw):
    return RTransform(device=device).compress(x, conf, **kw)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


# ---------------------------------------------------------------------------
# host route: same bytes, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("mode", list(MODES))
def test_host_route_same_bytes(field, mode):
    rconf, tconf = _confs(mode)
    x = FIELDS[field]
    assert _port(x, tconf).blob == _ref(x, rconf).blob


@pytest.mark.parametrize("field", ["2d", "ragged", "3d", "nan", "f64"])
def test_cross_decode_host_route(field):
    rconf, tconf = _confs("abs")
    x = FIELDS[field]
    port, ref = _port(x, tconf).blob, _ref(x, rconf).blob
    for blob in (port, ref):
        _same_bits(tc.decompress(blob, device=CPU).numpy(), ref_decompress(blob))


@pytest.mark.parametrize("value", [np.float32(3.25), np.zeros((0, 5), np.float32), np.zeros(7, np.float64)])
def test_degenerate_shapes_same_bytes(value):
    rconf, tconf = _confs("rel")
    port = _port(value, tconf).blob
    assert port == _ref(value, rconf).blob
    _same_bits(tc.decompress(port, device=CPU).numpy(), ref_decompress(port))


@pytest.mark.parametrize("shape", [(4,), (48,), (40, 48), (4, 48), (40, 4), (8, 12, 16), (8, 4, 16)])
def test_float64_host_transform_is_numpys(shape):
    """numpy's product runs BLAS dgemm along the contiguous last axis, its
    own loop along the others and dgemv along an axis of 4; the port's host
    transform is that product on every axis."""
    x = np.random.default_rng(len(shape)).normal(size=shape) * 100
    for fn in ("_fwd_host", "_inv_host"):
        want = getattr(r_tr, fn)(x)
        got = getattr(t_tr, fn)(torch.from_numpy(x))
        _same_bits(got.numpy(), want)


def test_numpy_rounding_probe_finds_this_numpy():
    """The probe names how this machine's numpy rounds the float64 product:
    BLAS dgemm's FMA chain along a last axis longer than 4, BLAS dgemv's
    pairwise orders along an axis of exactly 4 (one per matrix layout), and,
    along the other axes, numpy's own loop: an FMA chain in numpy 2.3,
    separate multiplies and adds (none of the kernel's orders) in 2.0."""
    for shape, ax, m, want in [
        ((40, 48), 1, tref.MAT, ("fma_chain",)),
        ((8, 12, 16), 2, tref.MAT.T, ("fma_chain",)),
        ((64,), 0, tref.MAT, ("fma_chain",)),
        ((4, 5000), 0, tref.MAT, ("pairs",)),
        ((5000, 4), 1, tref.MAT.T, ("pair_fma",)),
        ((8, 4, 16), 1, tref.MAT.T, ("pair_fma",)),
        ((40, 48), 0, tref.MAT, ("fma_chain", None)),
    ]:
        assert tref.numpy_rounding(shape, ax, m) in want, (shape, ax)
    # fma keeps the product's low bits that a rounded multiply drops
    n, d = (1.0 / 3.0).as_integer_ratio()
    assert tref._fma((3 * n, d), -1.0) == -2.0**-54 and 3.0 * (1.0 / 3.0) - 1.0 == 0.0


def test_exact_orders_match_float64_arithmetic():
    """The probe's exact evaluation of each order equals the same order in
    numpy's float64 adds and in Fraction arithmetic rounded once per FMA."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        m, b = rng.normal(size=4), rng.normal(size=4) * 100
        exact = [Fraction(a) * Fraction(c) for a, c in zip(m.tolist(), b.tolist())]
        p = [(e.numerator, e.denominator) for e in exact]
        r = m * b

        def fma(j, c):
            return float(exact[j] + Fraction(c))

        assert tref._exact_dot("fma_chain", p) == fma(3, fma(2, fma(1, r[0])))
        assert tref._exact_dot("pairs", p) == (r[0] + r[2]) + (r[1] + r[3])
        assert tref._exact_dot("pair_fma", p) == fma(3, fma(2, r[0] + r[1]))


@pytest.mark.parametrize("field", ["2d", "1d", "3d", "osc"])
def test_estimate_error_matches_reference(field):
    x = FIELDS[field]
    for eb in (1e-2, 1e-4):
        want = RTransform().estimate_error(x, eb, RConf())
        got = t_tr.TransformCompressor(device=CPU).estimate_error(x, eb, tc.CompressionConfig())
        assert got == pytest.approx(want, rel=1e-12)


def test_basis_matches_reference():
    _same_bits(t_tr.MAT, r_tr.MAT)
    assert t_tr.AMP_1AXIS == r_tr.AMP_1AXIS


# ---------------------------------------------------------------------------
# the float32 transform against the JAX kernel
# ---------------------------------------------------------------------------

SHAPES_2D = [(8, 128), (64, 96), (12, 20), (260, 516)]
SHAPES_1D = SHAPES_2D + [(1, 4096), (1, 8), (3, 44)]
MODE_SHAPES = [("1d", s) for s in SHAPES_1D] + [("2d", s) for s in SHAPES_2D]


@pytest.mark.parametrize("mode,shape", MODE_SHAPES)
def test_plain_transform_matches_jax_kernel(shape, mode):
    import jax.numpy as jnp
    from repro.kernels.compat import HAS_PALLAS_TPU

    if not HAS_PALLAS_TPU:
        pytest.skip("jax.experimental.pallas.tpu is not importable in this JAX build")
    from repro.kernels.transform import ops as jops

    rng = np.random.default_rng(shape[0] * shape[1])
    x = np.cumsum(rng.normal(size=shape), axis=1).astype(np.float32) * 10
    c_j = np.array(jops.transform_fwd(jnp.asarray(x), mode=mode, interpret=True))
    c_t = tops.transform_fwd(torch.from_numpy(x), mode=mode).numpy()
    tol = TOL * float(np.abs(x).max())
    assert np.max(np.abs(c_t.astype(np.float64) - c_j)) <= tol
    b_j = np.asarray(jops.transform_inv(jnp.asarray(c_j), mode=mode, interpret=True))
    b_t = tops.transform_inv(torch.from_numpy(c_j), mode=mode).numpy()
    assert np.max(np.abs(b_t.astype(np.float64) - b_j)) <= tol
    # and the round trip returns the input to float32 rounding
    assert np.max(np.abs(b_t.astype(np.float64) - x)) <= tol


def test_plain_transform_rotates_last_axis_then_rows():
    """The written order: every row's last-axis rotation, then the rows,
    each output ((m0 b0 + m1 b1) + m2 b2) + m3 b3 in float32."""
    x = np.random.default_rng(3).normal(size=(4, 4)).astype(np.float32)
    m = tref.MAT.astype(np.float32)

    def rot(v):
        return [np.float32(np.float32(np.float32(m[k, 0] * v[0]) + np.float32(m[k, 1] * v[1]))
                           + np.float32(m[k, 2] * v[2])) + np.float32(m[k, 3] * v[3]) for k in range(4)]

    t = np.array([rot(row) for row in x], np.float32)
    want = np.array([rot(col) for col in t.T], np.float32).T
    _same_bits(tref.fwd(torch.from_numpy(x), "2d").numpy(), want)


def test_pipeline_wrappers_run_1d_data_as_one_row():
    x = torch.from_numpy(FIELDS["osc"])
    c = tops.fwd_pipeline(x)
    assert c.shape == x.shape
    assert torch.equal(c, tref.fwd(x.reshape(1, -1), "1d")[0])
    assert torch.equal(tops.inv_pipeline(c), tref.inv(c.reshape(1, -1), "1d")[0])


def _awkward_f64(shape, seed):
    """A float64 grid of whole blocks: values float32 does not hold (thirds,
    tenths, 1e39 that overflows it, 1e-50 that underflows it), float32
    subnormals in a block of their own, +inf, -inf and both in one block."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(size=shape), axis=-1) * 10 / 3 + 0.1
    flat = x.reshape(-1)
    specials = [1e-40, -3e-41, 7e-39, 1e-45, np.inf, 0, 0, 0, 0, -np.inf, 0, 0, 0, np.inf, -np.inf]
    for i, v in enumerate(specials[: flat.size - 2]):
        if v:
            flat[i] = v
    flat[-1], flat[-2] = 1e39, 1e-50
    return x


def _close_with_non_finite(got: np.ndarray, want: np.ndarray, tol: float) -> None:
    """Non-finite values at the same places with the same sign, finite ones
    within ``tol``."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
    fin = np.isfinite(want)
    assert np.max(np.abs(got[fin] - want[fin])) <= tol


#: 2-D grids run in "2d" mode and 1-D ones in "1d", as the pipelines choose
F64_SHAPES = [(12, 20), (64, 96), (260, 516), (44,), (4096,), (5004,)]
OUT_DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.mark.filterwarnings("ignore:overflow encountered in cast:RuntimeWarning")  # 1e39 to float32
@pytest.mark.parametrize("out", list(OUT_DTYPES))
@pytest.mark.parametrize("shape", F64_SHAPES, ids=str)
def test_plain_transform_on_float64_matches_jax_pipelines(shape, out):
    """The plain version reads the float64 grid and writes ``out_dtype``;
    the JAX pipelines cast to float32 first, as their kernel does inside.
    Same tolerance as ``test_plain_transform_matches_jax_kernel``, against
    the largest finite float32 input; non-finite outputs sit where the
    JAX pipelines' do."""
    from repro.kernels.compat import HAS_PALLAS_TPU

    if not HAS_PALLAS_TPU:
        pytest.skip("jax.experimental.pallas.tpu is not importable in this JAX build")
    from repro.kernels.transform import ops as jops

    out_dtype = OUT_DTYPES[out]
    x = _awkward_f64(shape, sum(shape))
    with np.errstate(over="ignore"):
        x32 = x.astype(np.float32)
    tol = TOL * float(np.abs(x32[np.isfinite(x32)]).max())
    for jfn, tfn in ((jops.fwd_pipeline, tops.fwd_pipeline), (jops.inv_pipeline, tops.inv_pipeline)):
        want = np.asarray(jfn(x, interpret=True))
        got = tfn(torch.from_numpy(x), out_dtype=out_dtype)
        assert got.dtype == out_dtype and tuple(got.shape) == shape
        _close_with_non_finite(got.numpy(), want, tol)


@pytest.mark.parametrize("out", list(OUT_DTYPES))
@pytest.mark.parametrize("src", list(OUT_DTYPES))
@pytest.mark.parametrize("mode,shape", [("2d", (12, 20)), ("2d", (260, 516)), ("1d", (3, 44)), ("1d", (1, 5004))])
def test_out_dtype_equals_the_cast_rotate_cast_sequence(mode, shape, src, out):
    """One call that reads ``src`` and writes ``out`` gives the bits of the
    sequence the coder ran before: cast to float32, rotate, cast."""
    x = torch.from_numpy(_awkward_f64(shape, 3)).to(OUT_DTYPES[src])
    for one, rot in ((tops.transform_fwd, tref.fwd), (tops.transform_inv, tref.inv)):
        got = one(x, mode=mode, out_dtype=OUT_DTYPES[out])
        _same_bits(got.numpy(), rot(x.to(torch.float32), mode).to(OUT_DTYPES[out]).numpy())


def test_kernel_route_hands_the_rotation_float64_grids(monkeypatch):
    """The coder's forward, its float32-inverse check and the tagged decode
    each call the rotation once on the float64 grid, asking for the dtype
    they use next; no cast runs around it."""
    seen = []
    for name in ("fwd_pipeline", "inv_pipeline"):
        fn = getattr(tops, name)

        def spy(x, *, out_dtype=torch.float32, _fn=fn, _name=name):
            seen.append((_name, x.dtype, out_dtype))
            return _fn(x, out_dtype=out_dtype)

        monkeypatch.setattr(t_tr.tops, name, spy)
    conf = _confs("abs")[1]
    blob = _port(FIELDS["nan"], conf, route="force").blob
    assert seen == [("fwd_pipeline", torch.float64, torch.float64), ("inv_pipeline", torch.float64, torch.float64)]
    seen.clear()
    out = tc.decompress(blob, device=CPU)
    assert seen == [("inv_pipeline", torch.float64, torch.float32)]
    assert out.dtype == torch.float32


@pytest.mark.parametrize("bad", [torch.float16, torch.bfloat16, torch.int32, torch.complex64])
@pytest.mark.parametrize("name", ["fwd", "inv"])
def test_rotation_refuses_other_dtypes(name, bad):
    """The kernel wrapper and the plain version take float32 or float64 in
    and out and nothing else; the wrapper says so before it looks at the
    device, so a CPU tensor shows it here."""
    good = torch.zeros((4, 8), dtype=torch.float32)
    for fn in (getattr(K, name), getattr(tref, name), getattr(tops, f"transform_{name}")):
        with pytest.raises(ValueError, match="float32 or float64"):
            fn(good.to(bad), mode="2d")
        with pytest.raises(ValueError, match="out_dtype"):
            fn(good, mode="2d", out_dtype=bad)
    pipe = getattr(tops, f"{name}_pipeline")
    with pytest.raises(ValueError, match="out_dtype"):
        pipe(good.double(), out_dtype=bad)


def test_cpu_tensors_use_the_plain_versions_and_count_no_launch():
    K.reset_launches()
    x = torch.from_numpy(FIELDS["2d"])
    conf = _confs("abs")[1]
    blob = _port(x, conf, route="force").blob
    tc.decompress(blob, device=CPU)
    _port(FIELDS["3d"], conf)
    assert all(v == 0 for v in K.LAUNCHES.values())


@pytest.mark.parametrize("name", ["fwd", "inv", "axis_f64"])
def test_kernel_wrappers_refuse_non_cuda_tensors(name):
    dtype = torch.float64 if name == "axis_f64" else torch.float32
    args = (tref.MAT, 1) if name == "axis_f64" else ()
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            getattr(K, name)(torch.zeros((4, 8), dtype=dtype, device=dev), *args)


def test_axis_kernel_raises_where_numpy_rounds_otherwise(monkeypatch):
    """Where numpy's float64 order is none of the kernel's, the wrapper
    raises before it builds or launches anything; it never falls back to
    numpy on the host."""
    monkeypatch.setattr(tref, "numpy_rounding", lambda shape, ax, m: None)
    monkeypatch.setattr(K, "_check", lambda t, dtype, what: t)
    monkeypatch.setattr(K, "load", lambda: pytest.fail("built the kernel library"))
    with pytest.raises(RuntimeError, match="none of the kernel's orders"):
        K.axis_f64(torch.zeros((8, 8), dtype=torch.float64), tref.MAT, 0)


def test_build_targets_sm90a_without_fast_math():
    from repro_torch.kernels import _build

    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert K.LIBRARY.src.name == "transform.cu" and K.LIBRARY.src.exists()
    assert K.library_path().name.startswith("libtransform-")


# ---------------------------------------------------------------------------
# kernel route (plain versions on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["2d", "ragged", "1d", "osc", "nan"])
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_route_blobs_decode_within_bound_in_both_packages(field, mode):
    rconf, tconf = _confs(mode)
    x = FIELDS[field]
    blob = _port(x, tconf, route="force").blob
    header = tc.parse_header(blob)[0]
    meta = header["meta"]
    assert meta["device"] == 1 and meta["device_backend"] == t_tr.BACKEND_TAG
    assert meta["device_backend"] not in JAX_BACKENDS
    fin = np.isfinite(x)
    for decoder in (lambda b: tc.decompress(b, device=CPU).numpy(), ref_decompress):
        out = np.asarray(decoder(blob))
        _same_bits(out[~fin], x[~fin])  # non-finite points ride the fail channel
        assert np.max(np.abs(out[fin].astype(np.float64) - x[fin])) <= header["abs_eb"]


def test_reference_decodes_port_blobs_through_its_host_inverse():
    """With the port's tag, the reference takes its float64 host inverse;
    the port's own decode takes the float32 inverse the tag names."""
    rconf, tconf = _confs("abs")
    x = FIELDS["2d"]
    blob = _port(x, tconf, route="force").blob
    header, off = tc.parse_header(blob)
    payload = t_tr.ll_mod.make(header["spec"]["lossless"]).decompress(t_tr.container_body(blob, off))
    bands = r_tr._decode_bands(payload, header["nbands"], header["nblocks"])
    k = r_tr._unblockify(bands, tuple(header["pshape"]))
    kstep = k.astype(np.float64) * 2.0 ** header["step_exp"]
    host = r_tr._inv_host(kstep)[: x.shape[0], : x.shape[1]].astype(np.float32)
    _same_bits(ref_decompress(blob), host)
    plain = tops.inv_pipeline(torch.from_numpy(kstep.astype(np.float32)))[: x.shape[0], : x.shape[1]]
    _same_bits(tc.decompress(blob, device=CPU).numpy(), plain.numpy())


def test_port_decodes_reference_kernel_blobs_through_the_host_inverse():
    """A reference ``device="force"`` blob carries a JAX backend tag, so the
    port decodes it through the float64 host inverse, as the reference does
    on the CPU: the same bits."""
    rconf, _ = _confs("abs")
    blob = _ref(FIELDS["2d"], rconf, device="force").blob
    assert tc.parse_header(blob)[0]["meta"]["device_backend"] in JAX_BACKENDS
    _same_bits(tc.decompress(blob, device=CPU).numpy(), ref_decompress(blob))


@pytest.mark.parametrize("field", ["2d", "ragged", "1d", "osc"])
def test_kernel_route_bands_match_reference_but_at_rounding_ties(field):
    """The bands of ``route="force"`` equal the reference's ``device="force"``
    bands except where the reference's scaled coefficient lies within the
    float32 tolerance of a tie; there they differ by one.  Seen: 11, 5 and 2
    of 6144, 8192 and 6400 band entries (2d, osc, ragged at ABS 1e-3), 0 for
    the 1d field."""
    import jax.numpy as jnp
    from repro.kernels.transform import ops as jops

    rconf, tconf = _confs("abs")
    x = FIELDS[field]
    res = _port(x, tconf, route="force", with_stats=True)
    port = res.codes
    ref = _ref(x, rconf, device="force", with_stats=True).codes
    diff = port != ref
    assert np.all(np.abs(port - ref) <= 1)
    assert diff.sum() <= max(2, diff.size // 200)
    header = tc.parse_header(res.blob)[0]
    xp = r_tr._pad_blocks(np.where(np.isfinite(x), x, 0).astype(np.float64)).astype(np.float32)
    c = np.asarray(jops.fwd_pipeline(jnp.asarray(xp), interpret=True) if xp.ndim == 1 else
                   jops.transform_fwd(jnp.asarray(xp), mode="2d", interpret=True), np.float64)
    step = 2.0 ** header["step_exp"]
    scaled = r_tr._blockify(c / step)[diff]
    tie_dist = np.abs(np.abs(scaled - np.floor(scaled)) - 0.5)
    assert np.all(tie_dist <= TOL * float(np.abs(xp).max()) / step)


# ---------------------------------------------------------------------------
# committed fixtures
# ---------------------------------------------------------------------------

def test_v3_conformance_blob_decodes():
    blob = (DATA / "v3_transform_abs.sz3").read_bytes()
    _same_bits(tc.decompress(blob, device=CPU).numpy(), np.load(DATA / "v3_transform_abs.npy"))


def test_v3_fault_fixtures_behave_as_pinned():
    man = json.loads((FAULTS / "manifest.json").read_text())["v3_transform"]
    assert man["generation"] == "v3" and "damaged_chunks" not in man
    want = np.load(FAULTS / "v3_transform.npy")
    pristine = (FAULTS / "v3_transform.sz3").read_bytes()
    _same_bits(tc.decompress(pristine, verify="strict", device=CPU).numpy(), want)
    corrupt = (FAULTS / "v3_transform_corrupt.sz3").read_bytes()
    with pytest.raises(tc.IntegrityError):
        tc.decompress(corrupt, verify="strict", device=CPU)
    data, report = tc.decompress(corrupt, verify="salvage", device=CPU)
    assert not report.ok and report.checksummed
    assert [d.index for d in report.damage] == [0] and report.recovered == []
    assert data.shape == want.shape and not bool(data.any())
    try:  # unverified: a typed error or an array of the pinned shape
        out = tc.decompress(corrupt, verify="off", device=CPU)
    except ValueError:
        return
    assert tuple(out.shape) == want.shape


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


CARD_SHAPES_2D = SHAPES_2D + [(1800, 3600), (1804, 3596)]
CARD_MODE_SHAPES = (
    [("1d", s) for s in CARD_SHAPES_2D + [(1, 4), (3, 44), (1, (1 << 20) + 4)]]
    + [("2d", s) for s in CARD_SHAPES_2D]
)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape", CARD_MODE_SHAPES)
def test_cuda_kernels_equal_plain_versions(cuda_device, shape, mode):
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(np.cumsum(rng.normal(size=shape), axis=1).astype(np.float32)).to(cuda_device)
    c = K.fwd(x, mode)
    torch.cuda.synchronize()
    assert _bits_equal(c, tref.fwd(x, mode))
    b = K.inv(c, mode)
    torch.cuda.synchronize()
    assert _bits_equal(b, tref.inv(c, mode))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(48,), (4,), (40, 48), (8, 12, 16), (1800, 3600), (4, 5000), (5000, 4), (8, 4, 16)]
)
def test_cuda_axis_kernel_equals_numpy(cuda_device, shape):
    """Every axis pattern, an axis of exactly 4 (BLAS dgemv) included, runs
    on the card in numpy's own order and equals numpy bit for bit."""
    x = np.random.default_rng(len(shape)).normal(size=shape) * 100
    for ax in range(len(shape)):
        for m in (tref.MAT, tref.MAT.T):
            K.reset_launches()
            got = tops.apply_axis_f64(torch.from_numpy(x).to(cuda_device), m, ax).cpu()
            assert K.LAUNCHES["axis_f64"] == 1
            want = tref.apply_axis_f64(torch.from_numpy(x), m, ax)
            assert torch.equal(got.view(torch.int64), want.view(torch.int64)), (ax, tref.numpy_rounding(shape, ax, m))


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["2d", "ragged", "1d", "osc", "nan", "3d", "f64", "short", "column"])
def test_cuda_pipeline_writes_the_plain_versions_bytes(cuda_device, field):
    """On the card, route="auto" takes the kernels where the rule holds and
    writes the bytes the plain versions (route="force") write on the CPU;
    3-D and float64 data take the host route and write the CPU's bytes."""
    _, tconf = _confs("abs")
    x = FIELDS[field]
    K.reset_launches()
    card = tc.sz3_transform(device=cuda_device).compress(x, tconf).blob
    kernel = x.ndim in (1, 2) and x.dtype == np.float32 and x.size >= 4096
    assert (K.LAUNCHES["fwd_1d"] + K.LAUNCHES["fwd_2d"] == 1) == kernel
    assert K.LAUNCHES["axis_f64"] > 0  # the float64 product stays on the card
    assert card == _port(x, tconf, route="force" if kernel else "auto").blob
    abs_eb = tc.parse_header(card)[0]["abs_eb"]
    fin = np.isfinite(x)
    for device in (cuda_device, "cpu"):
        out = tc.decompress(card, device=device).cpu().numpy()
        assert np.max(np.abs(out[fin].astype(np.float64) - x[fin])) <= abs_eb


def _bits_equal_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit identity, with any NaN equal to any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = a.view(torch.int64 if a.dtype == torch.float64 else torch.int32)
    both_nan = torch.isnan(a) & torch.isnan(b)
    return bool((both_nan | (ints == b.view(ints.dtype))).all())


#: the main paths' and the checkpoint's shapes, then tails: partial column
#: strips (1804, 3596), (8, 132), 4 rows of 1 block, and "1d" rows whose
#: strip counts (2^24+4 values: 32,769 strips; 40,000 strips and 37 groups)
#: leave a partial round of the grid and a partial strip
CARD_DTYPE_SHAPES = [
    ("2d", (1024, 1024)), ("2d", (4, 1 << 20)), ("2d", (4, 2883584)), ("2d", (1800, 3600)),
    ("1d", (1, (1 << 24) + 4)), ("2d", (1804, 3596)), ("2d", (8, 132)), ("2d", (4, 4)),
    ("1d", (1, 4 * (128 * 40000 + 37))), ("1d", (3, 44)), ("1d", (1, 4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("out", list(OUT_DTYPES))
@pytest.mark.parametrize("src", list(OUT_DTYPES))
@pytest.mark.parametrize("mode,shape", CARD_DTYPE_SHAPES, ids=str)
def test_cuda_rotation_equals_plain_version_for_every_dtype_pair(cuda_device, mode, shape, src, out):
    """float32 or float64 in, float32 or float64 out: the kernel's bits are
    the plain version's on the card, non-finite values and subnormals
    included, one launch a call."""
    x = torch.from_numpy(_awkward_f64(shape, shape[1] % 1000)).to(cuda_device, OUT_DTYPES[src])
    for name in ("fwd", "inv"):
        K.reset_launches()
        got = getattr(K, name)(x, mode, out_dtype=OUT_DTYPES[out])
        torch.cuda.synchronize()
        assert K.LAUNCHES[f"{name}_{mode}"] == 1 and sum(K.LAUNCHES.values()) == 1
        want = getattr(tref, name)(x, mode, out_dtype=OUT_DTYPES[out])
        assert _bits_equal_nan(got, want), (name, mode, shape, src, out)
