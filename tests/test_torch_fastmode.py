"""The port's fast tier (``sz3_fast``, v6) held against the JAX package, on
the CPU.

* same input, same bytes: on the host route (float64 block means in numpy's
  pairwise summation order, all block arithmetic in the storage dtype) the
  port's blob equals the reference's, and each package decodes the other's
  blob to the same bits;
* kernel-route blobs (``route="force"``: the plain classify+reduce version
  on the CPU) decode to the same array in both packages: both decoders are
  deterministic storage-dtype arithmetic from the stored means;
* the plain ``block_stats`` agrees with the JAX kernel (interpret mode)
  within ``1e-6 * max|x|`` per block: XLA sums the JAX kernel's blocks in
  its own order, the port's kernel and plain version in the written order;
* PW_REL composes ``LogTransform`` and writes the reference's bytes on the
  host route; the committed v6 fixtures and fault fixtures behave as pinned.

The ``cuda``-marked tests hold the CUDA kernel against its plain version
and run on a card (``python -m pytest -q -m cuda tests/test_torch_fastmode.py``).
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import CompressionConfig as RConf
from repro.core import ErrorBoundMode as RMode
from repro.core import decompress as ref_decompress
from repro.core import fastmode as r_fm

import repro_torch.core as tc
from repro_torch.core import fastmode as t_fm
from repro_torch.kernels.fastmode import kernel as K
from repro_torch.kernels.fastmode import ops as fops
from repro_torch.kernels.fastmode import ref as fref

DATA = pathlib.Path(__file__).parent / "data"
FAULTS = DATA / "faults"
CPU = "cpu"
#: block statistics: |port - JAX kernel| <= TOL * max|x| per block.  Both
#: sum bs float32 terms, in different orders; each order's rounding error is
#: a few float32 ulps of max|x| per tree level.  TOL is 2^-24 * 16.8: the
#: largest gap seen is 2.14e-7 * max|x| (a random walk at bs 128), so the
#: tighter 2e-7 does not hold
TOL = 1e-6


def _mixed(tail=37):
    """The ``v6_fast_mixed_abs`` recipe (tests/data/gen_conformance.py):
    constant blocks, several widths, a non-finite triple, a tail block."""
    rng = np.random.default_rng(18)
    f = np.concatenate(
        [
            np.full(512, -1.75),
            np.cumsum(rng.standard_normal(512)),
            np.cumsum(rng.standard_normal(512)) * 40.0,
            np.zeros(256),
            np.cumsum(rng.standard_normal(tail)),
        ]
    ).astype(np.float32)
    f[700] = np.nan
    f[701] = np.inf
    f[1500] = -np.inf
    return f


def _make_fields():
    rng = np.random.default_rng(2023)
    yy, xx = np.mgrid[0:50, 0:77] / 7.0
    smooth = (np.sin(yy) * np.cos(1.3 * xx) * 20 + 0.01 * rng.normal(size=yy.shape)).astype(np.float32)
    walk = np.cumsum(rng.normal(size=70001)).astype(np.float32)  # >= 2^16: a tail block
    return {
        "smooth": smooth,
        "walk": walk,
        "const": np.full(2100, 2.5, np.float32),
        "mixed": _mixed(),
        "f64": np.cumsum(rng.normal(size=(33, 41)), axis=1) * 1e3,
        "wild": (rng.standard_normal(4000) * np.exp(rng.uniform(-20, 20, 4000))).astype(np.float32),
    }


FIELDS = _make_fields()
MODES = {"abs": ("abs", 1e-3), "rel": ("rel", 1e-4)}


def _confs(mode):
    name, eb = MODES[mode]
    return RConf(mode=RMode(name), eb=eb), tc.CompressionConfig(mode=tc.ErrorBoundMode(name), eb=eb)


def _port(x, conf, bs=256, route="auto"):
    return tc.sz3_fast(bs=bs, route=route, device=CPU).compress(x, conf).blob


def _ref(x, conf, bs=256, device="off"):
    return r_fm.sz3_fast(bs=bs, device=device).compress(x, conf).blob


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


# ---------------------------------------------------------------------------
# host route: same bytes, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("bs", [128, 256])
def test_host_route_same_bytes(field, mode, bs):
    rconf, tconf = _confs(mode)
    x = FIELDS[field]
    port = _port(x, tconf, bs)
    assert port == _ref(x, rconf, bs)
    _same_bits(tc.decompress(port, device=CPU).numpy(), ref_decompress(port))


@pytest.mark.parametrize("mode", ["abs-and-rel", "abs-or-rel"])
def test_composite_modes_same_bytes(mode):
    x = FIELDS["smooth"]
    rconf = RConf(mode=RMode(mode), eb=1e-3, eb_rel=1e-4)
    tconf = tc.CompressionConfig(mode=tc.ErrorBoundMode(mode), eb=1e-3, eb_rel=1e-4)
    assert _port(x, tconf) == _ref(x, rconf)


@pytest.mark.parametrize("value", [np.float32(-3.5), np.zeros((0, 3), np.float32), np.arange(5, dtype=np.float64)])
def test_degenerate_shapes_same_bytes(value):
    rconf, tconf = _confs("rel")
    port = _port(value, tconf)
    assert port == _ref(value, rconf)
    _same_bits(tc.decompress(port, device=CPU).numpy(), ref_decompress(port))


def test_reference_blobs_decode_to_the_same_bits():
    rconf, _ = _confs("abs")
    for bs in (128, 256):
        blob = _ref(FIELDS["mixed"], rconf, bs, device="force")
        _same_bits(tc.decompress(blob, device=CPU).numpy(), ref_decompress(blob))


@pytest.mark.parametrize("field", ["smooth", "wild", "f64"])
def test_estimate_error_matches_reference(field):
    x = FIELDS[field]
    for bs in (128, 256):
        for eb in (1e-2, 1e-5):
            want = r_fm.sz3_fast(bs=bs).estimate_error(x, eb, RConf())
            got = t_fm.FastModeCompressor(bs=bs, device=CPU).estimate_error(x, eb, tc.CompressionConfig())
            assert got == pytest.approx(want, rel=1e-12)


def test_required_bits_is_exact():
    m = np.concatenate([
        np.arange(0, 4097),
        (1 << np.arange(31))[:, None] + np.array([-1, 0, 1])[None, :],
    ], axis=None).astype(np.int64)
    m = m[(m >= 0) & (m <= (1 << 30) + 1)]
    got = t_fm._required_bits(torch.from_numpy(m)).numpy()
    want = np.array([int(v).bit_length() for v in m], np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, r_fm._required_bits(m))


@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairwise_means_equal_numpys(bs, dtype):
    """numpy's float64 block means, bit for bit, on blocks with extreme
    dynamic range, where a plain sequential sum differs in the last bit."""
    rng = np.random.default_rng(bs)
    x = (rng.standard_normal((3000, bs)) * np.exp(rng.uniform(-30, 30, (3000, bs)))).astype(dtype)
    want = x.mean(axis=1, dtype=np.float64)
    got = t_fm.true_div(t_fm.pairwise_rowsum(torch.from_numpy(x).to(torch.float64)), float(bs))
    _same_bits(got.numpy(), want)


# ---------------------------------------------------------------------------
# kernel route (the plain classify+reduce version on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["smooth", "walk", "mixed", "wild", "f64", "const"])
@pytest.mark.parametrize("bs", [128, 256])
def test_kernel_route_blobs_decode_alike_in_both_packages(field, bs):
    rconf, tconf = _confs("abs")
    x = FIELDS[field]
    blob = _port(x, tconf, bs, route="force")
    header = tc.parse_header(blob)[0]
    assert header["fast_meta"]["device"] == 1
    port_out = tc.decompress(blob, device=CPU).numpy()
    _same_bits(port_out, ref_decompress(blob))
    fin = np.isfinite(x)
    _same_bits(port_out[~fin], x[~fin])
    assert np.max(np.abs(port_out[fin].astype(np.float64) - x[fin])) <= header["abs_eb"]


def test_auto_route_takes_the_host_route_on_the_cpu():
    _, tconf = _confs("abs")
    blob = _port(FIELDS["walk"], tconf)
    assert tc.parse_header(blob)[0]["fast_meta"]["device"] == 0


@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("field", ["smooth", "walk", "wild", "const"])
def test_plain_block_stats_match_jax_kernel(bs, field):
    from repro.kernels.compat import HAS_PALLAS_TPU

    if not HAS_PALLAS_TPU:
        pytest.skip("jax.experimental.pallas.tpu is not importable in this JAX build")
    from repro.kernels.fastmode import ops as jops

    xb = t_fm._pad_blocks_1d(torch.from_numpy(FIELDS[field].reshape(-1)), bs)[0]
    m_j, d_j = jops.block_stats(xb.numpy(), interpret=True)
    m_t, d_t = fops.block_stats(xb)
    tol = TOL * xb.abs().amax(dim=1).double().numpy()
    assert np.all(np.abs(m_t.double().numpy() - m_j) <= tol)
    assert np.all(np.abs(d_t.double().numpy() - d_j) <= 2 * tol)  # |dmean| + one rounding


def test_plain_block_stats_sum_in_the_lane_order():
    """Lane l sums elements 4l..4l+3 (then 128+4l..); lanes combine by
    halving: the kernel's xor-shuffle tree."""
    x = np.random.default_rng(1).standard_normal((3, 256)).astype(np.float32) * 1e4
    lanes = np.zeros((3, 32), np.float32)
    for r in range(3):
        for lane in range(32):
            s = np.float32(x[r, 4 * lane])
            for idx in [4 * lane + 1, 4 * lane + 2, 4 * lane + 3] + [128 + 4 * lane + j for j in range(4)]:
                s = np.float32(s + x[r, idx])
            lanes[r, lane] = s
    while lanes.shape[1] > 1:
        h = lanes.shape[1] // 2
        lanes = (lanes[:, :h] + lanes[:, h:]).astype(np.float32)
    means, devs = fref.block_stats(torch.from_numpy(x))
    _same_bits(means.numpy(), (lanes[:, 0] / np.float32(256)).astype(np.float32))
    _same_bits(devs.numpy(), np.abs(x - means.numpy()[:, None]).max(axis=1))


def test_plain_block_stats_propagate_nan():
    x = np.ones((3, 128), np.float32)
    x[1, 5] = np.nan
    x[2, 7] = np.inf
    means, devs = fref.block_stats(torch.from_numpy(x))
    assert means[0] == 1 and devs[0] == 0
    assert torch.isnan(means[1]) and torch.isnan(devs[1])
    assert torch.isinf(means[2]) and torch.isnan(devs[2])


def test_cpu_tensors_use_the_plain_version_and_count_no_launch():
    K.reset_launches()
    _port(FIELDS["walk"], _confs("abs")[1], route="force")
    fops.block_stats(torch.zeros((4, 128)))
    assert K.LAUNCHES["block_stats"] == 0


def test_kernel_wrapper_refuses_non_cuda_tensors():
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            K.block_stats(torch.zeros((4, 128), device=dev))


def test_library_is_named_after_its_source():
    assert K.LIBRARY.src.name == "fastmode.cu" and K.LIBRARY.src.exists()
    assert K.library_path().name.startswith("libfastmode-")


# ---------------------------------------------------------------------------
# PW_REL and argument checks
# ---------------------------------------------------------------------------

def _pw_rel_field(name):
    """A field with negatives, zeros, NaN and +-inf written in, for PW_REL."""
    x = FIELDS[name].copy().reshape(-1)
    x[~np.isfinite(x)] = 1.0
    x = np.where(x == 0, 1.0, x).astype(x.dtype)
    x[::11] = 0.0
    x[5], x[6], x[7] = np.nan, np.inf, -np.inf
    return x.reshape(FIELDS[name].shape)


@pytest.mark.parametrize("field", ["smooth", "walk", "mixed", "f64"])
@pytest.mark.parametrize("bs", [128, 256])
def test_pw_rel_composes_log_transform_same_bytes(field, bs):
    """Under PW_REL the fast tier composes LogTransform: on the host route
    the port writes the reference's bytes, each package decodes the other's
    blob to the same bits, and the pointwise bound holds."""
    x = _pw_rel_field(field)
    rconf = RConf(mode=RMode.PW_REL, eb=1e-3)
    tconf = tc.CompressionConfig(mode=tc.ErrorBoundMode.PW_REL, eb=1e-3)
    port = _port(x, tconf, bs)
    assert tc.parse_header(port)[0]["spec"]["preprocessor"] == "log"
    ref = _ref(x, rconf, bs)
    assert port == ref
    out = tc.decompress(ref, device=CPU).numpy()
    _same_bits(out, ref_decompress(port))
    x64, o64 = x.astype(np.float64), out.astype(np.float64)
    fin = np.isfinite(x64) & (x64 != 0)
    assert np.all(np.abs(o64[fin] - x64[fin]) <= 1e-3 * np.abs(x64[fin]))
    assert np.all(o64[x64 == 0] == 0)
    _same_bits(out[~np.isfinite(x64)], x[~np.isfinite(x64)])


def test_pw_rel_kernel_route_blobs_decode_alike():
    """route="force" casts the float64 log field to float32 for the plain
    block_stats, as the reference's device="force" does; its blob decodes to
    the same bits in both packages, and so does the reference's."""
    x = _pw_rel_field("walk")
    rconf = RConf(mode=RMode.PW_REL, eb=1e-3)
    tconf = tc.CompressionConfig(mode=tc.ErrorBoundMode.PW_REL, eb=1e-3)
    port = _port(x, tconf, route="force")
    assert tc.parse_header(port)[0]["fast_meta"].get("device")
    for blob in (port, _ref(x, rconf, device="force")):
        _same_bits(tc.decompress(blob, device=CPU).numpy(), ref_decompress(blob))


def test_rejects_bad_block_size_and_route():
    with pytest.raises(ValueError, match="block size"):
        tc.sz3_fast(bs=64, device=CPU)
    with pytest.raises(ValueError, match="route"):
        tc.sz3_fast(route="sometimes", device=CPU)


# ---------------------------------------------------------------------------
# committed fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["v6_fast_mixed_abs", "v6_fast_const_rel"])
def test_v6_conformance_blobs_decode(name):
    blob = (DATA / f"{name}.sz3").read_bytes()
    _same_bits(tc.decompress(blob, device=CPU).numpy(), np.load(DATA / f"{name}.npy"))


def test_v6_fault_fixtures_behave_as_pinned():
    man = json.loads((FAULTS / "manifest.json").read_text())["v6_fast"]
    assert man["generation"] == "v6" and "damaged_chunks" not in man
    want = np.load(FAULTS / "v6_fast.npy")
    pristine = (FAULTS / "v6_fast.sz3").read_bytes()
    _same_bits(tc.decompress(pristine, verify="strict", device=CPU).numpy(), want)
    corrupt = (FAULTS / "v6_fast_corrupt.sz3").read_bytes()
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


def _same_or_both_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    both_nan = torch.isnan(a) & torch.isnan(b)
    return bool((both_nan | (a.view(torch.int32) == b.view(torch.int32))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("nb", [1, 7, 8, 9, 1000, 4096, 8003, 25313, 65537])
def test_cuda_kernel_equals_plain_version(cuda_device, bs, nb):
    """Block counts below, at and past what the card holds at once (each
    warp then walks several blocks), with NaN and +-inf inside blocks and
    as whole blocks."""
    rng = np.random.default_rng(nb)
    x = (rng.standard_normal((nb, bs)) * np.exp(rng.uniform(-10, 10, (nb, 1)))).astype(np.float32)
    x[nb // 2, 3] = np.nan
    x[nb // 3, 5] = np.inf
    x[nb // 4, :] = 7.0
    special = {nb // 2, nb // 3, nb // 4}
    if nb - 1 not in special:
        x[nb - 1, 6] = -np.inf
        special.add(nb - 1)
    whole = [r for r in range(min(nb, 8)) if r not in special][:3]
    if len(whole) == 3:  # rows the cases above leave alone
        x[whole[0], :], x[whole[1], :], x[whole[2], :] = np.nan, np.inf, -np.inf
    xt = torch.from_numpy(x).to(cuda_device)
    m_k, d_k = K.block_stats(xt)
    torch.cuda.synchronize()
    m_r, d_r = fref.block_stats(xt)
    assert _same_or_both_nan(m_k, m_r) and _same_or_both_nan(d_k, d_r)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["walk", "mixed", "wild", "f64", "smooth"])
@pytest.mark.parametrize("bs", [128, 256])
def test_cuda_pipeline_writes_the_plain_versions_bytes(cuda_device, field, bs):
    """On the card, route="auto" takes the kernel for 2^16 elements and up and
    writes the bytes the plain version (route="force") writes on the CPU;
    smaller inputs take the host route and write the CPU's host bytes."""
    _, tconf = _confs("abs")
    x = FIELDS[field]
    K.reset_launches()
    card = tc.sz3_fast(bs=bs, device=cuda_device).compress(x, tconf).blob
    kernel = -(-x.size // bs) * bs >= 1 << 16
    assert K.LAUNCHES["block_stats"] == int(kernel)
    assert card == _port(x, tconf, bs, route="force" if kernel else "auto")
    out = tc.decompress(card, device=cuda_device).cpu().numpy()
    _same_bits(out, tc.decompress(card, device=CPU).numpy())
