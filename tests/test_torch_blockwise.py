"""The port's block hybrid (``sz3_hybrid``, v5) held against the JAX
package, on the CPU.

* the per-block helpers (``block_lorenzo_filter``/``_inverse``,
  ``block_plane_fit``) give the reference's integers and float64 values in
  1-D to 4-D, NaN and inf blocks included;
* the contest's pieces are the reference's bit for bit: the gamma lengths
  (table and numpy above it), the per-block winners (ties keep the lowest
  tag), the 2-bit tag packing; ``estimate_error`` returns the reference's
  float;
* same input, same bytes: ``sz3_hybrid`` writes the reference's blob and
  ``with_stats`` meta on 1-D to 4-D, 0-d and empty inputs under ABS, REL
  and PW_REL, on float32, float64 and int input, NaN/inf outliers, constant
  and all-zero input and ``block_side=5``, and each package decodes the
  other's blob to the same bits;
* the committed v5 fixtures decode to the reference's arrays, the v5 fault
  fixtures behave as ``tests/data/faults/manifest.json`` pins them, and a
  mutated port blob decodes to the pristine bits or raises a typed error.

The ``cuda``-marked test holds the card's blob against the plain route's
(``python -m pytest -q -m cuda tests/test_torch_blockwise.py``).
"""
import json
import pathlib
import types

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import blockwise as t_bw
from repro_torch.core import faults
from repro_torch.core import integrity as t_int
from repro_torch.core import predictors as t_pred

try:  # the card's test below needs no JAX
    import repro.core as rc
    from repro.core import blockwise as r_bw
    from repro.core import integrity as r_int
    from repro.core import predictors as r_pred
except ImportError:  # pragma: no cover - a machine without JAX
    rc = None

DATA = pathlib.Path(__file__).parent / "data"
FAULTS = DATA / "faults"
CPU = "cpu"


@pytest.fixture(autouse=True)
def reference_verifies_crc32c(monkeypatch):
    """Where ``google_crc32c`` is missing, the JAX package cannot verify
    CRC32C trailers (ROADMAP queue 3); lend it the port's numpy CRC32C."""
    if rc is not None and r_int._crc32c_mod is None:
        monkeypatch.setattr(r_int, "_crc32c_mod", types.SimpleNamespace(
            extend=lambda value, data: t_int.crc32c_numpy(data, value)))


def _bits(a):
    a = np.asarray(a).reshape(-1)
    return a.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _confs(mode, eb):
    return (
        rc.CompressionConfig(mode=rc.ErrorBoundMode(mode), eb=eb),
        tc.CompressionConfig(mode=tc.ErrorBoundMode(mode), eb=eb),
    )


def _walk(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(shape), axis=-1) * scale).astype(np.float32)


def _fields():
    rng = np.random.default_rng(20)
    nan = _walk((33, 47), 3)
    nan[3, 4], nan[10, 11], nan[20, 30], nan[32, 46] = np.nan, np.inf, -np.inf, np.nan
    mixed = np.load(DATA / "v5_hybrid_mixed_abs.npy")
    return {
        "1d": _walk(1000, 1),
        "2d": _walk((33, 47), 2),
        "3d": _walk((9, 17, 10), 3),
        "4d": _walk((5, 6, 7, 9), 4),
        "0d": np.float32(3.5).reshape(()),
        "empty": np.zeros((0,), np.float32),
        "empty-2d": np.zeros((4, 0), np.float32),
        "f64": np.cumsum(rng.standard_normal((30, 41)), axis=0),
        "int": rng.integers(-50, 50, (30, 30)),
        "nan": nan,
        "const": np.full((40, 40), 2.5, np.float32),
        "zeros": np.zeros((40, 40), np.float32),
        "mixed": mixed,
        "big": (_walk((20, 300), 5) * 1e6).astype(np.float32),
    }


FIELDS = _fields()
MODES = [("abs", 1e-3), ("rel", 1e-3), ("pw_rel", 1e-3)]


# ---------------------------------------------------------------------------
# per-block helpers
# ---------------------------------------------------------------------------

def _blocks(nd, b, seed, nonfinite=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((11,) + (b,) * nd) * np.exp(rng.uniform(-8, 8, (11,) + (1,) * nd))
    x += np.linspace(0, 50, b ** nd).reshape((b,) * nd)
    if nonfinite:
        x[2].flat[1] = np.nan
        x[5].flat[0] = np.inf
        x[7] = 1e300  # scaled past 2^62 bins: a bad fit
    return x


@pytest.mark.parametrize("nd,b", [(1, 256), (1, 5), (2, 16), (2, 5), (3, 8), (4, 4)])
@pytest.mark.parametrize("order", [1, 2])
def test_block_lorenzo_filter_and_inverse(nd, b, order):
    rng = np.random.default_rng(nd * 10 + order)
    q = rng.integers(-(1 << 40), 1 << 40, (7,) + (b,) * nd)
    d_ref = r_pred.block_lorenzo_filter(q, order)
    d = t_pred.block_lorenzo_filter(torch.from_numpy(q), order)
    np.testing.assert_array_equal(d.numpy(), d_ref)
    np.testing.assert_array_equal(t_pred.block_lorenzo_inverse(d, order).numpy(), q)
    np.testing.assert_array_equal(
        t_pred.block_lorenzo_inverse(torch.from_numpy(d_ref), order).numpy(),
        r_pred.block_lorenzo_inverse(d_ref, order),
    )
    f = _blocks(nd, b, order)  # float64 blocks: the estimator's path
    _same_bits(t_pred.block_lorenzo_filter(torch.from_numpy(f), order).numpy(), r_pred.block_lorenzo_filter(f, order))


@pytest.mark.parametrize("nd,b", [(1, 256), (1, 5), (2, 16), (2, 5), (3, 8), (4, 4)])
@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nonfinite"])
def test_block_plane_fit(nd, b, nonfinite):
    x = _blocks(nd, b, nd, nonfinite)
    eb = 1e-3
    cq_ref, pred_ref, bad_ref = r_pred.block_plane_fit(x, b, eb)
    cq, pred, bad = t_pred.block_plane_fit(torch.from_numpy(x), b, eb)
    assert len(cq) == len(cq_ref) == nd + 1
    for a, r in zip(cq, cq_ref):
        np.testing.assert_array_equal(a.numpy(), r)
    _same_bits(pred.numpy(), pred_ref)
    np.testing.assert_array_equal(bad.numpy(), bad_ref)
    assert bad_ref.any() == nonfinite


# ---------------------------------------------------------------------------
# the contest's pieces
# ---------------------------------------------------------------------------

def test_gamma_bits_bit_for_bit():
    rng = np.random.default_rng(6)
    q = np.concatenate([
        np.arange(-3000, 3000),
        rng.integers(-(1 << 20), 1 << 20, 20000),
        [t_bw.GAMMA_TABLE_SIZE - 1, t_bw.GAMMA_TABLE_SIZE, -t_bw.GAMMA_TABLE_SIZE],
        rng.integers(-(1 << 62), 1 << 62, 5000),  # above the table: numpy
        [np.iinfo(np.int64).min, np.iinfo(np.int64).max],
    ]).astype(np.int64)
    _same_bits(t_bw._gamma_bits(torch.from_numpy(q)).numpy(), r_bw._gamma_bits(q))
    f = np.concatenate([q.astype(np.float64), [0.5, -2.25, 1e300, -0.0]])  # float codes too
    _same_bits(t_bw._gamma_bits(torch.from_numpy(f)).numpy(), r_bw._gamma_bits(f))


def _contest_inputs(x, eb, b):
    """The reference's candidate codes for float64 blocks, and the port's."""
    qfull = np.rint(np.clip(np.where(np.isfinite(x / (2 * eb)), x / (2 * eb), 0.0), -(2.0**62), 2.0**62))
    ref = r_bw._candidate_codes(x, qfull, eb)
    port = t_bw._candidate_codes(torch.from_numpy(x), torch.from_numpy(qfull), eb)
    return qfull, ref, port


@pytest.mark.parametrize("nd,b", [(1, 256), (2, 16), (3, 8), (4, 4), (2, 5)])
@pytest.mark.parametrize("eb", [1e-3, 0.5, 30.0])
def test_select_tags_bit_for_bit(nd, b, eb):
    x = _blocks(nd, b, 3 * nd, nonfinite=True)
    x[3] = 0.0  # all four costs tie: the zero tag wins
    x[4] = 7.0 * eb * 2  # a constant block on the grid
    qfull, (d1r, d2r, qrr, cqr, predr, badr), (d1, d2, qr, cq, pred, bad) = _contest_inputs(x, eb, b)
    for a, r in ((d1, d1r), (d2, d2r), (qr, qrr), (pred, predr)):
        _same_bits(a.numpy(), r)
    tags_ref = r_bw._select_tags(qfull, d1r, d2r, qrr, cqr, badr)
    tags = t_bw._select_tags(torch.from_numpy(qfull), d1, d2, qr, cq, bad)
    assert tags.dtype == torch.uint8
    np.testing.assert_array_equal(tags.numpy(), tags_ref)
    assert tags_ref[3] == t_bw.TAG_ZERO


def test_select_tags_keeps_the_lowest_tag_on_ties():
    """Equal costs everywhere (all codes zero) keep tag 0, as np.argmin
    does; equal Lorenzo costs keep Lorenzo-1 over Lorenzo-2; a bad fit never
    wins regression."""
    z = torch.zeros((5, 4, 4), dtype=torch.float64)
    cq = [torch.zeros(5, dtype=torch.int64) for _ in range(3)]
    no = torch.zeros(5, dtype=torch.bool)
    assert t_bw._select_tags(z, z, z, z, cq, no).tolist() == [0] * 5
    one = torch.ones((5, 4, 4), dtype=torch.float64)
    assert t_bw._select_tags(one, z, z, one, cq, no).tolist() == [1] * 5
    assert t_bw._select_tags(one, one, one, z, cq, torch.ones(5, dtype=torch.bool)).tolist() == [0] * 5
    assert t_bw._select_tags(z[:0], z[:0], z[:0], z[:0], [c[:0] for c in cq], no[:0]).numel() == 0


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1001])
def test_pack_and_unpack_tags(n):
    tags = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    buf = t_bw._pack_tags(tags)
    assert buf == r_bw._pack_tags(tags) and len(buf) == (n + 3) // 4
    np.testing.assert_array_equal(t_bw._unpack_tags(buf, n), r_bw._unpack_tags(buf, n))
    np.testing.assert_array_equal(t_bw._unpack_tags(buf, n), tags)


@pytest.mark.parametrize("name", ["1d", "2d", "3d", "4d", "0d", "empty", "nan", "zeros", "mixed", "f64", "big"])
@pytest.mark.parametrize("eb", [1e-3, 0.25])
@pytest.mark.parametrize("block_side", [None, 5])
def test_estimate_error_equals_reference(name, eb, block_side):
    x = np.asarray(FIELDS[name])
    rconf, tconf = _confs("abs", eb)
    want = r_bw.sz3_hybrid(block_side=block_side).estimate_error(x, eb, rconf)
    got = t_bw.sz3_hybrid(block_side=block_side, device=CPU).estimate_error(x, eb, tconf)
    assert isinstance(got, float) and got == want
    if x.size:  # a tensor sample scores as its array does
        assert t_bw.sz3_hybrid(block_side=block_side, device=CPU).estimate_error(torch.from_numpy(np.array(x)), eb, tconf) == want


def test_block_side_for():
    for nd in range(6):
        for override in (None, 0, 1, 5):
            assert t_bw.block_side_for(nd, override) == r_bw.block_side_for(nd, override)
    assert t_bw.BLOCK_SIDES == r_bw.BLOCK_SIDES and t_bw.DEFAULT_SIDE == r_bw.DEFAULT_SIDE
    assert t_bw.TAG_NAMES == r_bw.TAG_NAMES


# ---------------------------------------------------------------------------
# same input, same bytes; containers both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,eb", MODES, ids=[m for m, _ in MODES])
@pytest.mark.parametrize("name", list(FIELDS))
def test_sz3_hybrid_same_bytes_and_cross_decode(name, mode, eb):
    x = FIELDS[name]
    rconf, tconf = _confs(mode, eb)
    ref = rc.sz3_hybrid().compress(x, rconf, with_stats=True)
    got = tc.sz3_hybrid(device=CPU).compress(x, tconf, with_stats=True)
    assert got.blob == ref.blob
    assert got.meta == ref.meta
    np.testing.assert_array_equal(got.codes, ref.codes)
    assert got.codes.dtype == ref.codes.dtype
    mine = tc.decompress(ref.blob, device=CPU).numpy()
    _same_bits(mine, rc.decompress(got.blob))
    assert mine.shape == np.shape(x)


@pytest.mark.parametrize("mode,eb", MODES, ids=[m for m, _ in MODES])
@pytest.mark.parametrize("name", ["1d", "2d", "3d", "4d", "nan", "mixed"])
def test_sz3_hybrid_block_side_5(name, mode, eb):
    x = FIELDS[name]
    rconf, tconf = _confs(mode, eb)
    ref = rc.sz3_hybrid(block_side=5).compress(x, rconf)
    got = tc.sz3_hybrid(block_side=5, device=CPU).compress(x, tconf)
    assert got.blob == ref.blob
    _same_bits(tc.decompress(got.blob, device=CPU).numpy(), rc.decompress(ref.blob))


@pytest.mark.parametrize("name", ["2d", "3d", "nan", "mixed"])
@pytest.mark.parametrize("eb", [1e-4, 1e-2])
def test_sz3_hybrid_keeps_its_bound(name, eb):
    x = np.asarray(FIELDS[name], np.float64)
    _, tconf = _confs("abs", eb)
    out = tc.decompress(tc.sz3_hybrid(device=CPU).compress(FIELDS[name], tconf).blob, device=CPU).numpy()
    fin = np.isfinite(x)
    assert np.abs(out[fin] - x[fin]).max() <= eb
    _same_bits(out[~fin].astype(np.float64), x[~fin])


def test_every_tag_wins_on_the_mixed_fixture():
    _, tconf = _confs("abs", 1e-3)
    res = tc.sz3_hybrid(device=CPU).compress(FIELDS["mixed"], tconf, with_stats=True)
    assert all(res.meta["counts"]) and set(res.meta["tag_shares"]) == set(t_bw.TAG_NAMES)


@pytest.mark.parametrize("name", ["v5_hybrid_const_rel", "v5_hybrid_mixed_abs"])
def test_v5_conformance_blobs_decode(name):
    blob = (DATA / f"{name}.sz3").read_bytes()
    got = tc.decompress(blob, device=CPU).numpy()
    _same_bits(got, rc.decompress(blob))
    _same_bits(got, np.load(DATA / f"{name}.npy"))


def test_v5_fault_fixtures_behave_as_pinned():
    man = json.loads((FAULTS / "manifest.json").read_text())["v5_hybrid"]
    assert man["generation"] == "v5" and "damaged_chunks" not in man
    want = np.load(FAULTS / "v5_hybrid.npy")
    pristine = (FAULTS / "v5_hybrid.sz3").read_bytes()
    _same_bits(tc.decompress(pristine, verify="strict", device=CPU).numpy(), want)
    corrupt = (FAULTS / "v5_hybrid_corrupt.sz3").read_bytes()
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


def test_mutation_grid_contract_through_the_port():
    """Every grid mutation of a v5 port blob decodes to the pristine bits or
    raises a ValueError subclass; strict catches most."""
    _, tconf = _confs("abs", 1e-3)
    blob = tc.sz3_hybrid(device=CPU).compress(FIELDS["mixed"], tconf).blob
    pristine = tc.decompress(blob, device=CPU).numpy()
    n = strict_errors = 0
    for _name, mut in faults.mutation_grid(blob, seed=11):
        n += 1
        for verify in ("strict", "salvage", "off"):
            try:
                got = tc.decompress(mut, verify=verify, device=CPU)
            except ValueError:
                strict_errors += verify == "strict"
                continue
            if verify == "salvage":
                assert isinstance(got[1], tc.SalvageReport)
            elif verify == "strict":
                _same_bits(got.numpy(), pristine)
    assert n >= 15 and strict_errors >= n // 2


def _repack(header, body):
    """A trailer-less container around ``header`` and ``body``."""
    from repro_torch.core import _msgpack

    h = _msgpack.packb(header)
    return b"SZ3J" + np.asarray([len(h), len(body)], np.int64).tobytes() + h + body


@pytest.mark.parametrize("field,value", [
    ("bs", 0), ("bs", 1 << 13), ("nb", 10**9), ("n_reg", 10**6), ("padded_shape", [48, 47]),
    ("work_shape", [64, 65]), ("n_codes", 10**9), ("nb", 15),
])
def test_hostile_hybrid_meta_raises_container_error(field, value):
    """A header whose block geometry or counts disagree raises a typed
    error before any allocation it would size."""
    from repro_torch.core import integrity

    _, tconf = _confs("abs", 1e-3)
    with integrity.trailers_disabled():
        blob = tc.sz3_hybrid(device=CPU).compress(FIELDS["mixed"], tconf).blob
    header, body_off = tc.parse_header(blob)
    body = blob[body_off:]
    if field == "n_codes":
        header["n_codes"] = value
    else:
        header["hyb_meta"] = dict(header["hyb_meta"], **{field: value})
    with pytest.raises(tc.ContainerError):
        tc.decompress(_repack(header, body), device=CPU)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this test runs the hybrid's contest on a card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,eb", [("abs", 1e-3), ("rel", 1e-4), ("pw_rel", 1e-3)], ids=["abs", "rel", "pw_rel"])
@pytest.mark.parametrize("name", ["1d", "2d", "3d", "4d", "0d", "empty", "nan", "zeros", "mixed", "f64", "big"])
def test_cuda_blob_equals_the_plain_route(cuda_device, name, mode, eb):
    """The contest on the card writes the CPU's bytes, and the card decodes
    them to the CPU decode's bits."""
    x = FIELDS[name]
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode(mode), eb=eb)
    card = tc.sz3_hybrid(device=cuda_device).compress(x, conf, with_stats=True)
    plain = tc.sz3_hybrid(device=CPU).compress(x, conf, with_stats=True)
    assert card.blob == plain.blob and card.meta == plain.meta
    _same_bits(tc.decompress(card.blob, device=cuda_device).cpu().numpy(), tc.decompress(card.blob, device=CPU).numpy())
