"""The port's fault generator (``repro_torch.core.faults``), ``verify_blob``
and checkpoint salvage held to the contracts of ``tests/test_faults.py``, on
the CPU.

* ``mutation_grid``, ``corrupt_chunk`` and the primitive mutations yield the
  JAX package's bytes for the same blob and seed;
* the decode contract through the port, on port blobs of every generation
  (v1, the truncation coder's v1, v2, v3, v4, v5, v6): every grid mutation
  decodes to the pristine bits, raises a ``ValueError`` subclass, or
  salvages with a report — and strict verification catches most of them;
  the hypothesis lane explores past the grid;
* ``verify_blob`` gives the reference's verdict on the fault fixtures under
  ``tests/data/faults/`` and on their grid mutations;
* the pinned fixtures (strict error, exact salvage sets), the malformed-input
  error contract of every entry point, trailer semantics, stream verify,
  worker-timeout degradation, and the checkpoint manager's per-leaf
  checksums, salvage refill and I/O retry.
"""
import io
import json
import pathlib
import threading
import time
import types
import zlib

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import faults, integrity
from repro_torch.core.chunking import (
    ChunkedCompressor,
    _parallel_map_ordered,
    compress_stream,
    decompress_stream,
)

try:  # the differential tests need the JAX package
    import repro.core as rc
    from repro.core import faults as r_faults
    from repro.core import integrity as r_int
except ImportError:  # pragma: no cover - a machine without JAX
    rc = None

CPU = "cpu"
DATA = pathlib.Path(__file__).parent / "data" / "faults"
needs_reference = pytest.mark.skipif(rc is None, reason="the JAX package is not importable")

ABS = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=1e-3)
REL = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-3)
PWR = tc.CompressionConfig(mode=tc.ErrorBoundMode.PW_REL, eb=1e-3)

# decode of a few-KB blob must never take longer than this, mutated or not
TIME_BUDGET_S = 10.0


@pytest.fixture(autouse=True)
def reference_verifies_crc32c(monkeypatch):
    """Where ``google_crc32c`` is missing, the JAX package cannot verify
    CRC32C trailers; lend it the port's numpy CRC32C."""
    if rc is not None and r_int._crc32c_mod is None:
        monkeypatch.setattr(r_int, "_crc32c_mod", types.SimpleNamespace(
            extend=lambda value, data: integrity.crc32c_numpy(data, value)))


def _smooth(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    for ax in range(len(shape)):
        x = np.cumsum(x, axis=ax) / np.sqrt(shape[ax])
    return x.astype(dtype)


def _pwr_field(seed):
    w = np.exp(_smooth((48, 16), seed, np.float64))
    w[3, 3] = 0.0
    w[::7, 2] *= -1
    return w


def _decode(blob, verify="strict"):
    return tc.decompress(blob, verify=verify, device=CPU)


@pytest.fixture(scope="module")
def containers():
    """One port container per generation (trailers on)."""
    osc = (np.sin(0.9 * np.pi * np.arange(1200)) + 0.05 * _smooth((1200,), 31)).astype(np.float32)
    return {
        "v1": tc.sz3_lorenzo(device=CPU).compress(_smooth((32, 20), 32), ABS).blob,
        "v1t": tc.sz3_truncation(2, device=CPU).compress(_smooth((30, 16), 33), REL).blob,
        "v2": tc.sz3_chunked(chunk_bytes=2048, device=CPU).compress(_smooth((40, 28), 34), REL).blob,
        "v3": tc.sz3_transform(device=CPU).compress(osc, ABS).blob,
        "v4": tc.sz3_pwr(eb=1e-3, chunk_bytes=4096, device=CPU).compress(_pwr_field(35), PWR).blob,
        "v5": tc.sz3_hybrid(device=CPU).compress(_smooth((48, 48), 36), ABS).blob,
        "v6": tc.sz3_fast(device=CPU).compress(np.cumsum(_smooth((1100,), 37)).astype(np.float32), ABS).blob,
    }


def _contract(pristine_out, mutated, verify):
    """Assert the decode contract on one mutated blob; returns a tag."""
    t0 = time.perf_counter()
    try:
        got = _decode(mutated, verify)
    except ValueError:
        tag = "typed-error"
    except MemoryError:
        pytest.fail(f"unbounded allocation attempted (verify={verify})")
    else:
        if verify == "salvage":
            data, report = got
            assert isinstance(report, tc.SalvageReport)
            tag = "salvage-report" if not report.ok else "decode"
            got = data
        else:
            tag = "decode"
        if verify == "strict" and tag == "decode":
            # strict success while checksums are on => bytes must be right
            assert got.dtype == pristine_out.dtype and got.shape == pristine_out.shape
            assert torch.equal(got, pristine_out), "strict decode of a corrupt blob returned WRONG bytes"
    assert time.perf_counter() - t0 < TIME_BUDGET_S, "decode contract: too slow"
    return tag


GENS = ["v1", "v1t", "v2", "v3", "v4", "v5", "v6"]


@pytest.mark.parametrize("gen", GENS)
def test_mutation_grid_contract(containers, gen):
    blob = containers[gen]
    pristine = _decode(blob)
    n = strict_errors = 0
    for name, mut in faults.mutation_grid(blob, seed=7):
        assert mut != blob, f"grid yielded identity mutation {name}"
        n += 1
        for verify in ("strict", "salvage", "off"):
            tag = _contract(pristine, mut, verify)
            if verify == "strict" and tag == "typed-error":
                strict_errors += 1
    assert n >= 15, "mutation grid unexpectedly small"
    assert strict_errors >= n // 2


@needs_reference
@pytest.mark.parametrize("gen", GENS)
def test_mutation_grid_yields_the_references_bytes(containers, gen):
    blob = containers[gen]
    for seed in (0, 7):
        assert list(faults.mutation_grid(blob, seed=seed)) == list(r_faults.mutation_grid(blob, seed=seed))
    assert list(faults.mutation_grid(blob[:25], seed=1)) == list(r_faults.mutation_grid(blob[:25], seed=1))
    for args in ((5, 3), (len(blob) + 9, 7)):
        assert faults.bit_flip(blob, *args) == r_faults.bit_flip(blob, *args)
    assert faults.zero_range(blob, 30, 11) == r_faults.zero_range(blob, 30, 11)
    assert faults.splice(blob, 40, 3, 17) == r_faults.splice(blob, 40, 3, 17)
    assert faults.truncate(blob, 33) == r_faults.truncate(blob, 33)
    for which in ("header", "body"):
        assert faults.inflate_length(blob, which, 1 << 9) == r_faults.inflate_length(blob, which, 1 << 9)
    if gen in ("v2", "v4"):
        n = len(tc.parse_header(blob)[0]["chunks"])
        for i in range(n):
            assert faults.corrupt_chunk(blob, i) == r_faults.corrupt_chunk(blob, i)


@pytest.mark.parametrize("gen", ["v1", "v2", "v3", "v4", "v5", "v6"])
def test_strict_names_the_damage(containers, gen):
    """A body bit-flip under strict decode raises IntegrityError: the
    checksum layer, not a downstream parse accident, reports it."""
    blob = containers[gen]
    _, body_off = tc.parse_header(blob)
    body_len = integrity._declared_body_len(blob)
    mut = faults.bit_flip(blob, body_off + body_len // 2, 4)
    with pytest.raises(tc.IntegrityError):
        _decode(mut)


def test_trailer_roundtrip_and_strip_detection(containers):
    blob = containers["v2"]
    assert tc.verify_blob(blob) is True  # trailer present, every checksum good
    header, body_off = tc.parse_header(blob)
    res = integrity.inspect(blob, header, body_off)
    assert res.has_trailer and res.ok and res.bad_chunks in (None, [])
    tr = integrity.read_trailer(blob)
    stripped = blob[: tr.start]
    with pytest.raises(tc.IntegrityError, match="trailer"):
        _decode(stripped)
    assert torch.equal(_decode(stripped, "off"), _decode(blob))


def test_legacy_blobs_decode_unverified():
    x = _smooth((24, 12), 40)
    with integrity.trailers_disabled():
        blob = tc.sz3_lorenzo(device=CPU).compress(x, ABS).blob
    assert integrity.read_trailer(blob) is None
    assert tc.verify_blob(blob) is False
    strict = _decode(blob)
    off = _decode(blob, "off")
    data, report = _decode(blob, "salvage")
    assert torch.equal(strict, off) and torch.equal(strict, data)
    assert report.ok and not report.checksummed


def test_trailer_is_byte_deterministic():
    x = _smooth((20, 20), 41)
    b1 = tc.sz3_chunked(chunk_bytes=1024, device=CPU).compress(x, REL).blob
    b2 = tc.sz3_chunked(chunk_bytes=1024, device=CPU).compress(x, REL).blob
    assert b1 == b2


# ---------------------------------------------------------------------------
# committed corrupted-blob fixtures: strict error + salvage sets, pinned
# ---------------------------------------------------------------------------

FIXTURES = sorted(p.stem[: -len("_corrupt")] for p in DATA.glob("*_corrupt.sz3"))


def _manifest():
    return json.loads((DATA / "manifest.json").read_text())


def test_fixture_corpus_complete():
    gens = {_manifest()[n]["generation"] for n in FIXTURES}
    assert gens == {"v1", "v2", "v3", "v4", "v5", "v6"}


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_pristine_decodes_strict(name):
    got = _decode((DATA / f"{name}.sz3").read_bytes()).numpy()
    want = np.load(DATA / f"{name}.npy")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_corrupt_strict_raises(name):
    with pytest.raises(tc.IntegrityError):
        _decode((DATA / f"{name}_corrupt.sz3").read_bytes())


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_corrupt_salvage_sets(name):
    man = _manifest()[name]
    pristine = np.load(DATA / f"{name}.npy")
    data, report = _decode((DATA / f"{name}_corrupt.sz3").read_bytes(), "salvage")
    assert isinstance(report, tc.SalvageReport)
    assert not report.ok and report.checksummed
    damaged = sorted(d.index for d in report.damage)
    if "damaged_chunks" in man:  # v2/v4 multi-chunk: exact set pinned
        assert damaged == man["damaged_chunks"]
        assert sorted(report.recovered) == sorted(set(range(man["n_chunks"])) - set(man["damaged_chunks"]))
    else:  # single-body generations: all-or-nothing
        assert damaged == [0] and report.recovered == []
    lost = np.zeros(pristine.size, dtype=bool)
    for a, b in report.lost_ranges():
        lost[a:b] = True
    flat_got, flat_want = data.numpy().ravel(), pristine.ravel()
    np.testing.assert_array_equal(flat_got[~lost], flat_want[~lost])
    assert not flat_got[lost].any()


def _verdict(fn, blob):
    try:
        return fn(blob)
    except ValueError as e:
        return type(e).__name__


@needs_reference
@pytest.mark.parametrize("name", FIXTURES)
def test_verify_blob_gives_the_references_verdict(name):
    """Pristine fixtures verify (True), corrupt ones raise the same error
    class in both packages; so do their grid mutations."""
    pristine = (DATA / f"{name}.sz3").read_bytes()
    corrupt = (DATA / f"{name}_corrupt.sz3").read_bytes()
    assert tc.verify_blob(pristine) is True is rc.verify_blob(pristine)
    assert _verdict(tc.verify_blob, corrupt) == _verdict(rc.verify_blob, corrupt) == "IntegrityError"
    for _, mut in faults.mutation_grid(pristine, seed=3):
        assert _verdict(tc.verify_blob, mut) == _verdict(rc.verify_blob, mut)


# ---------------------------------------------------------------------------
# error contract — malformed input raises ValueError subclasses
# ---------------------------------------------------------------------------

MALFORMED = {
    "empty": b"",
    "short": b"SZ3",
    "bad-magic": b"XXXX" + b"\x00" * 40,
    "garbage": bytes(range(256)) * 2,
    "magic-only": b"SZ3J",
    "negative-lengths": b"SZ3J" + (-5).to_bytes(8, "little", signed=True) * 2,
    "huge-lengths": b"SZ3J" + (1 << 60).to_bytes(8, "little") * 2,
    "truncated-header": b"SZ3J" + (100).to_bytes(8, "little") + (0).to_bytes(8, "little") + b"\x81",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
@pytest.mark.parametrize(
    "entry",
    [
        lambda b: _decode(b),
        lambda b: _decode(b, "off"),
        lambda b: _decode(b, "salvage"),
        lambda b: tc.parse_header(b),
        lambda b: tc.decompress_chunk(b, 0, device=CPU),
        lambda b: tc.verify_blob(b),
    ],
    ids=["decompress", "off", "salvage", "parse_header", "chunk", "verify"],
)
def test_malformed_error_contract(case, entry):
    with pytest.raises(ValueError):
        entry(MALFORMED[case])


@pytest.mark.parametrize("gen", ["v1", "v2", "v3", "v4", "v5", "v6"])
def test_truncation_ladder_error_contract(containers, gen):
    """Every truncation point of a real blob raises a typed error (or, for
    cuts beyond the checksummed core, may still decode)."""
    blob = containers[gen]
    for keep in (0, 3, 4, 12, 19, 20, 21, len(blob) // 2, len(blob) - 1):
        try:
            _decode(blob[:keep])
        except ValueError:
            pass


def test_inflated_lengths_do_not_allocate(containers):
    for blob in containers.values():
        for which in ("header", "body"):
            mut = faults.inflate_length(blob, which, factor=1 << 30)
            with pytest.raises(ValueError):
                _decode(mut, "off")


def test_corrupt_frame_stream_rejected():
    neg = (-1).to_bytes(8, "little", signed=True)
    with pytest.raises(tc.ContainerError):
        list(tc.read_frames(io.BytesIO(neg)))
    huge = (1 << 60).to_bytes(8, "little")
    with pytest.raises(tc.ContainerError):
        list(tc.read_frames(io.BytesIO(huge)))
    with pytest.raises(tc.ContainerError):
        list(tc.read_frames(io.BytesIO((100).to_bytes(8, "little") + b"xy")))


# ---------------------------------------------------------------------------
# streaming verify
# ---------------------------------------------------------------------------

def test_stream_verify_strict_and_salvage():
    x = _smooth((64, 16), 50)
    frames = list(compress_stream(x, REL, chunk_bytes=1024, device=CPU))
    payload = [i for i, f in enumerate(frames) if f[:4] == b"SZ3J"]
    k = payload[len(payload) // 2]
    bad = list(frames)
    _, body_off = tc.parse_header(frames[k])
    bad[k] = faults.bit_flip(frames[k], body_off + 4, 2)
    with pytest.raises(tc.IntegrityError):
        list(decompress_stream(bad, device=CPU))
    out = list(decompress_stream(bad, verify="salvage", device=CPU))
    reports = [r for _, r in out]
    assert sum(not r.ok for r in reports) == 1
    good = list(decompress_stream(frames, device=CPU))
    for (arr, rep), want in zip(out, good):
        if rep.ok:
            assert torch.equal(arr, want)
        else:
            assert not bool(arr.any())


# ---------------------------------------------------------------------------
# worker timeout -> degrade-to-serial
# ---------------------------------------------------------------------------

def test_parallel_map_timeout_degrades_to_serial():
    calls = []
    lock = threading.Lock()

    def fn(x):
        with lock:
            first = not calls
            calls.append(x)
        if first:
            time.sleep(0.5)  # only the first (pool) execution stalls
        return x * 2

    out = list(_parallel_map_ordered(fn, range(8), workers=2, timeout=0.05))
    assert out == [x * 2 for x in range(8)]


def test_chunk_timeout_roundtrip():
    x = _smooth((48, 24), 51)
    eng = ChunkedCompressor(chunk_bytes=2048, workers=2, chunk_timeout=60.0, device=CPU)
    res = eng.compress(x, REL)
    assert torch.equal(
        _decode(res.blob), _decode(tc.sz3_chunked(chunk_bytes=2048, device=CPU).compress(x, REL).blob)
    )


# ---------------------------------------------------------------------------
# checkpoint: per-leaf checksums, partial restore, bounded I/O retry
# ---------------------------------------------------------------------------

def _ckpt_roundtrip(tmp_path):
    from repro_torch.ft.checkpoint import CheckpointManager

    state = {
        "w": torch.from_numpy(_smooth((16, 16), 60)),
        "b": torch.ones(16),
        "m": torch.from_numpy(_smooth((128,), 61)),
    }
    mgr = CheckpointManager(tmp_path, use_async=False, device=CPU)
    mgr.save(1, state)
    return mgr, state


def _leaf_file(tmp_path, key_fragment):
    d = tmp_path / "step_1"
    man = json.loads((d / "manifest.json").read_text())
    key = next(k for k in man["leaves"] if key_fragment in k)
    return d / man["leaves"][key]["file"]


def _flip_middle(f):
    blob = bytearray(f.read_bytes())
    blob[len(blob) // 2] ^= 0x40
    f.write_bytes(bytes(blob))


def test_checkpoint_leaf_checksum_strict(tmp_path):
    mgr, state = _ckpt_roundtrip(tmp_path)
    _flip_middle(_leaf_file(tmp_path, "w"))
    with pytest.raises(tc.IntegrityError, match="checksum"):
        mgr.restore(state)


def test_checkpoint_partial_restore_refills(tmp_path):
    mgr, state = _ckpt_roundtrip(tmp_path)
    _flip_middle(_leaf_file(tmp_path, "w"))
    got, extra, report = mgr.restore(state, salvage=True)
    assert not report.ok
    assert [r for _, r in report.refilled] == ["checksum"]
    # damaged leaf refilled from the template's own value
    assert torch.equal(got["w"], state["w"]) and torch.equal(got["b"], state["b"])
    # shape-only template (meta tensors) -> zeros on the manager's device
    tmpl = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in state.items()}
    got, extra, report = mgr.restore(tmpl, salvage=True)
    assert [p for p, _ in report.refilled] and not report.ok
    assert got["w"].device.type == "cpu" and torch.equal(got["w"], torch.zeros_like(state["w"]))
    assert torch.equal(got["b"], state["b"])


def test_checkpoint_missing_leaf_salvage(tmp_path):
    mgr, state = _ckpt_roundtrip(tmp_path)
    _leaf_file(tmp_path, "m").unlink()
    with pytest.raises((KeyError, FileNotFoundError)):
        mgr.restore(state)
    got, extra, report = mgr.restore(state, salvage=True)
    assert [r for _, r in report.refilled] == ["missing"]
    assert torch.equal(got["m"], state["m"])


def test_checkpoint_io_retry(tmp_path, monkeypatch):
    mgr, state = _ckpt_roundtrip(tmp_path)
    real = pathlib.Path.read_bytes
    fails = {"n": 0}

    def flaky(self):
        if self.suffix == ".bin" and fails["n"] < 2:
            fails["n"] += 1
            raise OSError("transient I/O blip")
        return real(self)

    monkeypatch.setattr(pathlib.Path, "read_bytes", flaky)
    got, _ = mgr.restore(state, io_backoff=0.001)
    assert fails["n"] == 2
    assert torch.equal(got["w"], state["w"])


def test_checkpoint_legacy_crc_manifest(tmp_path):
    """Manifests without per-leaf csum entries still verify (zlib crc path)
    and still fail loudly when the blob is damaged."""
    mgr, state = _ckpt_roundtrip(tmp_path)
    d = tmp_path / "step_1"
    man = json.loads((d / "manifest.json").read_text())
    for meta in man["leaves"].values():
        meta.pop("csum", None)
    (d / "manifest.json").write_text(json.dumps(man))
    got, _ = mgr.restore(state)
    assert torch.equal(got["w"], state["w"])
    f = _leaf_file(tmp_path, "b")
    blob = bytearray(f.read_bytes())
    blob[5] ^= 0xFF
    f.write_bytes(bytes(blob))
    assert zlib.crc32(bytes(blob)) != man["leaves"]["b"]["crc"]
    with pytest.raises(IOError):
        mgr.restore(state)


# ---------------------------------------------------------------------------
# hypothesis fuzz lane (additive: runs wherever hypothesis is installed)
# ---------------------------------------------------------------------------

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - the deterministic grid still runs
    HAVE_HYPOTHESIS = False

_FUZZ_BLOB = {}


def _fuzz_blob():
    if "b" not in _FUZZ_BLOB:
        _FUZZ_BLOB["b"] = tc.sz3_chunked(chunk_bytes=1024, device=CPU).compress(_smooth((24, 16), 70), REL).blob
        _FUZZ_BLOB["out"] = _decode(_FUZZ_BLOB["b"])
    return _FUZZ_BLOB["b"], _FUZZ_BLOB["out"]


if HAVE_HYPOTHESIS:

    @settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(st.data())
    def test_fuzz_random_mutations(data):
        blob, pristine = _fuzz_blob()
        mut = blob
        for _ in range(data.draw(st.integers(1, 4))):
            op = data.draw(st.sampled_from(["flip", "zero", "trunc", "splice"]))
            if op == "flip":
                mut = faults.bit_flip(
                    mut, data.draw(st.integers(0, max(0, len(mut) - 1))), data.draw(st.integers(0, 7))
                )
            elif op == "zero":
                mut = faults.zero_range(
                    mut, data.draw(st.integers(0, max(0, len(mut) - 1))), data.draw(st.integers(1, 64))
                )
            elif op == "trunc":
                mut = faults.truncate(mut, data.draw(st.integers(0, len(mut))))
            else:
                mut = faults.splice(
                    mut,
                    data.draw(st.integers(0, max(0, len(mut) - 1))),
                    data.draw(st.integers(0, max(0, len(mut) - 1))),
                    data.draw(st.integers(1, 64)),
                )
        for verify in ("strict", "salvage", "off"):
            if mut == blob and verify == "strict":
                continue  # identity composition: trivially decodes
            _contract(pristine, mut, verify)

    @settings(max_examples=60, deadline=None)
    @given(raw=st.binary(min_size=0, max_size=200))
    def test_fuzz_arbitrary_bytes(raw):
        for blob in (raw, b"SZ3J" + raw):
            try:
                _decode(blob)
            except ValueError:
                pass
