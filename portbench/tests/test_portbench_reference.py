"""The plain reference on tiny inputs: the container reader against the
port's writer, the bound derived again, and the judge's three numbers."""
import math
import zlib

import pytest
import torch

from portbench.reference import container, sz3_bound


def _field(n=4096, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (100 + torch.cumsum(torch.randn(n, generator=g), 0)).to(torch.float32)


def _mix(eb, mode="rel", pipeline="sz3_lorenzo"):
    """A traffic mix as the judge gets it."""
    return {"pipeline": pipeline, "options": {}, "mode": mode, "eb": eb, "fields": 1}


def _blob(x, pipeline="sz3_lorenzo", eb=1e-4):
    import repro_torch.core as core

    res = core.PIPELINES[pipeline](device="cpu").compress(x, core.CompressionConfig(mode=core.ErrorBoundMode.REL, eb=eb))
    return res.blob, res.ratio, core.decompress(res.blob, device="cpu")


@pytest.mark.parametrize("value", [None, True, False, 0, 5, 127, 128, 70000, 2**40, -1, -33, -200, -70000, -(2**40),
                                   1.5, -2.25e300, "", "abc", "x" * 40, "y" * 300, b"", b"\x00" * 300,
                                   [], [1, "a", [2.0]], list(range(20)), {}, {"a": 1, "b": {"c": [1, 2]}},
                                   {str(i): i for i in range(20)}])
def test_msgpack_reader_reads_what_the_port_writes(value):
    from repro_torch.core import _msgpack

    assert container.unpackb(_msgpack.packb(value)) == value


def test_container_leaves_of_a_v1_and_a_chunked_blob():
    x = _field(1 << 16).reshape(256, 256)
    blob, _, _ = _blob(x, "sz3_lorenzo")
    (leaf,) = container.leaves(blob)
    assert leaf["header"]["shape"] == [256, 256] and leaf["n0"] == 256
    blob, _, _ = _blob(x, "sz3_auto")
    top, _ = container.parse(blob)
    parts = container.leaves(blob)
    assert top["kind"] == "chunked" and sum(p["n0"] for p in parts) == 256


def test_truncated_or_foreign_bytes_do_not_parse():
    blob, _, _ = _blob(_field())
    for bad in (blob[:10], b"XXXX" + blob[4:], blob[:30]):
        with pytest.raises(container.FormatError):
            container.leaves(bad)


def test_abs_bound_is_the_programs():
    x = _field()
    blob, _, _ = _blob(x)
    header, _ = container.parse(blob)
    assert header["abs_eb"] == sz3_bound.abs_bound(x, "rel", 1e-4)
    assert sz3_bound.abs_bound(x, "abs", 0.5) == 0.5
    assert sz3_bound.abs_bound(torch.full((10,), 3.0), "rel", 1e-4) > 0
    y = x.clone()
    y[3] = float("nan")
    assert math.isfinite(sz3_bound.abs_bound(y, "rel", 1e-4))


@pytest.mark.parametrize("pipeline", ["sz3_lorenzo", "sz3_auto", "sz3_fast"])
def test_a_sound_round_trip_passes(pipeline):
    x = _field(1 << 15).reshape(128, 256)
    blob, ratio, out = _blob(x, pipeline)
    v = sz3_bound.judge_field(x, out, blob, ratio, _mix(1e-4, pipeline=pipeline))
    assert v.err_over_bound <= 1.0 and v.abs_eb_gap == 0.0 and v.blob_faults == []


def test_the_judge_catches_each_kind_of_fault():
    x = _field()
    blob, ratio, out = _blob(x)
    abs_eb = sz3_bound.abs_bound(x, "rel", 1e-4)
    moved = out.clone()
    moved[17] += 3 * abs_eb
    assert sz3_bound.judge_field(x, moved, blob, ratio, _mix(1e-4)).err_over_bound > 2.9
    nan = out.clone()
    nan[0] = float("nan")
    assert sz3_bound.judge_field(x, nan, blob, ratio, _mix(1e-4)).err_over_bound == math.inf
    assert sz3_bound.judge_field(x, out, blob, ratio * 1.01, _mix(1e-4)).blob_faults
    assert sz3_bound.judge_field(x, out[:-1], blob, ratio, _mix(1e-4)).blob_faults
    assert sz3_bound.judge_field(x, None, blob, ratio, _mix(1e-4)).blob_faults
    assert sz3_bound.judge_field(x, out, blob, ratio, _mix(2e-4)).abs_eb_gap == pytest.approx(0.5)
    assert sz3_bound.judge_field(x, out, blob[:40], 4 * x.numel() / 40, _mix(1e-4)).blob_faults
    other = _blob(_field(seed=1))[0]
    assert sz3_bound.judge_field(x, out, other, 4 * x.numel() / len(other), _mix(1e-4)).abs_eb_gap > 0


def test_a_v1_body_must_inflate_to_its_declared_length():
    x = _field()
    blob, _, out = _blob(x)
    header, body = container.parse(blob)
    hlen = int.from_bytes(blob[4:12], "little")
    if header["spec"]["lossless"] == "zstd":
        zstandard = pytest.importorskip("zstandard")
        plain = zstandard.ZstdDecompressor().decompress(body)
        new_body = zstandard.ZstdCompressor().compress(plain + b"\x00")
    else:
        new_body = zlib.compress(zlib.decompress(body) + b"\x00")
    tampered = blob[:4] + hlen.to_bytes(8, "little") + len(new_body).to_bytes(8, "little") + blob[20 : 20 + hlen] + new_body
    v = sz3_bound.judge_field(x, out, tampered, 4 * x.numel() / len(tampered), _mix(1e-4))
    assert any("inflates to" in f for f in v.blob_faults)


def test_plain_codec_keeps_the_bound_in_float32_and_breaks_it_in_bfloat16():
    x = _field(1 << 16)
    abs_eb = sz3_bound.abs_bound(x, "rel", 1e-4)
    for dtype in (torch.float64, torch.float32):
        assert sz3_bound.max_error(x, sz3_bound.plain_codec(x, abs_eb, dtype)) <= abs_eb
    assert sz3_bound.max_error(x, sz3_bound.plain_codec(x, abs_eb, torch.bfloat16)) > 3 * abs_eb


def test_summary_takes_the_worst_field():
    v = [sz3_bound.FieldVerdict(0.5, 0.0, []), sz3_bound.FieldVerdict(0.9, 0.0, ["x"], True)]
    assert sz3_bound.summarize(v) == {"err_over_bound": 0.9, "abs_eb_gap": 0.0, "inputs_changed": 1, "blob_faults": 1}
    assert sz3_bound.summarize([])["err_over_bound"] == math.inf


def test_a_sealed_input_written_in_the_window_is_caught():
    """The judge holds a field to the bound and digest taken before the
    program saw it: a program that overwrote its input with its own
    reconstruction would otherwise read an error of 0."""
    x = _field()
    sealed = sz3_bound.seal(x, "rel", 1e-4)
    blob, ratio, out = _blob(x)
    assert not sz3_bound.judge_field(x, out, blob, ratio, _mix(1e-4), sealed).input_changed
    x.copy_(out)
    v = sz3_bound.judge_field(x, out, blob, ratio, _mix(1e-4), sealed)
    assert v.input_changed and v.err_over_bound == 0.0
    assert sz3_bound.summarize([v])["inputs_changed"] == 1


def test_the_digest_sees_one_bit_and_a_swap():
    x = _field(1 << 12)
    d = sz3_bound.digest(x)
    assert sz3_bound.digest(x.clone()) == d
    flipped = x.clone()
    flipped.view(torch.int32)[100] ^= 1
    assert sz3_bound.digest(flipped) != d
    swapped = x.clone()
    swapped[[5, 9]] = x[[9, 5]]
    assert sz3_bound.digest(swapped) != d
    assert sz3_bound.digest(x.double()) != d
