"""The port's bitplane transpose held against the JAX package, on the CPU.

* the plain ``ops.bitplane_encode`` equals the JAX entry point
  ``repro.kernels.bitplane.bitplane_encode`` (interpret-mode Pallas) bit for
  bit, the whole (32, R) array including its zero padding, and
  ``ref_encode`` equals the JAX oracle's; decode round-trips;
* the plane content equals the host codec's (``quantizers.bitplane_encode``,
  MSB-first planes), as ``tests/test_kernels.py`` pins the two JAX codecs;
* the wrappers refuse what the kernel does not take.

The ``cuda``-marked tests hold the CUDA kernel against its plain version on
ragged R, on R past one pass of its card-sized grid, on views at a storage
offset (its 4-byte value-side path) and on all-ones and one-bit-per-plane
values, and run on a card
(``python -m pytest -q -m cuda tests/test_torch_bitplane.py``).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels import bitplane as rbp
except ImportError:  # a card's machine without JAX runs the cuda-marked tests only
    jnp = None

from repro_torch.core import quantizers as t_quant
from repro_torch.kernels import bitplane as tbp
from repro_torch.kernels.bitplane import kernel as K
from repro_torch.kernels.bitplane import ref as R

NS = [0, 1, 5, 31, 32, 33, 100, 1000, 16384, 16385, 40009]


def _vals(n):
    rng = np.random.default_rng(n)
    return rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


def _pattern(kind, rows):
    """(rows, 32) uint32 values: all bits set, or v[r, k] = 1 << ((k - r) % 32),
    whose plane words w[p, r] = 1 << ((p + r) % 32) hold one bit each."""
    if kind == "all-ones":
        return np.full((rows, 32), 0xFFFFFFFF, np.uint32)
    r, k = np.arange(rows)[:, None], np.arange(32)[None, :]
    return (np.uint32(1) << ((k - r) % 32).astype(np.uint32)).astype(np.uint32)


def _pattern_planes(kind, rows):
    if kind == "all-ones":
        return np.full((32, rows), 0xFFFFFFFF, np.uint32)
    p, r = np.arange(32)[:, None], np.arange(rows)[None, :]
    return (np.uint32(1) << ((p + r) % 32).astype(np.uint32)).astype(np.uint32)


def _need_jax():
    if jnp is None:
        pytest.skip("needs JAX: the test compares with the JAX package")


@pytest.mark.parametrize("n", NS)
def test_plain_encode_equals_jax_entry_point_with_padding(n):
    _need_jax()
    vals = _vals(n)
    want = np.asarray(rbp.bitplane_encode(jnp.asarray(vals)))
    got = tbp.bitplane_encode(torch.from_numpy(vals))
    assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape
    assert want.shape[1] % 512 == 0 and want.shape[1] >= 512
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tbp.bitplane_decode(got, n).numpy(), vals)
    np.testing.assert_array_equal(
        tbp.ref_encode(torch.from_numpy(vals)).numpy(), np.asarray(rbp.ref_encode(vals))
    )
    np.testing.assert_array_equal(
        tbp.ref_decode(got, n).numpy(), np.asarray(rbp.ref_decode(want, n))
    )


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 16384, 40009])
def test_planes_equal_the_host_codec(n):
    """Plane p of the transpose holds ((v >> p) & 1) for every value, which
    is what the host codec stores as its p-th plane from the bottom."""
    vals = _vals(n)
    blob = t_quant.bitplane_encode(vals.astype(np.int64))
    back, used = t_quant.bitplane_decode(blob)
    assert used == len(blob)
    np.testing.assert_array_equal(back, vals.astype(np.int64))
    words = tbp.bitplane_encode(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(tbp.bitplane_decode(torch.from_numpy(words), n).numpy(), vals)
    if n == 0:
        return
    nplanes = int(np.frombuffer(blob, np.int64, count=2)[1])
    assert nplanes == max(1, int(vals.max()).bit_length())
    nbytes_plane = (n + 7) // 8
    pos = 16 + nbytes_plane  # header + sign bitmap (all zero)
    idx = np.arange(n)
    for i, p in enumerate(range(nplanes - 1, -1, -1)):  # the host is MSB-first
        host_bits = np.unpackbits(
            np.frombuffer(blob, np.uint8, count=nbytes_plane, offset=pos + i * nbytes_plane), count=n
        )
        kern_bits = ((words[p][idx // 32] >> (idx % 32).astype(np.uint32)) & 1).astype(np.uint8)
        np.testing.assert_array_equal(kern_bits, host_bits)
    assert not words[nplanes:].any()


@pytest.mark.parametrize("kind", ["all-ones", "one-bit-per-plane"])
def test_plain_version_on_patterns_equals_jax_entry_point(kind):
    _need_jax()
    rows = 1003
    vals = _pattern(kind, rows).reshape(-1)
    want = np.asarray(rbp.bitplane_encode(jnp.asarray(vals)))
    got = tbp.bitplane_encode(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :rows], _pattern_planes(kind, rows))
    assert not got[:, rows:].any()
    np.testing.assert_array_equal(tbp.bitplane_decode(torch.from_numpy(got), vals.size).numpy(), vals)


def test_signed_tail_round_trips_beside_the_host_sign_bitmap():
    vals = np.asarray([5, -1, (1 << 31), -(1 << 20), 0, -7, 123456789, -3, 9, 2, -2], np.int64)
    back, _ = t_quant.bitplane_decode(t_quant.bitplane_encode(vals))
    np.testing.assert_array_equal(back, vals)
    mags = torch.from_numpy(np.abs(vals))
    got = tbp.bitplane_decode(tbp.bitplane_encode(mags), mags.numel())
    np.testing.assert_array_equal(got.numpy(), np.abs(vals).astype(np.uint32))


def test_integer_inputs_wrap_like_astype_uint32():
    v = torch.tensor([-1, 1 << 32, (1 << 32) + 5, 7], dtype=torch.int64)
    want = np.asarray([-1, 1 << 32, (1 << 32) + 5, 7], np.int64).astype(np.uint32)
    np.testing.assert_array_equal(tbp.bitplane_decode(tbp.bitplane_encode(v), 4).numpy(), want)
    with pytest.raises(ValueError, match="integer"):
        tbp.bitplane_encode(torch.zeros(4))


def test_kernel_wrappers_refuse_non_cuda_tensors():
    v = torch.zeros((64, 32), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.encode(v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.decode(v.reshape(32, 64))
    with pytest.raises(ValueError, match=r"\(R, 32\)"):
        R.encode(v.reshape(32, 64)[:, :31])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _equal_u32(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _round_trip_equals_plain(v):
    w = K.encode(v)
    torch.cuda.synchronize()
    assert _equal_u32(w, R.encode(v))
    back = K.decode(w)
    torch.cuda.synchronize()
    assert _equal_u32(back, v) and _equal_u32(back, R.decode(w))
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 32, 33, 130, 512, 1000, 1003, 4099, 70001, (1 << 20) + 3])
def test_cuda_kernel_equals_plain_version_on_ragged_r(cuda_device, rows):
    """R off the 32 groups of a warp's tile, off the 128 of a thread block
    and off a multiple of 4; at 2^20 + 3 groups more tiles than the card
    holds warps at once (132 SMs x at most 32 blocks of 4 warps), so each
    warp walks several."""
    v = torch.from_numpy(_vals(rows * 32).reshape(rows, 32)).to(cuda_device)
    _round_trip_equals_plain(v)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all-ones", "one-bit-per-plane"])
def test_cuda_kernel_on_patterns(cuda_device, kind):
    rows = 4099
    v = torch.from_numpy(_pattern(kind, rows)).to(cuda_device)
    w = _round_trip_equals_plain(v)
    assert np.array_equal(w.cpu().numpy(), _pattern_planes(kind, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2])
def test_cuda_kernel_on_views_at_a_storage_offset(cuda_device, offset):
    """Views 4 and 8 bytes past an aligned base: encode's values take the
    kernel's 4-byte accesses, and decode reads planes at the same offset."""
    rows = 1003
    flat = torch.from_numpy(_vals(rows * 32 + offset)).to(cuda_device)
    v = flat[offset:].view(rows, 32)
    assert v.data_ptr() % 16
    w = _round_trip_equals_plain(v)
    w_flat = torch.zeros(32 * rows + offset, dtype=torch.int32, device=cuda_device)
    w_flat[offset:] = w.view(torch.int32).reshape(-1)
    w_view = w_flat[offset:].view(torch.uint32).view(32, rows)
    assert w_view.data_ptr() % 16
    back = K.decode(w_view)
    torch.cuda.synchronize()
    assert _equal_u32(back, v)


@pytest.mark.cuda
@pytest.mark.parametrize("n", NS)
def test_cuda_ops_equal_the_cpu_ops(cuda_device, n):
    vals = torch.from_numpy(_vals(n))
    K.reset_launches()
    w = tbp.bitplane_encode(vals.to(cuda_device))
    back = tbp.bitplane_decode(w, n)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"encode": 1, "decode": 1}
    assert torch.equal(w.cpu().view(torch.int32), tbp.bitplane_encode(vals).view(torch.int32))
    assert torch.equal(back.cpu().view(torch.int32), vals.view(torch.int32))
