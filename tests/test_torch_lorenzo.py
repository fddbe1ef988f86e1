"""The port's Lorenzo kernels (``repro_torch.kernels.lorenzo``).

On the CPU the wrappers run the plain torch versions; those are held bit for
bit (tolerance 0) against the JAX package's oracle and its Pallas kernels in
interpret mode, at tile-straddling shapes.  The CUDA kernels themselves are
held against the plain versions in the ``cuda``-marked tests, which skip
where there is no card.  JAX is imported inside the tests that compare with
it, so the ``cuda`` tests also run on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_lorenzo.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.kernels.lorenzo import kernel as K
from repro_torch.kernels.lorenzo import ops as tops
from repro_torch.kernels.lorenzo import ref as tref

SHAPES = [(100, 300), (256, 512), (7, 50), (1, 1000), (513, 129), (8, 128)]
RADIUS = 32768


def _field(shape, mode):
    rng = np.random.default_rng(7 * shape[0] + shape[1] + (mode == "2d"))
    return np.cumsum(rng.normal(size=shape).astype(np.float32), axis=1)


def _jax_oracle(x, eb, mode):
    import jax.numpy as jnp
    from repro.kernels.lorenzo import ref as jref

    enc = jref.encode_1d if mode == "1d" else jref.encode_2d
    dec = jref.decode_1d if mode == "1d" else jref.decode_2d
    codes, d = enc(jnp.asarray(x), eb, RADIUS)
    return np.asarray(codes), np.asarray(d), np.asarray(dec(d, eb))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["1d", "2d"])
@pytest.mark.parametrize("eb", [1e-1, 1e-3])
def test_plain_versions_equal_jax_oracle(shape, mode, eb):
    x = _field(shape, mode)
    c_j, d_j, xh_j = _jax_oracle(x, eb, mode)
    c_t, d_t = tops.ref_encode(x, eb, RADIUS, mode=mode)
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    np.testing.assert_array_equal(tops.ref_decode(d_t, eb, mode=mode).numpy(), xh_j)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["1d", "2d"])
@pytest.mark.parametrize("eb", [1e-1, 1e-3])
def test_cpu_wrappers_equal_pallas_interpret(shape, mode, eb):
    import jax.numpy as jnp
    from repro.kernels.compat import HAS_PALLAS_TPU

    if not HAS_PALLAS_TPU:
        pytest.skip("jax.experimental.pallas.tpu is not importable in this JAX build")
    from repro.kernels.lorenzo import ops as jops

    x = _field(shape, mode)
    c_k, d_k = jops.lorenzo_encode(jnp.asarray(x), eb=eb, mode=mode, interpret=True)
    xh_k = jops.lorenzo_decode(d_k, eb=eb, mode=mode, interpret=True)
    c_t, d_t = tops.lorenzo_encode(torch.from_numpy(x), eb=eb, mode=mode)
    xh_t = tops.lorenzo_decode(d_t, eb=eb, mode=mode)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_k))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_k))
    np.testing.assert_array_equal(xh_t.numpy(), np.asarray(xh_k))


@pytest.mark.parametrize("n", [4096, 5000])
def test_pipeline_wrappers_flatten_1d_as_one_row(n):
    """1-D data runs the 1d kernels as one (1, N) row and keeps its shape."""
    x = torch.from_numpy(_field((1, n), "1d")[0])
    codes, d = tops.encode_pipeline(x, eb=1e-2)
    assert codes.shape == d.shape == (n,)
    c2, d2 = tref.encode_1d(x.reshape(1, -1), 1e-2, RADIUS)
    assert torch.equal(codes, c2[0]) and torch.equal(d, d2[0])
    assert torch.equal(tops.decode_pipeline(d, eb=1e-2), tref.decode_1d(d2, 1e-2)[0])


def test_prefix_sums_wrap_in_int32():
    """Decode sums wrap in two's complement as jnp.cumsum(dtype=int32)."""
    import jax.numpy as jnp
    from repro.kernels.lorenzo import ref as jref

    d = np.full((2, 6), 2**30, np.int32)
    d[1, :] = -(2**30)
    for mode in ("1d", "2d"):
        dec = jref.decode_1d if mode == "1d" else jref.decode_2d
        want = np.asarray(dec(jnp.asarray(d), 0.5))
        np.testing.assert_array_equal(tops.ref_decode(d, 0.5, mode=mode).numpy(), want)


def test_cpu_tensors_use_the_plain_version_and_count_no_launch():
    K.reset_launches()
    x = torch.from_numpy(_field((8, 128), "2d"))
    for mode in ("1d", "2d"):
        _, d = tops.lorenzo_encode(x, eb=1e-2, mode=mode)
        tops.lorenzo_decode(d, eb=1e-2, mode=mode)
    assert all(v == 0 for v in K.LAUNCHES.values())


@pytest.mark.parametrize("name", ["encode_1d", "encode_2d", "decode_1d", "decode_2d"])
def test_kernel_wrappers_refuse_non_cuda_tensors(name):
    """A wrapper never falls back: a tensor that is not on a card raises
    before anything is built or launched."""
    dtype = torch.float32 if name.startswith("encode") else torch.int32
    t = torch.zeros((4, 4), dtype=dtype)
    args = (t, 1e-2, RADIUS) if name.startswith("encode") else (t, 1e-2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(K, name)(*args)
    meta = torch.zeros((4, 4), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(tops, "lorenzo_" + name[:6])(meta, eb=1e-2, mode=name[-2:])


def test_build_targets_sm90a_without_fast_math():
    flags = " ".join(K.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert K.library_path().name.startswith("liblorenzo-")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(1800, 3600), (1801, 3599), (1, (1 << 20) + 3)])
@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_cuda_kernels_equal_plain_versions(cuda_device, shape, mode):
    x = torch.from_numpy(_field(shape, mode)).to(cuda_device)
    enc, dec = getattr(K, f"encode_{mode}"), getattr(K, f"decode_{mode}")
    codes, d = enc(x, 1e-3, RADIUS)
    torch.cuda.synchronize()
    c_r, d_r = getattr(tref, f"encode_{mode}")(x, 1e-3, RADIUS)
    assert torch.equal(codes, c_r) and torch.equal(d, d_r)
    out = dec(d, 1e-3)
    torch.cuda.synchronize()
    assert torch.equal(out, getattr(tref, f"decode_{mode}")(d_r, 1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 96), (5000,), (300, 700)])
def test_cuda_pipeline_writes_the_plain_versions_bytes(cuda_device, shape):
    """sz3_lorenzo on the card takes the kernel route and writes the bytes
    the plain versions write on the CPU; both decodes keep the bound."""
    rng = np.random.default_rng(len(shape))
    x = np.cumsum(rng.normal(size=shape), axis=-1).astype(np.float32)
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    K.reset_launches()
    card = tc.sz3_lorenzo(device=cuda_device).compress(x, conf).blob
    assert K.LAUNCHES["encode_1d" if len(shape) == 1 else "encode_2d"] == 1
    assert card == tc.sz3_lorenzo(device="cpu", route="force").compress(x, conf).blob
    abs_eb = tc.parse_header(card)[0]["abs_eb"]
    for device in (cuda_device, "cpu"):
        out = tc.decompress(card, device=device).cpu().numpy()
        assert np.max(np.abs(out.astype(np.float64) - x)) <= abs_eb
