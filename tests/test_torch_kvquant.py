"""The port's KV-quantization kernels (``repro_torch.kernels.kvquant``) held
against the JAX package's, on the CPU, and the CUDA kernels against their
plain versions on a card.

* quantize: the plain version (what ``kv_quantize`` runs on a CPU tensor)
  equals the JAX oracle ``ref_quantize`` bit for bit, codes and scales, at
  the four shapes of ``tests/test_kernels.py``, and its codes equal the JAX
  kernel's (``kv_quantize``, interpret mode).  The JAX kernel's scales are
  not the oracle's: under ``jax.jit`` XLA rewrites ``amax / 127.0`` into a
  multiply by ``float32(1/127)``, one ulp off the divide at a few columns;
  the port divides, as the source and the oracle state.
* dequant_matmul: against a float64 product of the same operands, the plain
  version stays within ``(K+2) * 2**-24 * (|a| @ |deq|)``, the textbook
  bound of a float32 dot product of K terms; against the JAX kernel within
  the JAX test's ``1e-6 * (|a| @ |deq|) + 1e-4``, which holds at its
  K <= 512 only.

The ``cuda``-marked tests run on a card
(``python -m pytest -q -m cuda tests/test_torch_kvquant.py``): absmax and
quantize bit-identical to their plain versions (NaN and all-zero columns
included), dequant_matmul within the float64 bound.
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.kvquant import kv_dequant_matmul as r_dequant_matmul
    from repro.kernels.kvquant import kv_quantize as r_kv_quantize
    from repro.kernels.kvquant import ref_dequant_matmul as r_ref_dequant_matmul
    from repro.kernels.kvquant import ref_quantize as r_ref_quantize
except ImportError:  # a card's machine without JAX runs the cuda-marked tests only
    jnp = None

from repro_torch.kernels import kvquant as kv
from repro_torch.kernels.kvquant import kernel as K
from repro_torch.kernels.kvquant import ref as kref

SHAPES = [(300, 96), (512, 128), (64, 64), (33, 200)]


def _x(shape):
    """``tests/test_kernels.py``'s input for this shape (float32)."""
    rng = np.random.default_rng(abs(hash(shape)) % 997)
    T, C = shape
    x = rng.normal(0, 2, size=shape).astype(np.float32) * (1 + np.arange(C))[None, :]
    return x.astype(np.float32), rng


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def f64_bound(a: np.ndarray, q: np.ndarray, s: np.ndarray):
    """(float64 product, its float32 error allowance): every float32 dot
    product of K terms in any order, with the scale applied before or after
    the sum, stays within ``(K+2) * 2**-24 * (|a| @ |deq|)`` of it."""
    deq = q.astype(np.float64) * s.astype(np.float64)[None, :]
    a64 = a.astype(np.float64)
    return a64 @ deq, (a.shape[1] + 2) * 2.0**-24 * (np.abs(a64) @ np.abs(deq))


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_plain_quantize_equals_jax_oracle(shape):
    x, _ = _x(shape)
    q, s = kv.kv_quantize(torch.from_numpy(x))
    q_r, s_r = r_ref_quantize(x)
    _same(q.numpy(), q_r, "codes")
    _same(s.numpy(), s_r, "scales")
    q2, s2 = kv.ref_quantize(torch.from_numpy(x))
    _same(q2.numpy(), q.numpy())
    _same(s2.numpy(), s.numpy())
    # the per-element bound of the linear quantizer
    deq = q.numpy().astype(np.float32) * s.numpy()[None, :]
    assert np.all(np.abs(deq - x) <= s.numpy()[None, :] * 0.5001)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_quantize_against_jax_kernel(shape):
    """Codes bit-identical to the JAX kernel; scales equal except where
    XLA's reciprocal rewrite under jit moves them by one ulp."""
    x, _ = _x(shape)
    q, s = kv.kv_quantize(torch.from_numpy(x))
    q_k, s_k = r_kv_quantize(jnp.asarray(x))
    _same(q.numpy(), q_k, "codes against the JAX kernel")
    s, s_k = s.numpy(), np.asarray(s_k)
    amax = np.abs(x).max(axis=0)
    differ = s != s_k
    np.testing.assert_array_equal(s[differ], (amax / np.float32(127.0))[differ])
    np.testing.assert_array_equal(s_k[differ], (amax * np.float32(1.0 / 127.0))[differ])
    assert np.all(np.abs(s - s_k) <= np.spacing(s))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_dequant_matmul_within_the_float64_bound(shape):
    x, rng = _x(shape)
    q_r, s_r = r_ref_quantize(x)
    q, s = np.array(q_r), np.array(s_r)
    a = rng.normal(size=(48, shape[0])).astype(np.float32)
    exact, tol = f64_bound(a, q, s)
    at, qt, st = torch.from_numpy(a), torch.from_numpy(q), torch.from_numpy(s)
    for got in (kv.kv_dequant_matmul(at, qt, st), kv.ref_dequant_matmul(at, qt, st)):
        assert got.dtype == torch.float32 and got.shape == (48, shape[1])
        assert np.all(np.abs(got.numpy() - exact) <= tol)
    # the JAX test's tolerance against the JAX kernel and oracle (K <= 512)
    deq = q.astype(np.float32) * s[None, :]
    jax_tol = 1e-6 * (np.abs(a) @ np.abs(deq)) + 1e-4
    got = kv.kv_dequant_matmul(at, qt, st).numpy()
    assert np.all(np.abs(got - np.asarray(r_dequant_matmul(jnp.asarray(a), q_r, s_r))) <= jax_tol)
    assert np.all(np.abs(got - np.asarray(r_ref_dequant_matmul(a, q_r, s_r))) <= jax_tol)


def test_plain_absmax_propagates_nan_and_floors_zero_columns():
    x = np.ones((300, 8), np.float32)
    x[5, 3] = np.nan
    x[:, 6] = 0.0
    x[:, 7] = -0.0
    q, s = kv.kv_quantize(torch.from_numpy(x))
    q_r, s_r = r_ref_quantize(x)
    s = s.numpy()
    assert np.isnan(s[3]) and np.isnan(np.asarray(s_r)[3])
    assert s[6] == s[7] == np.float32(1e-8)
    assert (q[:, 3] == 0).all() and (q[:, 6:] == 0).all()
    _same(q.numpy(), q_r)
    assert kref.absmax(torch.from_numpy(x))[7].item() == 0.0
    assert not torch.signbit(kref.absmax(torch.from_numpy(x))[7])


def test_quantize_divides():
    """The quotient is a true divide: at these values ``x * f32(1/s)``
    rounds to the other side of a half, a divide does not."""
    s = np.float32(0.3)
    x = (np.arange(1, 4000, dtype=np.float32) + np.float32(0.5)) * s
    div = np.rint(x / s)
    mul = np.rint(x * np.float32(1 / s))
    assert (div != mul).any()  # the case exists in this range
    q = kref.quantize_with_scale(torch.from_numpy(x[:, None]), torch.tensor([s]))
    np.testing.assert_array_equal(q.numpy()[:, 0], np.clip(div, -127, 127).astype(np.int8))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def test_cpu_tensors_use_the_plain_version_and_count_no_launch():
    K.reset_launches()
    q, s = kv.kv_quantize(torch.ones((4, 4)))
    kv.kv_dequant_matmul(torch.ones((2, 4)), q, s)
    assert all(v == 0 for v in K.LAUNCHES.values())


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_kernel_wrappers_refuse_non_cuda_tensors(dev):
    x = torch.zeros((4, 4), device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.absmax(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.quantize_with_scale(x, torch.ones(4, device=dev))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.dequant_matmul(x, torch.zeros((4, 4), dtype=torch.int8, device=dev), torch.ones(4, device=dev))


def test_library_is_named_after_its_source():
    assert K.LIBRARY.src.name == "kvquant.cu" and K.LIBRARY.src.exists()
    assert K.library_path().name.startswith("libkvquant-")


@pytest.mark.parametrize("mkn", [(128, 32768, 1024), (48, 300, 300), (48, 33, 200), (1, 1, 1),
                                 (4096, 4096, 4096), (64, 100000, 64)])
def test_split_k_covers_k_in_whole_steps(mkn):
    M, Kd, N = mkn
    kchunk, splits = K.split_k(M, Kd, N)
    assert kchunk % 16 == 0 and splits >= 1
    assert (splits - 1) * kchunk < Kd <= splits * kchunk
    assert splits == 1 or kchunk >= 256


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


def _card_input(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * np.exp(rng.uniform(-8, 8, (1, shape[1])))).astype(np.float32)
    if shape[1] > 4:
        x[:, 1] = 0.0  # all-zero column: scale floored, codes 0
        x[shape[0] // 2, 2] = np.nan  # NaN column: NaN scale, codes 0
        x[:, 3] = np.nan  # all-NaN column
        x[0, 4] = np.inf  # inf column: inf scale
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(300, 97), (1, 1), (1000, 3), (4099, 1024), (32768, 1024)])
def test_cuda_absmax_and_quantize_equal_plain(cuda_device, shape):
    x = torch.from_numpy(_card_input(shape, shape[0] * 7 + shape[1])).to(cuda_device)
    K.reset_launches()
    amax = K.absmax(x)
    torch.cuda.synchronize()
    assert _same_or_both_nan(amax, kref.absmax(x))
    scale = kref.scale_from_absmax(amax)
    q = K.quantize_with_scale(x, scale)
    torch.cuda.synchronize()
    assert torch.equal(q, kref.quantize_with_scale(x, scale))
    q2, s2 = kv.kv_quantize(x)
    q3, s3 = kref.quantize(x.cpu())
    assert torch.equal(q2.cpu(), q3) and _same_or_both_nan(s2.cpu(), s3)
    assert K.LAUNCHES["absmax"] == 2 and K.LAUNCHES["quantize_with_scale"] == 2


@pytest.mark.cuda
def test_cuda_quantize_scalar_path_on_a_misaligned_view(cuda_device):
    base = torch.randn((257, 129), device=cuda_device)
    x = base[:, 1:]  # 128 columns, rows 16-byte misaligned: copied contiguous
    s = kref.scale_from_absmax(kref.absmax(x))
    assert torch.equal(K.quantize_with_scale(x, s), kref.quantize_with_scale(x, s))
    xs = base.reshape(-1)[1 : 1 + 256 * 128].reshape(256, 128)  # contiguous, misaligned
    s = kref.scale_from_absmax(kref.absmax(xs))
    assert torch.equal(K.quantize_with_scale(xs, s), kref.quantize_with_scale(xs, s))


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(48, 300, 300), (48, 33, 200), (1, 1, 1), (65, 4097, 130),
                                 (128, 32768, 1024), (200, 20000, 64)])
def test_cuda_dequant_matmul_within_the_float64_bound(cuda_device, mkn):
    M, Kd, N = mkn
    rng = np.random.default_rng(M * Kd + N)
    a = rng.standard_normal((M, Kd)).astype(np.float32)
    q = rng.integers(-127, 128, (Kd, N), dtype=np.int8)
    s = np.exp(rng.uniform(-5, 5, N)).astype(np.float32)
    exact, tol = f64_bound(a, q, s)
    at, qt, st = (torch.from_numpy(v).to(cuda_device) for v in (a, q, s))
    got = K.dequant_matmul(at, qt, st)
    torch.cuda.synchronize()
    plain = kref.dequant_matmul(at, qt, st)
    for out in (got, plain):
        assert out.shape == (M, N) and bool(torch.isfinite(out).all())
        assert np.all(np.abs(out.cpu().numpy() - exact) <= tol)
