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

* the tensor-core kernel's arithmetic: ``ref.split_bf16x3`` splits any
  float32 into three bf16 parts that sum to it exactly (above 2**-133 per
  bit; NaN and inf ride in the first part), and the kernel's accumulation
  order, emulated on the CPU with the card's truncating accumulator
  (``ref.tensor_core_dequant_matmul``), stays within both bounds above, and
  within the source note's worst-case counts over K = 32768 in one split,
  where promotion every 128 of K is what keeps the error small.
* quantize_append (the fused int8 decode append): the plain version
  writes the JAX oracle's codes and scales of each (b, h) row into the
  named ring slot, bit for bit, and leaves every other slot as it was, on
  float32 and bf16 rows (NaN, ±inf, zero, subnormal, floored and rint-tie
  rows among them) at hd 64, 112 and 128; the kernel's wrapper refuses
  CPU tensors, wrong types and shapes, and a slot off the cache's device.

The ``cuda``-marked tests run on a card
(``python -m pytest -q -m cuda tests/test_torch_kvquant.py``): absmax and
quantize bit-identical to their plain versions (NaN and all-zero columns
included), dequant_matmul within the float64 bound, also on rows near
2**-100 and 2**100, on misaligned views, with K = 32768 in one split, and
with NaN and infinite rows, whose non-finite outputs sit where the plain
version's do; and the card's sums equal the truncating model's bit for bit;
quantize_append bit-identical to its plain version in one launch at the
int8 append shapes of the served configs and on the edge rows above.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

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
# the tensor-core kernel's arithmetic, on the CPU
# ---------------------------------------------------------------------------

_F32_SPECIALS = [
    0x7F7FFFFF, 0xFF7FFFFF,  # +-FLT_MAX
    0x09000000, 0x09000001, 0x097FFFFF,  # 2**-109 and its neighbours above
    0x00000001, 0x00400000, 0x807FFFFF, 0x00012345,  # subnormals
    0x00800000, 0x00800001,  # FLT_MIN and above
    0x00000000, 0x80000000,  # +-0
    0x7F800000, 0xFF800000,  # +-inf
    0x7F800001, 0xFF80FFFF, 0x7FC00000, 0x7FFFFFFF, 0x7F810000,  # NaN payloads, low bits only and not
    0x3F800000, 0x3FFFFFFF, 0xBEAAAAAB,
]


def _check_split(bits: np.ndarray) -> None:
    a = bits.astype(np.uint32).view(np.float32)
    parts = kref.split_bf16x3(torch.from_numpy(a.copy()))
    for p in parts:
        assert np.all(p.numpy().view(np.uint32) & 0xFFFF == 0)  # each part a bf16
    fin = np.isfinite(a)
    with np.errstate(invalid="ignore"):  # NaN and inf inputs
        p0, p1, p2 = (p.numpy().astype(np.float64) for p in parts)
        a64 = a.astype(np.float64)
        on_grid = fin & (a64 * 2.0**133 == np.round(a64 * 2.0**133))  # lowest set bit >= 2**-133
        total = p0 + p1 + p2
    np.testing.assert_array_equal(total[on_grid], a64[on_grid])
    assert np.all(np.abs(total[fin & ~on_grid] - a64[fin & ~on_grid]) < 2.0**-133)
    # parts in decreasing order of size, the small ones under 2**-7 |a|
    assert np.all(np.abs(p1[fin] + p2[fin]) <= 2.0**-7 * np.abs(a64[fin]))
    # non-finite: p0 carries it, NaN stays NaN, the small parts are zero
    nf = ~fin
    assert np.all(p1[nf] == 0) and np.all(p2[nf] == 0)
    np.testing.assert_array_equal(np.isnan(p0[nf]), np.isnan(a[nf]))
    inf = np.isinf(a)
    np.testing.assert_array_equal(p0[inf], a64[inf])


def test_split_bf16x3_on_special_values():
    _check_split(np.array(_F32_SPECIALS, dtype=np.uint64))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2**32 - 1), min_size=1, max_size=64))
def test_split_bf16x3_property(words):
    _check_split(np.array(words, dtype=np.uint64))


def emulate_tensor_core_matmul(a: np.ndarray, q: np.ndarray, s: np.ndarray, kchunk_splits=None,
                               promote: int = 128) -> np.ndarray:
    """The CUDA kernel's arithmetic on the CPU, step by step, with the
    card's truncating accumulator (``kref.tensor_core_dequant_matmul``; the
    ``cuda`` test ``test_cuda_accumulator_matches_the_truncating_model``
    holds the card to it bit for bit)."""
    M, Kd = a.shape
    kchunk, splits = kchunk_splits or K.split_k(M, Kd, q.shape[1])
    out = kref.tensor_core_dequant_matmul(torch.from_numpy(a), torch.from_numpy(q),
                                          torch.from_numpy(s), kchunk, splits, promote)
    return out.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_tensor_core_order_within_the_float64_bound(shape):
    """The kernel's split-and-accumulate order, emulated with the card's
    truncating accumulator, keeps the float32 contract and the JAX test's
    tolerance against the JAX oracle."""
    x, rng = _x(shape)
    q_r, s_r = r_ref_quantize(x)
    q, s = np.array(q_r), np.array(s_r)
    a = rng.normal(size=(48, shape[0])).astype(np.float32)
    exact, tol = f64_bound(a, q, s)
    got = emulate_tensor_core_matmul(a, q, s)
    assert got.dtype == np.float32 and got.shape == (48, shape[1])
    assert np.all(np.abs(got - exact) <= tol)
    deq = q.astype(np.float32) * s[None, :]
    jax_tol = 1e-6 * (np.abs(a) @ np.abs(deq)) + 1e-4
    assert np.all(np.abs(got - np.asarray(r_ref_dequant_matmul(a, q_r, s_r))) <= jax_tol)


# rows that expose the accumulator's rounding against q = 1 (K = 32, N = 16):
# (row, what the card sums minus 2**24); round to nearest would give 12, 2,
# 12 (11.25 rounded to even), 0 and 4
_ACC_ROWS = [
    ([2.0**24] + [0.0] * 15 + [0.75] * 16, 8.0),  # next step: each 0.75 cut to 0.5
    ([2.0**24] + [0.0] * 15 + [1.5] + [0.0] * 15, 0.0),  # 2**24 + 1.5 cut toward zero
    ([2.0**24] + [0.75] * 15 + [0.0] * 16, 6.0),  # same step: 7.5, then cut to even
    ([2.0**24, -0.25] + [0.0] * 30, 0.0),  # a negative addend cut toward zero
    ([2.0**24] + [0.0] * 15 + [0.25] * 16, 0.0),  # below 2 bits under the ulp: dropped
]


def test_truncating_model_on_the_probe_rows():
    a = np.array([r for r, _ in _ACC_ROWS], dtype=np.float32)
    got = emulate_tensor_core_matmul(a, np.ones((32, 16), np.int8), np.ones(16, np.float32))
    np.testing.assert_array_equal(got[:, 0].astype(np.float64) - 2.0**24, [v for _, v in _ACC_ROWS])


def _long_run_ratio(a, q, s, promote):
    exact, tol = f64_bound(a, q, s)
    got = emulate_tensor_core_matmul(a, q, s, (a.shape[1], 1), promote)
    return float(np.max(np.abs(got - exact) / tol))


@pytest.mark.parametrize("peak", [2.0, 12.0])
def test_promotion_holds_a_long_run_in_one_split(peak):
    """K = 32768 in one split (what ``split_k`` gives once 67 or more output
    tiles fill the card): on softmax rows (peak 12: nearly one key) against
    positive codes, the truncating accumulator alone stays under the source
    note's (K-1)/2 + 2 K/16 + 3 count, and promotion every 128 of K keeps
    it under the note's 80 + K/128 + 0.0098 K + 3."""
    rng = np.random.default_rng(int(peak))
    Kd = 32768
    z = peak * rng.standard_normal((2, Kd))
    a = np.exp(z - z.max(axis=1, keepdims=True))
    a = (a / a.sum(axis=1, keepdims=True)).astype(np.float32)
    q = rng.integers(1, 128, (Kd, 4), dtype=np.int8)
    s = np.exp(rng.uniform(-5, 5, 4)).astype(np.float32)
    plain = _long_run_ratio(a, q, s, 0)
    promoted = _long_run_ratio(a, q, s, 128)
    assert plain <= ((Kd - 1) / 2 + 2 * Kd / 16 + 3) / (Kd + 2)
    assert promoted <= (80 + Kd / 128 + 0.0098 * Kd + 3) / (Kd + 2)
    assert promoted < plain


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
    assert kchunk % K._BK == 0 and splits >= 1
    assert (splits - 1) * kchunk < Kd <= splits * kchunk
    assert splits == 1 or kchunk >= 256
    tiles = -(-M // K._TILE) * -(-N // K._TILE)
    assert splits == 1 or splits * tiles <= K._TARGET_BLOCKS  # one wave


# ---------------------------------------------------------------------------
# the fused int8 decode append
# ---------------------------------------------------------------------------

#: (B, KV, hd) of the served configs' int8 append at batch 4: granite-3-8b,
#: deepseek-moe-16b, qwen3-moe-30b-a3b, zamba2-7b, whisper-small (mamba2-2.7b
#: has no attention layer)
APPEND_SHAPES = [(4, 8, 128), (4, 16, 128), (4, 4, 128), (4, 32, 112), (4, 12, 64)]


def _append_rows(B, KV, hd, seed):
    """k and v (B, 1, KV, hd) float32, exact in bf16: random rows over
    16 octaves, and in k a NaN row, an all-zero row (with -0.0), a row of
    rint ties (scale 0.125 exactly: codes are k + 0.5), an inf row, a -inf
    row, a subnormal row and a row whose scale is floored at 1e-8."""
    rng = np.random.default_rng(seed)
    shape = (B, 1, KV, hd)
    k, v = (rng.standard_normal(shape) * np.exp2(rng.integers(-8, 8, (B, 1, KV, 1))) for _ in range(2))
    rows = k.reshape(-1, hd)
    edges = [np.nan, 0.0, "ties", np.inf, -np.inf, "subnormal", "floored"]
    for r, edge in enumerate(edges[: rows.shape[0]]):
        if edge == "ties":
            n = np.arange(hd) % 127
            rows[r] = (2 * n + 1) / 16 * np.where(np.arange(hd) % 2, -1, 1)
            rows[r, 0] = 254 / 16  # amax 15.875: scale 0.125, every x / scale a half
        elif edge == "subnormal":
            rows[r] = rng.integers(-60, 60, hd) * np.float32(2.0**-133)
        elif edge == "floored":
            rows[r] = rng.standard_normal(hd) * 1e-7
        elif edge == 0.0:
            rows[r] = 0.0
            rows[r, 1::2] = -0.0
        else:
            rows[r, r % hd] = edge
    v.reshape(-1, hd)[-1, 3] = np.nan
    return (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy() for a in (k, v))


def _append_case(B, KV, hd, W, dtype, seed):
    """Inputs, random prior caches and scales, and the plain version's
    result on copies of them at slot 0 and W - 1."""
    k, v = _append_rows(B, KV, hd, seed)
    rng = np.random.default_rng(seed + 1)
    caches = [rng.integers(-127, 128, (B, W, KV, hd)).astype(np.int8) for _ in range(2)]
    scales = [rng.uniform(0.1, 2, (B, W, KV)).astype(np.float32) for _ in range(2)]
    kt, vt = (torch.from_numpy(a).to(dtype) for a in (k, v))
    return kt, vt, caches, scales


def _same_nan(a, b):
    """Bit identity, with a NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.all((np.isnan(a) & np.isnan(b)) | (_bits(a) == _bits(b))))


@pytest.mark.parametrize("slot_at", ["first", "last"])
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_quantize_append_equals_jax_oracle(dtype, hd, slot_at):
    B, KV, W = 2, 4, 5
    k, v, caches, scales = _append_case(B, KV, hd, W, dtype, hd * 10 + (dtype == torch.bfloat16))
    slot = 0 if slot_at == "first" else W - 1
    kc, vc = (torch.from_numpy(c.copy()) for c in caches)
    ks, vs = (torch.from_numpy(s.copy()) for s in scales)
    K.reset_launches()
    kv.kv_quantize_append(k, v, kc, vc, ks, vs, torch.tensor([slot]))
    assert all(n == 0 for n in K.LAUNCHES.values())
    for x, c0, s0, c, sc in ((k, caches[0], scales[0], kc, ks), (v, caches[1], scales[1], vc, vs)):
        xf = x.float().numpy()
        xj = jnp.asarray(xf, jnp.bfloat16) if dtype == torch.bfloat16 else jnp.asarray(xf)
        q_r, s_r = r_ref_quantize(xj.reshape(-1, hd).T)  # columns are the (b, h) rows
        want_c, want_s = c0.copy(), s0.copy()
        want_c[:, slot] = np.asarray(q_r).T.reshape(B, KV, hd)
        want_s[:, slot] = np.asarray(s_r).reshape(B, KV)
        _same(c.numpy(), want_c, "codes; every other slot untouched")
        assert _same_nan(sc.numpy(), want_s), "scales; every other slot untouched"
    ks_np = ks.numpy()[:, slot].reshape(-1)
    assert np.isnan(ks_np[0]) and ks_np[1] == ks_np[6] == ks_np[5] == np.float32(1e-8)
    assert ks_np[2] == 0.125 and np.isinf(ks_np[3]) and np.isinf(ks_np[4])
    ties = kc.numpy()[:, slot].reshape(-1, hd)[2].astype(np.int32)
    half = (2 * (np.arange(hd) % 127) + 1) / 2 * np.where(np.arange(hd) % 2, -1, 1)
    np.testing.assert_array_equal(ties[1:], np.rint(half[1:]))  # half to even
    assert ties[0] == 127 and not kc.numpy()[:, slot].reshape(-1, hd)[[0, 1, 3, 4, 5]].any()


def _append_args(dev="meta", dtype=torch.float32, B=2, KV=3, hd=8, W=4):
    return dict(
        k=torch.zeros((B, 1, KV, hd), dtype=dtype, device=dev),
        v=torch.zeros((B, 1, KV, hd), dtype=dtype, device=dev),
        k_cache=torch.zeros((B, W, KV, hd), dtype=torch.int8, device=dev),
        v_cache=torch.zeros((B, W, KV, hd), dtype=torch.int8, device=dev),
        k_scale=torch.zeros((B, W, KV), device=dev),
        v_scale=torch.zeros((B, W, KV), device=dev),
        slot=torch.zeros(1, dtype=torch.int64, device=dev),
    )


@pytest.mark.parametrize("dev", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_append_wrapper_refuses_non_cuda_tensors(dev, dtype):
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.quantize_append(**_append_args(dev, dtype))


@pytest.mark.parametrize("change, match", [
    (dict(k=torch.zeros((2, 1, 3, 8), dtype=torch.float16)), "float32 or bf16"),
    (dict(v=torch.zeros((2, 1, 3, 8), dtype=torch.bfloat16)), "float32 or bf16"),
    (dict(k=torch.zeros((2, 2, 3, 8)), v=torch.zeros((2, 2, 3, 8))), r"\(B, 1, KV, hd\)"),
    (dict(v=torch.zeros((2, 1, 3, 4))), r"\(B, 1, KV, hd\)"),
    (dict(k_cache=torch.zeros((2, 4, 3, 8), dtype=torch.uint8)), "k_cache must be int8"),
    (dict(v_cache=torch.zeros((2, 4, 3, 4), dtype=torch.int8)), "v_cache must be int8"),
    (dict(v_cache=torch.zeros((2, 5, 3, 8), dtype=torch.int8)), "differ"),
    (dict(k_scale=torch.zeros((2, 4, 3), dtype=torch.float64)), "k_scale must be float32"),
    (dict(v_scale=torch.zeros((2, 4, 4))), "v_scale must be float32"),
    (dict(slot=torch.zeros(1, dtype=torch.int32)), "one int64"),
    (dict(slot=torch.zeros(2, dtype=torch.int64)), "one int64"),
    (dict(k_cache=torch.zeros((2, 3, 4, 8), dtype=torch.int8).transpose(1, 2)), "contiguous"),
])
def test_append_wrapper_refuses_wrong_types_and_shapes(change, match):
    args = {**_append_args("cpu"), **change}
    with pytest.raises(ValueError, match=match):
        K.quantize_append(**args)


def test_append_refuses_an_off_device_slot():
    args = {**_append_args("meta"), "slot": torch.zeros(1, dtype=torch.int64)}
    with pytest.raises(ValueError, match="the slot included"):
        K.quantize_append(**args)
    with pytest.raises(ValueError, match="the slot included"):  # mixed devices go to the kernel's wrapper
        kv.kv_quantize_append(**args)
    with pytest.raises(ValueError, match="the slot included"):
        kv.kv_quantize_append(**{**_append_args("cpu"), "slot": torch.zeros(1, dtype=torch.int64, device="meta")})



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


def _card_matmul_operands(mkn, seed):
    M, Kd, N = mkn
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, Kd)).astype(np.float32)
    q = rng.integers(-127, 128, (Kd, N), dtype=np.int8)
    s = np.exp(rng.uniform(-5, 5, N)).astype(np.float32)
    return a, q, s


_EDGE_SHAPES = [(48, 300, 96), (48, 33, 200), (65, 4097, 130), (128, 32768, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", _EDGE_SHAPES)
def test_cuda_dequant_matmul_nonfinite_rows_match_plain(cuda_device, mkn):
    """Rows holding NaN, +inf, -inf or both infinities: the kernel's
    non-finite outputs sit where the plain version's do (NaN where NaN),
    and every all-finite row stays within the float64 bound."""
    a, q, s = _card_matmul_operands(mkn, 11)
    Kd = mkn[1]
    a[0, Kd // 2] = np.nan
    a[1, 0] = np.inf
    a[2, Kd - 1] = -np.inf
    a[3, 0], a[3, Kd - 1] = np.inf, -np.inf
    a[4, Kd // 3] = np.array([0x7F800001], np.uint32).view(np.float32)[0]  # NaN, payload in the low bits
    at, qt, st_ = (torch.from_numpy(v).to(cuda_device) for v in (a, q, s))
    got = K.dequant_matmul(at, qt, st_)
    torch.cuda.synchronize()
    plain = kref.dequant_matmul(at, qt, st_)
    assert torch.equal(torch.isfinite(got), torch.isfinite(plain))
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    assert torch.equal(torch.isinf(got) & (got > 0), torch.isinf(plain) & (plain > 0))
    exact, tol = f64_bound(a[5:], q, s)
    assert np.all(np.abs(got[5:].cpu().numpy() - exact) <= tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", _EDGE_SHAPES + [(1, 1, 1)])
def test_cuda_dequant_matmul_tiny_and_large_rows(cuda_device, mkn):
    """Rows near 2**-100 and 2**100: the three-part split stays exact."""
    a, q, s = _card_matmul_operands(mkn, 12)
    a[0::2] *= np.float32(2.0**-100)
    a[1::2] *= np.float32(2.0**100)
    exact, tol = f64_bound(a, q, s)
    at, qt, st_ = (torch.from_numpy(v).to(cuda_device) for v in (a, q, s))
    got = K.dequant_matmul(at, qt, st_)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert np.all(np.abs(got.cpu().numpy() - exact) <= tol)


def _ratio_on_card(out, a, q, s) -> float:
    """max |out - a @ deq| over the float64 bound, in float64 on the card."""
    deq = q.double() * s.double()[None, :]
    a64 = a.double()
    tol = (a.shape[1] + 2) * 2.0**-24 * (a64.abs() @ deq.abs())
    return float(((out.double() - a64 @ deq).abs() / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("codes", ["positive", "signed"])
def test_cuda_dequant_matmul_one_split_at_long_k(cuda_device, codes):
    """2048 x 32768 x 1024 has 128 output tiles, so ``split_k`` gives one
    split: all of K runs through one pair of accumulators, promoted every
    128 of K.  Softmax rows against positive or signed codes."""
    M, Kd, N = 2048, 32768, 1024
    assert K.split_k(M, Kd, N) == (Kd, 1)
    g = torch.Generator(device=cuda_device).manual_seed(21)
    a = torch.softmax(2 * torch.randn((M, Kd), generator=g, device=cuda_device), dim=-1)
    lo = 1 if codes == "positive" else -127
    q = torch.randint(lo, 128, (Kd, N), generator=g, device=cuda_device, dtype=torch.int8)
    s = torch.exp(torch.rand(N, generator=g, device=cuda_device) * 10 - 5)
    got = K.dequant_matmul(a, q, s)
    assert bool(torch.isfinite(got).all())
    assert _ratio_on_card(got, a, q, s) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(5, 32, 16), (48, 33, 200), (65, 4097, 130), (128, 4096, 1024)])
def test_cuda_accumulator_matches_the_truncating_model(cuda_device, mkn):
    """The card's sums equal ``ref.tensor_core_dequant_matmul`` bit for bit:
    on the rows built to expose the accumulator's rounding, and on random
    rows, where split-K, promotion and the two accumulators all count."""
    M, Kd, N = mkn
    if mkn == (5, 32, 16):
        a = np.array([r for r, _ in _ACC_ROWS], dtype=np.float32)
        q, s = np.ones((Kd, N), np.int8), np.ones(N, np.float32)
    else:
        a, q, s = _card_matmul_operands(mkn, 14)
    at, qt, st_ = (torch.from_numpy(v).to(cuda_device) for v in (a, q, s))
    got = K.dequant_matmul(at, qt, st_)
    want = kref.tensor_core_dequant_matmul(at, qt, st_, *K.split_k(M, Kd, N))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_dequant_matmul_on_misaligned_views(cuda_device):
    """Contiguous but not 16-byte aligned a and q take the element-wise
    loads of the same kernel, and agree within the bound."""
    a, q, s = _card_matmul_operands((64, 4096, 256), 13)
    abuf = torch.zeros(a.size + 1, device=cuda_device)
    abuf[1:] = torch.from_numpy(a.ravel()).to(cuda_device)
    qbuf = torch.zeros(q.size + 1, dtype=torch.int8, device=cuda_device)
    qbuf[1:] = torch.from_numpy(q.ravel()).to(cuda_device)
    at, qt = abuf[1:].view(a.shape), qbuf[1:].view(q.shape)
    assert at.data_ptr() % 16 and qt.data_ptr() % 16
    got = K.dequant_matmul(at, qt, torch.from_numpy(s).to(cuda_device))
    exact, tol = f64_bound(a, q, s)
    assert np.all(np.abs(got.cpu().numpy() - exact) <= tol)


@pytest.mark.cuda
@pytest.mark.parametrize("slot_at", ["first", "last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", APPEND_SHAPES + [(2, 4, 64), (2, 4, 112), (1, 1, 128), (3, 5, 33), (64, 8, 128)])
def test_cuda_quantize_append_equals_plain(cuda_device, shape, dtype, slot_at):
    """One launch, bit for bit with the plain version: every cache slot and
    scale, the edge rows of ``_append_rows`` included."""
    B, KV, hd = shape
    W = 24
    k, v, caches, scales = _append_case(B, KV, hd, W, dtype, B * 1000 + KV * 10 + hd)
    slot = torch.tensor([0 if slot_at == "first" else W - 1], device=cuda_device)
    got = [torch.from_numpy(a.copy()).to(cuda_device) for a in (*caches, *scales)]
    want = [t.clone() for t in got]
    kd, vd = k.to(cuda_device), v.to(cuda_device)
    K.reset_launches()
    kv.kv_quantize_append(kd, vd, *got, slot)
    torch.cuda.synchronize()
    assert K.LAUNCHES["quantize_append"] == 1 and K.LAUNCHES["absmax"] == K.LAUNCHES["quantize_with_scale"] == 0
    kref.quantize_append(kd, vd, *want, slot)
    for a, b in zip(got, want):
        assert _same_or_both_nan(a, b) if a.is_floating_point() else torch.equal(a, b)
    cpu = [torch.from_numpy(a.copy()) for a in (*caches, *scales)]
    kref.quantize_append(k, v, *cpu, slot.cpu())
    for a, b in zip(got, cpu):
        assert _same_or_both_nan(a.cpu(), b) if a.is_floating_point() else torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_quantize_append_out_of_ring_slot_writes_nothing(cuda_device):
    args = _append_args(cuda_device)
    before = {n: t.clone() for n, t in args.items()}
    for bad in (4, -1):
        args["slot"].fill_(bad)
        K.quantize_append(**args)
        torch.cuda.synchronize()
        for n in ("k_cache", "v_cache", "k_scale", "v_scale"):
            assert torch.equal(args[n], before[n])
