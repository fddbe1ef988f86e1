"""Plain versions of the KV-cache quantization kernels.

Contract (the JAX package's oracle, ``repro/kernels/kvquant/ref.py``):

* quantize: per-channel symmetric int8.  ``scale[c] = max(absmax(x[:, c])
  / 127, 1e-8)`` and ``q = clip(rint(x / scale), -127, 127)``, both divides
  true IEEE divides (``quantizers.true_div`` for the scalar 127: on CUDA,
  torch turns a divide by a Python scalar into a reciprocal multiply);
  ``rint`` rounds half to even.  The CUDA kernels equal these bit for bit.
* NaN: ``absmax`` propagates it (as ``jnp.max`` does), so a column holding
  a NaN gets a NaN scale; a NaN quotient becomes code 0 (the JAX package's
  float-to-int8 conversion gives 0 for NaN too).
* quantize_append: the int8 decode append, the reference's
  ``_quantize_token`` plus ``dynamic_update_slice_in_dim``
  (``repro/models/lm.py``): quantize each (b, h) row of the new token's K
  and V (B, 1, KV, hd) over its hd values, as ``quantize`` does a column,
  and write codes and scales into ring slot ``slot`` of the caches.
* dequant_matmul: ``C = A @ (Q.float() * scale)`` in IEEE float32 (TF32
  off), held by tolerance: against a float64 product of the same operands
  it stays within ``(K+2) * 2**-24 * (|A| @ |deq|)``.  The CUDA kernel
  runs on the tensor cores in bf16 without loosening that: ``Q`` is exact
  in bf16, ``A`` splits exactly into three bf16 parts
  (:func:`split_bf16x3`), and bf16 products are exact in float32, so only
  the float32 accumulation rounds; it is held to the same tolerance.
"""
from __future__ import annotations

import torch

from ...core.quantizers import true_div

SCALE_FLOOR = 1e-8


def absmax(x: torch.Tensor) -> torch.Tensor:
    """(T, C) -> per-column max |x|, (C,) float32; NaN propagates."""
    return x.to(torch.float32).abs().amax(dim=0)


def scale_from_absmax(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(true_div(amax, 127.0), SCALE_FLOOR)


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(T, C) and per-column scale (C,) -> int8 codes (T, C)."""
    q = torch.clamp(torch.round(x.to(torch.float32) / scale[None, :]), -127, 127)
    q = torch.where(torch.isnan(q), torch.zeros((), dtype=q.dtype, device=q.device), q)
    return q.to(torch.int8)


def quantize(x: torch.Tensor):
    """x: (T, C) f32/bf16 -> (q int8 (T, C), scale f32 (C,))."""
    scale = scale_from_absmax(absmax(x))
    return quantize_with_scale(x, scale), scale


def quantize_rows(x: torch.Tensor):
    """x (..., hd) -> (codes int8 (..., hd), scale f32 (...)): :func:`quantize`
    on the transposed view (hd, rows), whose columns are the rows of x."""
    q, scale = quantize(x.reshape(-1, x.shape[-1]).T)
    return q.T.reshape(x.shape), scale.reshape(x.shape[:-1])


def quantize_append(k: torch.Tensor, v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_scale: torch.Tensor, v_scale: torch.Tensor, slot: torch.Tensor) -> None:
    """k, v (B, 1, KV, hd) -> codes into ``k_cache``/``v_cache`` (B, W, KV,
    hd) int8 and scales into ``k_scale``/``v_scale`` (B, W, KV) float32 at
    ring slot ``slot`` (a 1-element int64 tensor), in place."""
    for x, cache, scales in ((k, k_cache, k_scale), (v, v_cache, v_scale)):
        q, scale = quantize_rows(x)
        cache.index_copy_(1, slot, q)
        scales.index_copy_(1, slot, scale)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[None, :]


def dequant_matmul(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """a: (M, K) f32; q: (K, N) int8; scale: (N,) -> (M, N) f32, in IEEE
    float32 (TF32 is switched off for the call and restored after)."""
    b = dequantize(q, scale)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a.to(torch.float32), b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


_HIGH16 = -65536  # 0xFFFF0000 as int32


def split_bf16x3(a: torch.Tensor):
    """The CUDA matmul's split of float32 ``a`` into three parts, each a
    float32 whose low 16 bits are zero (a bf16 value): ``p0`` is ``a``
    truncated to bf16, ``p1`` the remainder ``a - p0`` (exact) truncated,
    ``p2`` the rest, truncated too.  ``p0 + p1 + p2 == a`` exactly for every
    finite ``a`` whose lowest set bit is at or above 2**-133 (bf16's
    subnormal step); below it ``p2`` loses bits worth less than 2**-133.
    Non-finite ``a``: ``p0`` carries it (a NaN whose payload lies only in the
    low 16 bits becomes a quiet NaN, never inf), ``p1 = p2 = 0``.  For tests
    and ``chip_smoke.py``: documents ``split3`` in ``csrc/kvquant.cu``."""
    a = a.to(torch.float32).contiguous()
    bits = a.view(torch.int32)
    nonfinite = (bits & 0x7F800000) == 0x7F800000
    p0 = bits & _HIGH16
    p0 = torch.where(nonfinite & ((bits & 0x007FFFFF) != 0), p0 | 0x00400000, p0).view(torch.float32)
    finite = torch.where(nonfinite, torch.zeros_like(a), a)
    r = finite - torch.where(nonfinite, torch.zeros_like(a), p0)  # exact
    p1 = (r.view(torch.int32) & _HIGH16).view(torch.float32)
    p2 = ((r - p1).view(torch.int32) & _HIGH16).view(torch.float32)  # r - p1 exact
    return p0, p1, p2


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) of each value, float64; very negative for 0."""
    _, e = torch.frexp(x.double())
    return torch.where(x == 0, torch.full_like(x, -4096, dtype=torch.float64), (e - 1).double())


def _wgmma_step(c: torch.Tensor, prods: torch.Tensor, exps: torch.Tensor) -> torch.Tensor:
    """One ``wgmma`` k16 step as an H100 sums it (measured there): the
    float32 accumulator ``c`` (M, N) and the step's exact products ``prods``
    (M, N, n, float64) are aligned to 2^E, the largest exponent among them:
    c's own, and for a product the sum of its factors' exponents (``exps``;
    a product whose significands multiply to 2 or more thus counts one
    below its own).  Bits under 2^(E - 25) are cut toward zero, the rest
    summed exactly, and the sum cut toward zero to float32.  Finite values
    in float32's normal range."""
    addends = torch.cat([c.double()[..., None], prods], dim=-1)
    e = torch.cat([_exponent(c)[..., None], exps], dim=-1).amax(dim=-1, keepdim=True)
    step = torch.exp2(e.clamp_min(-1000) - 25)  # all addends 0: any step
    total = (torch.trunc(addends / step) * step).sum(dim=-1)  # exact: under 2^31 steps
    f = total.float()
    return torch.where(f.double().abs() > total.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def tensor_core_dequant_matmul(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                               kchunk: int, splits: int, promote: int = 128) -> torch.Tensor:
    """A model of the CUDA matmul's arithmetic, step by step: per split of
    ``kchunk`` and per 16 of K, one :func:`_wgmma_step` of the a0 products
    (:func:`split_bf16x3`) into ``hi``, then one each of the a1 and a2
    products into ``lo``; every ``promote`` of K (0: never) ``hi`` is added
    into a float32 sum and restarts; a split gives ``(sum + hi) + lo``; the
    splits are summed in order and scaled.  For tests and ``chip_smoke.py``
    (finite ``a`` only): the kernel's worst case in ``csrc/kvquant.cu`` is
    counted on this model."""
    parts = [p.double() for p in split_bf16x3(a)]
    qd = q.double()
    exps, qe = [_exponent(p) for p in parts], _exponent(qd)
    M, K = a.shape
    zero = torch.zeros((M, q.shape[1]), dtype=torch.float32, device=a.device)
    total = None
    for z in range(splits):
        hi_sum, hi, lo = zero, zero, zero
        for i, k0 in enumerate(range(z * kchunk, min((z + 1) * kchunk, K), 16)):
            if promote and i and (16 * i) % promote == 0:
                hi_sum, hi = hi_sum + hi, zero
            ks = slice(k0, min(k0 + 16, K))
            (p0, e0), (p1, e1), (p2, e2) = (
                ((p[:, ks, None] * qd[None, ks, :]).transpose(1, 2),
                 (pe[:, ks, None] + qe[None, ks, :]).transpose(1, 2)) for p, pe in zip(parts, exps))
            hi = _wgmma_step(hi, p0, e0)
            lo = _wgmma_step(_wgmma_step(lo, p1, e1), p2, e2)
        part = (hi_sum + hi) + lo
        total = part if total is None else total + part
    return total * scale.to(torch.float32)[None, :]
