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
* dequant_matmul: ``C = A @ (Q.float() * scale)`` in IEEE float32 (TF32
  off), held by tolerance: against a float64 product of the same operands
  it stays within ``(K+2) * 2**-24 * (|A| @ |deq|)``.
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
