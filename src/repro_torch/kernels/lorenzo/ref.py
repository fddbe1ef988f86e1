"""Plain PyTorch versions of the four fused prequantize+Lorenzo kernels.

They repeat the CUDA kernels' arithmetic with ordinary torch ops.  The
kernel wrappers run them for tensors on the CPU, the tests hold them bit for
bit against the JAX package's oracle (``repro.kernels.lorenzo.ref``) and its
Pallas kernels, and the chip smoke test holds each CUDA kernel against them.

Semantics contract (all inputs 2-D; a (1, N) input is a global 1-D series):

  encode: q = rint(x * f32(1/(2*eb))) as int32, round half to even
          1d mode : d[r, c] = q[r, c] - q[r, c-1]           (q[., -1] = 0)
          2d mode : d = diff_rows(diff_cols(q))             (zero-padded)
          codes = d + radius where |d| < radius else 0  (int32)
          draw  = d                                     (int32, raw diffs)

  decode: inclusive int32 prefix sums (along rows; 2d mode then along
          columns), wrapping in two's complement; xhat = f32(q) * f32(2*eb)

Both constants are computed in Python float64 and rounded to float32 only
when they meet the float32 tensor, as the JAX package does.  Multiplying a
float32 tensor by a Python float does exactly that on CPU and CUDA.
"""
from __future__ import annotations

import torch


def prequant(x: torch.Tensor, eb: float) -> torch.Tensor:
    inv = 1.0 / (2.0 * float(eb))
    return torch.round(x.to(torch.float32) * inv).to(torch.int32)


def _codes(d: torch.Tensor, radius: int) -> torch.Tensor:
    return torch.where(d.abs() < radius, d + radius, 0).to(torch.int32)


def _diff(q: torch.Tensor, dim: int) -> torch.Tensor:
    """First difference along ``dim`` with a zero before the first element."""
    shape = list(q.shape)
    shape[dim] = 1
    return torch.diff(q, dim=dim, prepend=q.new_zeros(shape))


def encode_1d(x: torch.Tensor, eb: float, radius: int):
    """Row-independent 1-D Lorenzo; a (1, N) input is a global 1-D series."""
    d = _diff(prequant(x, eb), 1)
    return _codes(d, radius), d


def encode_2d(x: torch.Tensor, eb: float, radius: int):
    d = _diff(_diff(prequant(x, eb), 0), 1)
    return _codes(d, radius), d


def _dequant(q: torch.Tensor, eb: float) -> torch.Tensor:
    return q.to(torch.float32) * (2.0 * float(eb))


def decode_1d(d: torch.Tensor, eb: float) -> torch.Tensor:
    # dtype=int32 keeps the sum in int32 (torch would widen to int64)
    return _dequant(torch.cumsum(d, dim=1, dtype=torch.int32), eb)


def decode_2d(d: torch.Tensor, eb: float) -> torch.Tensor:
    q = torch.cumsum(d, dim=1, dtype=torch.int32)
    return _dequant(torch.cumsum(q, dim=0, dtype=torch.int32), eb)
