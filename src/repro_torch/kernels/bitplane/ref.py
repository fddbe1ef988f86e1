"""Plain torch version of the 32x32 bitplane transpose.

Layout contract, as the JAX package's ``repro.kernels.bitplane.ref``: the
values are viewed as (R, 32) uint32, where row r holds 32 consecutive
values; the transpose emits ``out[p, r] = sum_k ((v[r, k] >> p) & 1) << k``,
plane p's bits of group r packed little-endian into one word.  ``decode`` is
its inverse.

torch's uint32 has few arithmetic ops, so the bits are worked in int64 and
only the bit patterns travel as ``torch.uint32`` (through ``view`` on an
int32 tensor), on the CPU and on the card alike.  Each plane (or value
column) is built in its own pass, so the scratch is one (R, 32) int64
tensor, not (32, R, 32).
"""
from __future__ import annotations

import torch


def as_u32(t: torch.Tensor) -> torch.Tensor:
    """Integer or uint32 values as uint32 bit patterns (wrapping mod 2^32,
    as ``astype(uint32)`` does)."""
    if t.dtype == torch.uint32:
        return t
    if t.is_floating_point() or t.is_complex():
        raise ValueError(f"bitplane: expected integer values, got {t.dtype}")
    return (t.to(torch.int64) & 0xFFFFFFFF).to(torch.int32).view(torch.uint32)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns -> int64 in [0, 2^32)."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> uint32 bit patterns."""
    return t.to(torch.int32).view(torch.uint32)


def encode(v: torch.Tensor) -> torch.Tensor:
    """v: (R, 32) uint32 -> (32, R) uint32 plane words."""
    if v.ndim != 2 or v.shape[1] != 32 or v.dtype != torch.uint32:
        raise ValueError(f"bitplane encode: expected (R, 32) uint32, got {tuple(v.shape)} {v.dtype}")
    v64 = _wide(v.contiguous())
    k = torch.arange(32, dtype=torch.int64, device=v.device)
    planes = [(((v64 >> p) & 1) << k).sum(dim=1) for p in range(32)]
    return _narrow(torch.stack(planes))


def decode(w: torch.Tensor) -> torch.Tensor:
    """w: (32, R) uint32 plane words -> (R, 32) uint32 values."""
    if w.ndim != 2 or w.shape[0] != 32 or w.dtype != torch.uint32:
        raise ValueError(f"bitplane decode: expected (32, R) uint32, got {tuple(w.shape)} {w.dtype}")
    w64 = _wide(w.contiguous())
    p = torch.arange(32, dtype=torch.int64, device=w.device)[:, None]
    cols = [(((w64 >> k) & 1) << p).sum(dim=0) for k in range(32)]
    return _narrow(torch.stack(cols, dim=1))
