"""Compression quality / rate metrics used throughout the paper's evaluation.

Bit-rate, compression ratio, PSNR, NRMSE, max error — matching the paper's
definitions (§4.3: ``bitrate = bits / cr``; PSNR w.r.t. value range).  Each
takes numpy arrays or torch tensors (on any device) and computes in float64
on the device of its first tensor argument.
"""
from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def _t(x, like=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, torch.Tensor):
        return x.to(device) if device is not None else x
    return torch.as_tensor(np.asarray(x), device=device)


def _pair(original, decompressed):
    a = _t(original)
    b = _t(decompressed, like=a)
    return a.to(torch.float64), b.to(torch.float64)


def compression_ratio(original_nbytes: int, compressed_nbytes: int) -> float:
    if compressed_nbytes <= 0:
        return float("inf")
    return original_nbytes / compressed_nbytes


def bit_rate(original: Union[Array, int], compressed_nbytes: int) -> float:
    """Bits per value after compression.

    The paper (§4.3) defines bit-rate as ``itemsize * 8 / cr`` with
    ``cr = original_nbytes / compressed_nbytes``; since ``original_nbytes =
    n * itemsize`` this reduces to ``compressed_nbytes * 8 / n`` — the
    itemsize cancels, so only the element count matters.  ``original`` is
    either the array itself or its element count.
    """
    if isinstance(original, (int, np.integer)):
        n = int(original)
    else:
        n = _t(original).numel()
    if n == 0:
        return 0.0
    return compressed_nbytes * 8.0 / n


def max_abs_error(original, decompressed) -> float:
    a, b = _pair(original, decompressed)
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max())


def max_pw_rel_error(original, decompressed, eps: float = 0.0) -> float:
    a, b = _pair(original, decompressed)
    denom = a.abs()
    mask = denom > eps
    if not bool(mask.any()):
        return 0.0
    return float(((a[mask] - b[mask]).abs() / denom[mask]).max())


def mse(original, decompressed) -> float:
    a, b = _pair(original, decompressed)
    if a.numel() == 0:
        return 0.0  # vacuous: no points, no error
    return float(((a - b) ** 2).mean())


def _range(a: torch.Tensor) -> float:
    return float(a.max() - a.min())


def psnr(original, decompressed) -> float:
    """Peak signal-to-noise ratio w.r.t. the data value range (SZ convention).

    Degenerate inputs stay warning-free and nan-free: empty or exactly
    reconstructed data is ``inf``; a constant array (value range 0) that is
    NOT exactly reconstructed has no meaningful range-referenced PSNR, so the
    error power alone is reported (``-10 log10(mse)``), still finite.
    """
    a = _t(original).to(torch.float64)
    if a.numel() == 0:
        return float("inf")
    m = mse(original, decompressed)
    if m == 0:
        return float("inf")
    rng = _range(a)
    if rng == 0:
        return -10.0 * math.log10(m)
    return 20.0 * math.log10(rng) - 10.0 * math.log10(m)


def nrmse(original, decompressed) -> float:
    """Range-normalized RMSE; 0.0 for empty or constant-and-exact inputs."""
    a = _t(original).to(torch.float64)
    if a.numel() == 0:
        return 0.0
    m = mse(original, decompressed)
    rng = _range(a)
    if rng == 0:
        return 0.0 if m == 0 else float("inf")
    return math.sqrt(m) / rng


def value_range(x) -> float:
    a = _t(x)
    if a.numel() == 0:
        return 0.0
    return float(a.max() - a.min())
