"""Public wrappers around the KV-quantization kernels.

A CPU tensor goes through the plain version (``ref.py``); any other tensor
goes to the CUDA kernels, which launch or raise — there is no fallback.
The CUDA kernels take any (T, C) and (M, K, N) with bounds checks at the
ragged edges, so unlike the JAX package's wrappers nothing is padded to
tile multiples.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel as _k
from . import ref as _ref

SCALE_FLOOR = _ref.SCALE_FLOOR


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, C) -> (int8 codes (T, C), per-channel scale (C,)), on x's device."""
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return _ref.quantize(x)
    scale = _ref.scale_from_absmax(_k.absmax(x))  # an IEEE divide, on the card
    return _k.quantize_with_scale(x, scale), scale


def kv_dequant_matmul(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ dequant(q (K, N), scale (N,)) -> (M, N) f32, on a's device."""
    fn = _ref.dequant_matmul if a.device.type == "cpu" else _k.dequant_matmul
    return fn(a.to(torch.float32), q, scale)


def ref_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _ref.quantize(x)


def ref_dequant_matmul(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _ref.dequant_matmul(a, q, scale)
