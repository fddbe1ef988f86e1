"""Public wrappers around the KV-quantization kernels.

A CPU tensor goes through the plain version (``ref.py``), and so does a
meta tensor, which holds no data (the dry run counts a step's ops on meta
tensors, ``launch/dryrun.py``); any other tensor goes to the CUDA kernels,
which launch or raise — there is no fallback.
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

#: devices whose tensors take the plain versions
_PLAIN_DEVICES = ("cpu", "meta")


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, C) -> (int8 codes (T, C), per-channel scale (C,)), on x's device."""
    x = x.to(torch.float32)
    if x.device.type in _PLAIN_DEVICES:
        return _ref.quantize(x)
    scale = _ref.scale_from_absmax(_k.absmax(x))  # an IEEE divide, on the card
    return _k.quantize_with_scale(x, scale), scale


def kv_quantize_append(k: torch.Tensor, v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor, slot: torch.Tensor) -> None:
    """The int8 decode append of one attention layer: k and v (B, 1, KV, hd)
    quantized per (b, h) row into ring slot ``slot`` of the int8 caches
    (B, W, KV, hd) and their scales (B, W, KV), in place.  One launch on
    the card for K and V together; tensors on mixed devices go to the
    kernel's wrapper, which refuses them."""
    args = (k, v, k_cache, v_cache, k_scale, v_scale, slot)
    plain = any(all(t.device.type == d for t in args) for d in _PLAIN_DEVICES)
    fn = _ref.quantize_append if plain else _k.quantize_append
    fn(*args)


def kv_dequant_matmul(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ dequant(q (K, N), scale (N,)) -> (M, N) f32, on a's device."""
    fn = _ref.dequant_matmul if a.device.type in _PLAIN_DEVICES else _k.dequant_matmul
    return fn(a.to(torch.float32), q, scale)


def ref_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return _ref.quantize(x)


def ref_dequant_matmul(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _ref.dequant_matmul(a, q, scale)
