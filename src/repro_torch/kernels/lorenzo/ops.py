"""Public wrappers around the fused Lorenzo kernels.

A CPU tensor goes through the plain torch version (``ref.py``); any other
tensor goes to the CUDA kernel, which launches or raises — there is no
fallback.  The CUDA kernels mask their own ragged edges, so unlike the JAX
package's wrappers nothing is padded to tile multiples.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import kernel as _k
from . import ref as _ref

#: guard for the BOUND-EXACT pipeline route (predictors.LorenzoPredictor):
#: beyond int32 range safety, prequantized magnitudes must stay small enough
#: that float32 kernel arithmetic cannot round reconstructions past the error
#: bound before the verification patches the stragglers.
PIPELINE_SAFE = float(1 << 22)

_MODES = ("1d", "2d")


def _pick(mode: str, t: torch.Tensor, ref_fns, kernel_fns):
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    fns = ref_fns if t.device.type == "cpu" else kernel_fns
    return fns[_MODES.index(mode)]


def lorenzo_encode(
    x: torch.Tensor, *, eb: float, radius: int = 32768, mode: str = "2d"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused prequant+Lorenzo encode of a 2-D float32 tensor.  Returns
    (codes, raw_diffs), both int32.  mode: "1d" (row-independent) | "2d"."""
    if x.ndim != 2:
        raise ValueError("reshape to 2-D before calling (rows, fastest-axis)")
    fn = _pick(mode, x, (_ref.encode_1d, _ref.encode_2d), (_k.encode_1d, _k.encode_2d))
    return fn(x.contiguous(), float(eb), int(radius))


def lorenzo_decode(d: torch.Tensor, *, eb: float, mode: str = "2d") -> torch.Tensor:
    """Inverse (prefix sums) + dequant.  ``d`` holds the raw diffs with
    unpredictable positions already substituted."""
    if d.ndim != 2:
        raise ValueError("reshape to 2-D before calling (rows, fastest-axis)")
    fn = _pick(mode, d, (_ref.decode_1d, _ref.decode_2d), (_k.decode_1d, _k.decode_2d))
    return fn(d.contiguous(), float(eb))


def encode_pipeline(
    x: torch.Tensor, *, eb: float, radius: int = 32768
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused prequant+Lorenzo encode for the pipeline.

    Accepts 1-D (one ``(1, N)`` row, "1d" stencil) or 2-D ("2d" stencil)
    float32 and returns (codes, raw_diffs) int32 in the input's shape, on the
    input's device.  Callers are responsible for the PIPELINE_SAFE guard and
    for verifying/patching reconstruction against the error bound
    (predictors.LorenzoPredictor).
    """
    mode = "2d" if x.ndim == 2 else "1d"
    codes, draw = lorenzo_encode(
        x.reshape(x.shape if x.ndim == 2 else (1, -1)).to(torch.float32),
        eb=eb, radius=radius, mode=mode,
    )
    return codes.reshape(x.shape), draw.reshape(x.shape)


def decode_pipeline(d: torch.Tensor, *, eb: float) -> torch.Tensor:
    """Inverse of :func:`encode_pipeline`: 1-D or 2-D int32 raw diffs (with
    unpredictable positions already substituted) -> float32."""
    mode = "2d" if d.ndim == 2 else "1d"
    d2 = d.reshape(d.shape if d.ndim == 2 else (1, -1)).to(torch.int32)
    return lorenzo_decode(d2, eb=eb, mode=mode).reshape(d.shape)


def _tensor(a, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def ref_encode(x, eb, radius=32768, mode="2d"):
    """The plain version of the encode kernels, on ``x``'s device."""
    fn = _ref.encode_1d if mode == "1d" else _ref.encode_2d
    return fn(_tensor(x, torch.float32), eb, radius)


def ref_decode(d, eb, mode="2d"):
    """The plain version of the decode kernels, on ``d``'s device."""
    fn = _ref.decode_1d if mode == "1d" else _ref.decode_2d
    return fn(_tensor(d, torch.int32), eb)
