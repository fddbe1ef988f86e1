"""Public wrappers around the bitplane transpose, with the JAX package's
``repro.kernels.bitplane.ops`` contract.

``bitplane_encode`` pads the flat values with zeros to a multiple of
32 x 512 (the TPU kernel's tile), so the output is (32, R) with R a
multiple of 512; an empty input still gives one (32, 512) tile of zeros.
``bitplane_decode`` crops back to n values.  ``ref_encode``/``ref_decode``
pad to 32 only.  A CPU tensor goes through the plain version (``ref.py``);
any other tensor goes to the CUDA kernel, which launches or raises — there
is no fallback.
"""
from __future__ import annotations

import torch

from . import kernel as _k
from . import ref as _ref

#: groups of 32 values per TPU tile; the padding unit of the public API
TILE_GROUPS = 512


def _padded_groups(vals: torch.Tensor, unit: int) -> torch.Tensor:
    """Flat values as (R, 32) uint32, zero-padded to ``unit`` values."""
    flat = _ref.as_u32(vals.reshape(-1)).view(torch.int32)
    n = flat.numel()
    pad = (-n) % unit or (unit if n == 0 and unit > 32 else 0)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(torch.uint32).reshape(-1, 32)


def _pick(t: torch.Tensor, plain, kernel):
    return plain if t.device.type == "cpu" else kernel


def bitplane_encode(vals: torch.Tensor) -> torch.Tensor:
    """Flat integer values -> (32, R) uint32 plane words (plane p = row p),
    R a multiple of 512."""
    v = _padded_groups(vals, 32 * TILE_GROUPS)
    return _pick(v, _ref.encode, _k.encode)(v)


def bitplane_decode(words: torch.Tensor, n: int) -> torch.Tensor:
    """(32, R) plane words -> the first ``n`` uint32 values."""
    return _pick(words, _ref.decode, _k.decode)(words).reshape(-1)[:n]


def ref_encode(vals: torch.Tensor) -> torch.Tensor:
    """The plain version on any device, padded to 32 values only."""
    return _ref.encode(_padded_groups(vals, 32))


def ref_decode(words: torch.Tensor, n: int) -> torch.Tensor:
    return _ref.decode(words).reshape(-1)[:n]
