"""Public wrapper around the fast tier's classify+reduce kernel.

A CPU tensor goes through the plain version (``ref.py``); any other tensor
goes to the CUDA kernel, which launches or raises — there is no fallback.
The kernel takes any number of blocks, so nothing is padded to tile
multiples.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel as _k
from . import ref as _ref

VALID_BS = _ref.VALID_BS


def block_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block (mean, max |x - mean|) of an (nb, bs) float32 tensor, on its
    device."""
    fn = _ref.block_stats if x.device.type == "cpu" else _k.block_stats
    return fn(x)
