"""Public wrapper around the Huffman stream pack kernel.

A CPU tensor goes through the plain version (``ref.py``); any other tensor
goes to the CUDA kernel, which launches or raises — there is no fallback.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel as _k
from . import ref as _ref


def pack(values: torch.Tensor, table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Huffman stream of integer codes ``values`` (any shape, read flat)
    under ``table``, ``(code << 8) | length`` per value as int32: (payload
    uint8, sync int64 offsets every 1024 codes, total bits), on the codes'
    device.  int32 and int64 codes are read as they are; others are cast to
    int64 first."""
    if values.dtype not in (torch.int32, torch.int64):
        values = values.to(torch.int64)
    fn = _ref.pack if values.device.type == "cpu" else _k.pack
    return fn(values.reshape(-1).contiguous(), table.to(values.device, torch.int32).contiguous())
