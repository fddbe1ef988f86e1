"""Plain PyTorch version of the Huffman stream pack kernel.

It repeats the kernel's function with ordinary torch ops.  The wrapper runs
it for tensors on the CPU, the tests hold it byte for byte against the
host coder's ``_encode_stream`` (``repro_torch.core.encoders``), and the
chip smoke test holds the CUDA kernel against it.

Contract: ``values`` are n integer codes and ``table`` holds, for every
value v in ``[0, table.numel())``, ``(code << 8) | length`` with the
canonical code in the top bits and its length (1 to 16) in the low byte;
length 0 marks a value outside the alphabet.  Code i is written MSB first
at bit offset ``o_i = length_0 + ... + length_{i-1}`` of the stream, bit 0
being the MSB of byte 0, and the stream is ``ceil(o_n / 8)`` bytes.  The
sync table holds ``o_{1024 s}`` for every segment s of 1024 codes.  A value
outside the table, or one of length 0, raises ``ValueError``.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: codes per sync point (encoders._SYNC)
SYNC = 1024
OUTSIDE = "symbol outside Huffman alphabet"


def pack(values: torch.Tensor, table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(payload uint8, sync int64, total bits) of ``values`` coded by ``table``."""
    v = values.reshape(-1).to(torch.int64)
    n = v.numel()
    if n == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=v.device),
                torch.zeros(0, dtype=torch.int64, device=v.device), 0)
    if int(v.min()) < 0 or int(v.max()) >= table.numel():
        raise ValueError(OUTSIDE)
    entry = table.to(torch.int64)[v]
    lens = entry & 0xFF
    if bool(((lens == 0) | (lens > 16)).any()):
        raise ValueError(OUTSIDE)
    codes = entry >> 8
    ends = torch.cumsum(lens, 0)
    starts = ends - lens
    total = int(ends[-1])
    # 32-bit words held in int64, so no shift meets a sign bit; the bits of
    # codes sharing a word are disjoint, so their sum is their OR
    words = torch.zeros(((total + 31) >> 5) + 1, dtype=torch.int64, device=v.device)
    widx = starts >> 5
    rsh = 32 - (starts & 31) - lens  # in [-15, 31]
    words.index_add_(0, widx, torch.where(rsh >= 0, codes << rsh.clamp(min=0), codes >> (-rsh).clamp(min=0)))
    spill = rsh < 0
    words.index_add_(0, widx[spill] + 1, (codes[spill] << (32 + rsh[spill])) & 0xFFFFFFFF)
    stream = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)], 1).to(torch.uint8).reshape(-1)
    return stream[: (total + 7) >> 3], starts[::SYNC].clone(), total
