"""Bind and launch the CUDA Huffman stream pack (``csrc/huffman.cu``).

The source is built at first launch by :mod:`.._build` (``nvcc`` for
``sm_90a``, a plain C interface loaded with ``ctypes``, into ``build/``
beside this file).  Nothing is built or loaded at import.

The wrapper takes CUDA tensors only, checks device, dtype and contiguity,
allocates the stream and the scratch with ``torch.empty`` (the C entry point
zeroes both on the stream), launches on ``torch.cuda.current_stream()``,
raises if the launch reports an error, reads the stream's bit count and the
fault flag back (one 16-byte copy, which waits for the kernel), raises
``ValueError`` on a fault, and adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, Tuple

import torch

from .._build import CudaLibrary, check_launch, count_launch, reset_counts, stream
from .ref import OUTSIDE, SYNC

_SRC = pathlib.Path(__file__).parent / "csrc" / "huffman.cu"

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"pack": 0}


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.huffman_pack.argtypes = [p, i32, i64, p, i64, p, i64, p, p, p]
    lib.huffman_pack.restype = ctypes.c_int
    lib.huffman_pack_scratch_words.argtypes = [i64]
    lib.huffman_pack_scratch_words.restype = i64


LIBRARY = CudaLibrary(_SRC, "huffman", _declare)
build = LIBRARY.build
load = LIBRARY.load
library_path = LIBRARY.library_path


def pack(values: torch.Tensor, table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """1-D int32 or int64 codes and an int32 ``(code << 8) | length`` table
    on the card -> (payload uint8, sync int64, total bits), as ``ref.pack``."""
    for t, what, dtypes in ((values, "values", (torch.int32, torch.int64)), (table, "table", (torch.int32,))):
        if t.device.type != "cuda":
            raise ValueError(f"huffman pack: the CUDA kernel needs CUDA {what}, got {t.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"huffman pack: {what} must be {dtypes}, got {t.dtype}")
        if t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"huffman pack: {what} must be 1-D and contiguous, got {tuple(t.shape)}")
    if table.device != values.device:
        raise ValueError(f"huffman pack: table on {table.device}, values on {values.device}")
    dev = values.device
    n = values.numel()
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev), torch.zeros(0, dtype=torch.int64, device=dev), 0
    lib = load()
    n_words = -(-n // 4)  # 16 bits a code at most
    words = torch.empty(n_words, dtype=torch.int64, device=dev)
    sync = torch.empty(-(-n // SYNC), dtype=torch.int64, device=dev)
    scratch = torch.empty(lib.huffman_pack_scratch_words(n), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.huffman_pack(
            values.data_ptr(), values.element_size(), n, table.data_ptr(), table.numel(),
            words.data_ptr(), n_words, sync.data_ptr(), scratch.data_ptr(), stream(),
        )
    check_launch(err, "huffman pack")
    count_launch(LAUNCHES, "pack")
    total, fault = scratch[-4:-2].tolist()
    if fault:
        raise ValueError(OUTSIDE)
    return words.view(torch.uint8)[: (total + 7) >> 3], sync, total
