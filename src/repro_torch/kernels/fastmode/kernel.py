"""Bind and launch the CUDA classify+reduce kernel (``csrc/fastmode.cu``).

The source is built at first launch by :mod:`.._build` (``nvcc`` for
``sm_90a``, a plain C interface loaded with ``ctypes``, into ``build/``
beside this file).  Nothing is built or loaded at import.

The wrapper takes a CUDA tensor only, checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch reports an error, and
adds one to :data:`LAUNCHES`.  The choice between the kernel and its plain
version (``ref.py``) is made in ``ops.py``, by the tensor's device.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, Tuple

import torch

from .._build import CudaLibrary, check_launch, count_launch, reset_counts, stream
from .ref import VALID_BS

_SRC = pathlib.Path(__file__).parent / "csrc" / "fastmode.cu"

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"block_stats": 0}


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.fastmode_block_stats.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_int, p]
    lib.fastmode_block_stats.restype = ctypes.c_int


LIBRARY = CudaLibrary(_SRC, "fastmode", _declare)
build = LIBRARY.build
load = LIBRARY.load
library_path = LIBRARY.library_path


def block_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nb, bs) float32, bs in {128, 256} -> (means (nb,), devs (nb,))."""
    if x.device.type != "cuda":
        raise ValueError(f"block_stats: the CUDA kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"block_stats: expected torch.float32, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] not in VALID_BS:
        raise ValueError(f"block_stats: expected (nb, 128 or 256), got {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # float4 loads need 16-byte alignment
        x = x.clone()
    nb, bs = x.shape
    lib = load()
    means = torch.empty(nb, dtype=torch.float32, device=x.device)
    devs = torch.empty(nb, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fastmode_block_stats(
            x.data_ptr(), means.data_ptr(), devs.data_ptr(), nb, bs, stream()
        )
    check_launch(err, "block_stats")
    count_launch(LAUNCHES, "block_stats")
    return means, devs
