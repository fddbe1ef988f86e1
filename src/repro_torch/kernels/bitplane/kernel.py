"""Bind and launch the CUDA bitplane transpose (``csrc/bitplane.cu``).

The source is built at first launch by :mod:`.._build` (``nvcc`` for
``sm_90a``, a plain C interface loaded with ``ctypes``, into ``build/``
beside this file).  Nothing is built or loaded at import.

Each wrapper takes a CUDA tensor only, checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch reports an error, and
adds one to its entry in :data:`LAUNCHES`.  Any R is taken (the kernel
guards its tail); ``ops.py`` pads to the JAX package's 512-group tiles.
An ``encode`` input that is not 16-byte aligned (a view at a storage
offset) takes the kernel's 4-byte accesses; the planes may lie at any
offset.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict

import torch

from .._build import CudaLibrary, check_launch, count_launch, reset_counts, stream

_SRC = pathlib.Path(__file__).parent / "csrc" / "bitplane.cu"

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"encode": 0, "decode": 0}


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    for name in ("bitplane_encode", "bitplane_decode"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, ctypes.c_int64, p]
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(_SRC, "bitplane", _declare)
build = LIBRARY.build
load = LIBRARY.load
library_path = LIBRARY.library_path


def _check(t: torch.Tensor, what: str, shape_ok: bool) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"bitplane {what}: the CUDA kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != torch.uint32:
        raise ValueError(f"bitplane {what}: expected torch.uint32, got {t.dtype}")
    if not shape_ok:
        raise ValueError(f"bitplane {what}: bad shape {tuple(t.shape)}")
    return t.contiguous()


def _launch(entry: str, what: str, src: torch.Tensor, out: torch.Tensor, R: int) -> torch.Tensor:
    if R == 0:  # nothing to transpose: no launch
        return out
    lib = load()
    with torch.cuda.device(src.device):
        err = getattr(lib, entry)(src.data_ptr(), out.data_ptr(), R, stream())
    check_launch(err, f"bitplane {what}")
    count_launch(LAUNCHES, what)
    return out


def encode(v: torch.Tensor) -> torch.Tensor:
    """(R, 32) uint32 -> (32, R) uint32 plane words."""
    v = _check(v, "encode", v.ndim == 2 and v.shape[1] == 32)
    R = v.shape[0]
    out = torch.empty((32, R), dtype=torch.uint32, device=v.device)
    return _launch("bitplane_encode", "encode", v, out, R)


def decode(w: torch.Tensor) -> torch.Tensor:
    """(32, R) uint32 plane words -> (R, 32) uint32 values."""
    w = _check(w, "decode", w.ndim == 2 and w.shape[0] == 32)
    R = w.shape[1]
    out = torch.empty((R, 32), dtype=torch.uint32, device=w.device)
    return _launch("bitplane_decode", "decode", w, out, R)
