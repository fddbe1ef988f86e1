"""Bind and launch the CUDA Lorenzo kernels (``csrc/lorenzo.cu``).

The source is built at first launch by :mod:`.._build` (``nvcc`` for
``sm_90a``, a plain C interface loaded with ``ctypes``, into ``build/``
beside this file).  Nothing is built or loaded at import.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch reports an error, and
adds one to its entry in :data:`LAUNCHES`.  The choice between a kernel and
its plain version (``ref.py``) is made in ``ops.py``, by the tensor's device.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, Tuple

import torch

from .._build import CudaLibrary, NVCC_FLAGS, check_launch, count_launch, reset_counts, stream  # noqa: F401  (NVCC_FLAGS re-exported)

_SRC = pathlib.Path(__file__).parent / "csrc" / "lorenzo.cu"

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "encode_1d": 0,
    "encode_2d": 0,
    "decode_1d": 0,
    "decode_2d": 0,
}

#: the grids launch at most this many blocks along x
_MAX_BLOCKS = (1 << 31) - 1
_TILE = 4096  # elements per decode_1d tile (kLbTile in the source)
_TILE_2D = (32, 128)  # decode_2d's tile (kT2Rows, kT2Cols)
_WARPS = 8  # warps per block (kThreads / 32)


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
    for name in ("lorenzo_encode_1d", "lorenzo_encode_2d"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i64, i64, f32, i32, p]
        fn.restype = ctypes.c_int
    lib.lorenzo_decode_1d.argtypes = [p, p, p, i64, i64, f32, i32, p]
    lib.lorenzo_decode_1d.restype = ctypes.c_int
    lib.lorenzo_decode_2d.argtypes = [p, p, p, i64, i64, f32, p]
    lib.lorenzo_decode_2d.restype = ctypes.c_int
    lib.lorenzo_decode_scratch_words.argtypes = [i64, i64, i32]
    lib.lorenzo_decode_scratch_words.restype = i64


LIBRARY = CudaLibrary(_SRC, "lorenzo", _declare)
build = LIBRARY.build
load = LIBRARY.load
library_path = LIBRARY.library_path


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> Tuple[int, int]:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.ndim != 2:
        raise ValueError(f"{what}: expected a 2-D (rows, cols) tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the tensor must be contiguous")
    rows, cols = t.shape
    tiles_r, tiles_c = -(-rows // _TILE_2D[0]), -(-cols // _TILE_2D[1])
    lines_2d = rows + cols + min(tiles_r, tiles_c)  # decode_2d's carries launch, a warp each
    grids = (rows * -(-cols // _TILE), -(-(rows * cols) // _TILE), tiles_r * tiles_c, -(-lines_2d // _WARPS))
    if max(grids) > _MAX_BLOCKS:
        raise ValueError(f"{what}: shape {tuple(t.shape)} exceeds the launch grid")
    return rows, cols


def _encode(name: str, x: torch.Tensor, eb: float, radius: int):
    rows, cols = _check(x, torch.float32, name)
    lib = load()
    codes = torch.empty((rows, cols), dtype=torch.int32, device=x.device)
    draw = torch.empty((rows, cols), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"lorenzo_{name}")(
            x.data_ptr(), codes.data_ptr(), draw.data_ptr(), rows, cols,
            # float64 on the host, rounded to float32 by ctypes, as the JAX
            # kernel's weak-typed Python float meets its float32 tile
            1.0 / (2.0 * float(eb)), int(radius), stream(),
        )
    check_launch(err, name)
    count_launch(LAUNCHES, name)
    return codes, draw


def _decode(name: str, d: torch.Tensor, eb: float) -> torch.Tensor:
    rows, cols = _check(d, torch.int32, name)
    lib = load()
    out = torch.empty((rows, cols), dtype=torch.float32, device=d.device)
    words = lib.lorenzo_decode_scratch_words(rows, cols, int(name == "decode_2d"))
    scratch = torch.empty(max(1, words), dtype=torch.int32, device=d.device)
    args = [d.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, cols, 2.0 * float(eb)]
    if name == "decode_1d":
        # int4 loads and float4 stores where every row's tiles start 16-byte aligned
        args.append(int((rows == 1 or cols % 4 == 0) and d.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0))
    with torch.cuda.device(d.device):
        err = getattr(lib, f"lorenzo_{name}")(*args, stream())
    check_launch(err, name)
    count_launch(LAUNCHES, name)
    return out


def encode_1d(x: torch.Tensor, eb: float, radius: int):
    """(R, C) float32 -> (codes, raw diffs) int32, row-independent stencil."""
    return _encode("encode_1d", x, eb, radius)


def encode_2d(x: torch.Tensor, eb: float, radius: int):
    """(R, C) float32 -> (codes, raw diffs) int32, 2-D Lorenzo stencil."""
    return _encode("encode_2d", x, eb, radius)


def decode_1d(d: torch.Tensor, eb: float) -> torch.Tensor:
    """(R, C) int32 raw diffs -> float32, prefix sums along each row."""
    return _decode("decode_1d", d, eb)


def decode_2d(d: torch.Tensor, eb: float) -> torch.Tensor:
    """(R, C) int32 raw diffs -> float32, prefix sums along rows then columns."""
    return _decode("decode_2d", d, eb)
