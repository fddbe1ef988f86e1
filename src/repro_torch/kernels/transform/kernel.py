"""Bind and launch the CUDA transform kernels (``csrc/transform.cu``).

The source is built at first launch by :mod:`.._build` (``nvcc`` for
``sm_90a``, a plain C interface loaded with ``ctypes``, into ``build/``
beside this file).  Nothing is built or loaded at import.

Each wrapper takes CUDA tensors only, checks device, dtype, shape,
contiguity and alignment, allocates its output with ``torch.empty``,
launches on ``torch.cuda.current_stream()``, raises if the launch reports an
error, and adds one to its entry in :data:`LAUNCHES`.  The choice between a
kernel and its plain version (``ref.py``) is made in ``ops.py``, by the
tensor's device.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict

import numpy as np
import torch

from .._build import CudaLibrary, check_launch, count_launch, reset_counts, stream
from . import ref as _ref

_SRC = pathlib.Path(__file__).parent / "csrc" / "transform.cu"

#: kernel launches per wrapper and mode since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "fwd_1d": 0,
    "fwd_2d": 0,
    "inv_1d": 0,
    "inv_2d": 0,
    "axis_f64": 0,
}

_MODES = ("1d", "2d")
_FWD = np.ascontiguousarray(_ref.MAT, np.float32)
_INV = np.ascontiguousarray(_ref.MAT.T, np.float32)


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.transform_rotate.argtypes = [p, p, i64, i64, p, i32, i32, i32, p]
    lib.transform_rotate.restype = ctypes.c_int
    lib.transform_axis_f64.argtypes = [p, p, i64, i64, i64, p, i32, p]
    lib.transform_axis_f64.restype = ctypes.c_int


LIBRARY = CudaLibrary(_SRC, "transform", _declare)
build = LIBRARY.build
load = LIBRARY.load
library_path = LIBRARY.library_path


def _check(t: torch.Tensor, dtypes, what: str) -> torch.Tensor:
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: expected one of {dtypes}, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got {t.device}")
    t = t.contiguous()
    if t.data_ptr() % 16:  # 16-byte vector loads need 16-byte alignment
        t = t.clone()
    return t


def _rotate(name: str, x: torch.Tensor, mat: np.ndarray, mode: str, out_dtype: torch.dtype) -> torch.Tensor:
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    what = f"{name}_{mode}"
    _ref.check_dtypes(x.dtype, out_dtype, what)
    x = _check(x, _ref.DTYPES, what)
    if x.ndim != 2 or x.shape[1] % 4 or (mode == "2d" and x.shape[0] % 4):
        raise ValueError(f"{what}: shape {tuple(x.shape)} is not a whole number of blocks")
    rows, cols = x.shape
    lib = load()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.transform_rotate(
            x.data_ptr(), out.data_ptr(), rows, cols, mat.ctypes.data, int(mode == "2d"),
            int(x.dtype == torch.float64), int(out_dtype == torch.float64), stream(),
        )
    check_launch(err, what)
    count_launch(LAUNCHES, what)
    return out


def fwd(x: torch.Tensor, mode: str = "2d", out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(R, C) float32 or float64, transformed axes multiples of 4 ->
    coefficients, computed in float32 (a float64 input is rounded to float32
    on load), written as ``out_dtype`` (float32 or float64)."""
    return _rotate("fwd", x, _FWD, mode, out_dtype)


def inv(c: torch.Tensor, mode: str = "2d", out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse rotation (MAT^T) of a coefficient grid, as :func:`fwd`."""
    return _rotate("inv", c, _INV, mode, out_dtype)


def axis_f64(x: torch.Tensor, m: np.ndarray, ax: int) -> torch.Tensor:
    """``m`` (4x4 float64) applied along axis ``ax`` of a float64 tensor,
    each output rounded in the order this machine's numpy uses for that
    axis pattern and matrix (:func:`ref.numpy_rounding`, one of
    :data:`ref.ORDERS`, see ``csrc/transform.cu``); an error where numpy
    uses none of them."""
    x = _check(x, (torch.float64,), "axis_f64")
    if not 0 <= ax < x.ndim or x.shape[ax] % 4:
        raise ValueError(f"axis_f64: axis {ax} of {tuple(x.shape)} is not a whole number of blocks")
    order = _ref.numpy_rounding(tuple(x.shape), ax, m)
    if order is None:
        raise RuntimeError(
            f"axis_f64: numpy here rounds the float64 product along axis {ax} of "
            f"{tuple(x.shape)} in none of the kernel's orders {_ref.ORDERS}; the card "
            "cannot verify what the JAX package's host inverse decodes"
        )
    shape = x.shape
    outer = int(np.prod(shape[:ax], dtype=np.int64))
    inner = int(np.prod(shape[ax + 1:], dtype=np.int64))
    mat = np.ascontiguousarray(m, np.float64)
    lib = load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.transform_axis_f64(
            x.data_ptr(), out.data_ptr(), outer, shape[ax], inner, mat.ctypes.data,
            _ref.ORDERS.index(order), stream(),
        )
    check_launch(err, "axis_f64")
    count_launch(LAUNCHES, "axis_f64")
    return out
