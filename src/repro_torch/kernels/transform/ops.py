"""Public wrappers around the blockwise transform kernels.

A CPU tensor goes through the plain version (``ref.py``); any other tensor
goes to the CUDA kernel, which launches or raises — there is no fallback.
The CUDA kernels take any whole number of 4-blocks, so unlike the JAX
package's wrappers nothing is padded to tile multiples.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernel as _k
from . import ref as _ref

AMP_1AXIS = _ref.AMP_1AXIS
MAT = _ref.MAT


def transform_fwd(x: torch.Tensor, *, mode: str = "2d") -> torch.Tensor:
    """(R, C) float32, transformed axes multiples of 4 -> coefficient grid."""
    fn = _ref.fwd if x.device.type == "cpu" else _k.fwd
    return fn(x, mode=mode)


def transform_inv(c: torch.Tensor, *, mode: str = "2d") -> torch.Tensor:
    fn = _ref.inv if c.device.type == "cpu" else _k.inv
    return fn(c, mode=mode)


def _as_rows(t: torch.Tensor):
    """1-D data runs as one (1, N) row in "1d" mode, 2-D data in "2d" mode."""
    if t.ndim == 2:
        return t, "2d"
    return t.reshape(1, -1), "1d"


def fwd_pipeline(x: torch.Tensor) -> torch.Tensor:
    """Forward float32 transform for the coder: 1-D or 2-D, already padded
    to multiples of 4 along the transformed axes (``core/transform.py`` owns
    the edge padding), on the input's device."""
    x2, mode = _as_rows(x.to(torch.float32))
    return transform_fwd(x2, mode=mode).reshape(x.shape)


def inv_pipeline(c: torch.Tensor) -> torch.Tensor:
    """Inverse float32 transform for the coder (1-D or 2-D)."""
    c2, mode = _as_rows(c.to(torch.float32))
    return transform_inv(c2, mode=mode).reshape(c.shape)


def apply_axis_f64(x: torch.Tensor, m: np.ndarray, ax: int) -> torch.Tensor:
    """``m`` applied along axis ``ax`` of a float64 tensor, rounded as this
    machine's numpy rounds it.  CPU tensors run numpy itself; CUDA tensors
    run the float64 kernel in numpy's order for that axis pattern and
    matrix (:func:`ref.numpy_rounding`), and raise where numpy's order is
    none of the kernel's."""
    fn = _ref.apply_axis_f64 if x.device.type == "cpu" else _k.axis_f64
    return fn(x, m, ax)
