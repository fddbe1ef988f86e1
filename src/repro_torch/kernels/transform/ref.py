"""Plain versions of the blockwise transform kernels, and the shared basis.

``MAT`` is the orthonormal 4-point DCT-II basis (rows = frequencies) that
the coder (``core/transform.py``), the CUDA kernels and these plain versions
all share, so the error-bound analysis (the L_inf amplification of ``MAT^T``)
holds on every route.  It is pure numpy, identical to the JAX package's.

``fwd``/``inv`` repeat the float32 kernels' arithmetic with ordinary torch
ops: each output is ``((m0*b0 + m1*b1) + m2*b2) + m3*b3`` in float32 with
``MAT`` rounded to float32, last axis first, then the rows.  Separate torch
multiplies and adds round once each on CPU and CUDA, as ``__fmul_rn`` and
``__fadd_rn`` do, so the kernels equal these bit for bit.  They differ from
the JAX package's float32 kernel, which XLA reassociates, within rounding.

``apply_axis_f64`` is the plain version of the float64 axis kernel: the JAX
package's numpy product itself, so the host route matches it byte for byte.
How numpy rounds that product depends on the axis pattern and on numpy's
build.  numpy 2.3 with scipy-openblas rounds an axis longer than 4 as an FMA
chain (BLAS dgemm along the last axis, numpy's own loop along the others;
numpy 2.0's own loop rounds separate multiplies and adds instead).  An axis
of exactly 4 goes to BLAS dgemv, which sums in pairs for ``MAT`` and
rounds the first pair before an FMA chain for ``MAT^T``.  The kernel
implements each order in :data:`ORDERS`; :func:`numpy_rounding` finds,
once per axis pattern and matrix, which of them this machine's numpy uses,
by computing every candidate exactly.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

BLOCK = 4

MAT = np.array(
    [
        [
            (np.sqrt(1.0 / 4.0) if k == 0 else np.sqrt(2.0 / 4.0))
            * np.cos(np.pi * (2 * j + 1) * k / 8.0)
            for j in range(4)
        ]
        for k in range(4)
    ],
    np.float64,
)

#: L_inf error amplification of the 1-axis inverse: max_i sum_k |MAT[k, i]|
AMP_1AXIS = float(np.abs(MAT).sum(axis=0).max())

#: the float32 kernels' constants: forward MAT and inverse MAT^T, rounded on
#: the host, as Python floats (exact float32 values)
FWD_F32 = MAT.astype(np.float32).astype(np.float64).tolist()
INV_F32 = MAT.T.astype(np.float32).astype(np.float64).tolist()


def _rotate(b: List[torch.Tensor], m) -> List[torch.Tensor]:
    return [((b[0] * m[k][0] + b[1] * m[k][1]) + b[2] * m[k][2]) + b[3] * m[k][3] for k in range(4)]


def _call(x: torch.Tensor, m, mode: str) -> torch.Tensor:
    if x.ndim != 2 or x.shape[1] % BLOCK or (mode == "2d" and x.shape[0] % BLOCK):
        raise ValueError(f"transform: shape {tuple(x.shape)} is not a whole number of blocks for {mode!r}")
    rows, cols = x.shape
    v = x.to(torch.float32).reshape(rows, cols // BLOCK, BLOCK)
    t = torch.stack(_rotate([v[..., j] for j in range(4)], m), dim=-1).reshape(rows, cols)
    if mode == "2d":
        v = t.reshape(rows // BLOCK, BLOCK, cols)
        t = torch.stack(_rotate([v[:, j] for j in range(4)], m), dim=1).reshape(rows, cols)
    return t


def fwd(x: torch.Tensor, mode: str = "2d") -> torch.Tensor:
    """(R, C) float32 with the transformed axes multiples of 4 -> coefficients."""
    return _call(x, FWD_F32, mode)


def inv(c: torch.Tensor, mode: str = "2d") -> torch.Tensor:
    """Inverse rotation (MAT^T)."""
    return _call(c, INV_F32, mode)


def apply_axis_f64(x: torch.Tensor, m: np.ndarray, ax: int) -> torch.Tensor:
    """``m`` applied along axis ``ax`` of a float64 CPU tensor, in numpy."""
    xm = np.moveaxis(x.numpy(), ax, -1)
    shp = xm.shape
    b = xm.reshape(shp[:-1] + (shp[-1] // BLOCK, BLOCK))
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis((b @ m.T).reshape(shp), -1, ax)))


#: the float64 orders the axis kernel implements, by its ``order`` argument;
#: for each output k, with p_j = m[k, j] * b[j] and fma(p, c) = p + c
#: rounded once:
#:   fma_chain  fma(p3, fma(p2, fma(p1, p0)))
#:   pairs      (p0 + p2) + (p1 + p3)
#:   pair_fma   fma(p3, fma(p2, p0 + p1))
ORDERS = ("fma_chain", "pairs", "pair_fma")

#: float64 outputs a probe compares with numpy before it names an order
_PROBE_OUTPUTS = 512


def _fma(p, c: float) -> float:
    """The exact product ``p`` (numerator, denominator) plus ``c``, rounded
    once: exact dyadic integers, then Python's correctly rounded integer
    division."""
    cn, cd = c.as_integer_ratio()
    return (p[0] * cd + cn * p[1]) / (p[1] * cd)


def _rounded(p) -> float:
    return p[0] / p[1]


def _exact_dot(order: str, p) -> float:
    if order == "fma_chain":
        return _fma(p[3], _fma(p[2], _fma(p[1], _rounded(p[0]))))
    if order == "pairs":
        return (_rounded(p[0]) + _rounded(p[2])) + (_rounded(p[1]) + _rounded(p[3]))
    return _fma(p[3], _fma(p[2], _rounded(p[0]) + _rounded(p[1])))


def numpy_rounding(shape, ax: int, m: np.ndarray) -> Optional[str]:
    """Which of :data:`ORDERS` this machine's numpy uses for
    :func:`apply_axis_f64` of ``m`` along axis ``ax`` of an array of
    ``shape``, or None for none of them.  The probe runs numpy on random
    arrays of the same axis pattern (the same rank and axis, the axis as
    long up to 256, the other dimensions cut to at most 2) and is cached
    per pattern and matrix.  The matrix's memory order counts: numpy hands
    BLAS a transposed view, and dgemv sums in another order for each."""
    n = shape[ax]
    probe = tuple(min(n, 256) if i == ax else min(d, 2) for i, d in enumerate(shape))
    fortran = bool(m.flags.f_contiguous and not m.flags.c_contiguous)
    return _probe(probe, ax, np.ascontiguousarray(m, np.float64).tobytes(), fortran)


@functools.lru_cache(maxsize=None)
def _probe(shape, ax: int, mbytes: bytes, fortran: bool) -> Optional[str]:
    if 0 in shape:  # nothing to round
        return ORDERS[0]
    m = np.frombuffer(mbytes, np.float64).reshape(BLOCK, BLOCK)
    m = np.asfortranarray(m) if fortran else m
    rng = np.random.default_rng(12)
    alive = list(ORDERS)
    seen = 0
    while alive and seen < _PROBE_OUTPUTS:
        x = rng.normal(size=shape) * 100
        got = np.moveaxis(apply_axis_f64(torch.from_numpy(x), m, ax).numpy(), ax, -1).reshape(-1, BLOCK)
        b = np.moveaxis(x, ax, -1).reshape(-1, BLOCK)
        for row, out in zip(b.tolist(), got.tolist()):
            for k in range(BLOCK):
                p = []
                for j in range(BLOCK):
                    an, ad = float(m[k, j]).as_integer_ratio()
                    bn, bd = row[j].as_integer_ratio()
                    p.append((an * bn, ad * bd))
                alive = [o for o in alive if _exact_dot(o, p) == out[k]]
        seen += got.size
    return alive[0] if alive else None
