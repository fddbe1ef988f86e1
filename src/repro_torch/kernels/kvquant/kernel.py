"""Bind and launch the CUDA KV-quantization kernels (``csrc/kvquant.cu``).

The source is built at first launch by :mod:`.._build` (``nvcc`` for
``sm_90a``, a plain C interface loaded with ``ctypes``, into ``build/``
beside this file).  Nothing is built or loaded at import.  The matmul runs
on the tensor cores (``wgmma``, bf16) with ``a`` split into three exact
bf16 parts; :func:`.ref.split_bf16x3` states that split and
:func:`.ref.tensor_core_dequant_matmul` the card's accumulation.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs (and the matmul's split-K workspace)
with ``torch.empty``, launches on ``torch.cuda.current_stream()``, raises
if the launch reports an error, and adds one to its entry in
:data:`LAUNCHES`.  :func:`quantize_append` allocates nothing: it writes
into the cache tensors it is given.  The choice between the kernels and
their plain versions (``ref.py``) is made in ``ops.py``, by the tensors'
device.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Dict, Tuple

import torch

from .._build import CudaLibrary, check_launch, count_launch, reset_counts, stream

_SRC = pathlib.Path(__file__).parent / "csrc" / "kvquant.cu"

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"absmax": 0, "quantize_with_scale": 0, "dequant_matmul": 0, "quantize_append": 0}

#: the matmul's output tile and K step (``TC_BM``/``TC_BN``/``TC_BK``)
_TILE, _BK = 128, 64
#: split K until about this many blocks are in flight: one wave of one
#: block per SM of an H100 (a block holds 209 KB of shared memory)
_TARGET_BLOCKS = 132
#: the absmax kernel's rows per block (``AM_BAND``); the grid's y dimension
#: holds at most 65535 bands
_AM_BAND = 512


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.kvquant_absmax.argtypes = [p, p, i64, i64, p]
    lib.kvquant_absmax.restype = i32
    lib.kvquant_quantize.argtypes = [p, p, p, i64, i64, i32, p]
    lib.kvquant_quantize.restype = i32
    lib.kvquant_dequant_matmul.argtypes = [p, p, p, p, p, i64, i64, i64, i64, i32, i32, i32, p]
    lib.kvquant_dequant_matmul.restype = i32
    lib.kvquant_append.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i32, i32, p]
    lib.kvquant_append.restype = i32


LIBRARY = CudaLibrary(_SRC, "kvquant", _declare)
build = LIBRARY.build
load = LIBRARY.load
library_path = LIBRARY.library_path


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> torch.Tensor:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim or 0 in t.shape:
        raise ValueError(f"{name}: expected a non-empty {ndim}-D tensor, got {tuple(t.shape)}")
    return t.contiguous()


def absmax(x: torch.Tensor) -> torch.Tensor:
    """(T, C) float32 -> per-column max |x|, (C,) float32; NaN propagates."""
    x = _check("absmax", x, torch.float32, 2)
    T, C = x.shape
    if _cdiv(T, _AM_BAND) > 65535:
        raise ValueError(f"absmax: {T} rows exceed the kernel's grid ({65535 * _AM_BAND})")
    lib = load()
    bits = torch.zeros(C, dtype=torch.int32, device=x.device)  # +0.0f
    with torch.cuda.device(x.device):
        err = lib.kvquant_absmax(x.data_ptr(), bits.data_ptr(), T, C, stream())
    check_launch(err, "absmax")
    count_launch(LAUNCHES, "absmax")
    return bits.view(torch.float32)


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(T, C) float32 and per-column scale (C,) -> int8 codes (T, C)."""
    x = _check("quantize_with_scale", x, torch.float32, 2)
    scale = _check("quantize_with_scale", scale, torch.float32, 1)
    T, C = x.shape
    if scale.shape[0] != C or scale.device != x.device:
        raise ValueError(f"quantize_with_scale: scale {tuple(scale.shape)} on {scale.device} "
                         f"does not fit x {tuple(x.shape)} on {x.device}")
    q = torch.empty((T, C), dtype=torch.int8, device=x.device)
    vec = int(C % 4 == 0 and x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0 and q.data_ptr() % 4 == 0)
    lib = load()
    with torch.cuda.device(x.device):
        err = lib.kvquant_quantize(x.data_ptr(), scale.data_ptr(), q.data_ptr(), T, C, vec, stream())
    check_launch(err, "quantize_with_scale")
    count_launch(LAUNCHES, "quantize_with_scale")
    return q


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(M: int, K: int, N: int) -> Tuple[int, int]:
    """(kchunk, splits): split K while the output tiles alone leave the card
    idle, without a second wave, each split at least 256 deep and a whole
    number of K steps."""
    tiles = _cdiv(M, _TILE) * _cdiv(N, _TILE)
    splits = max(1, min(_TARGET_BLOCKS // tiles, K // 256))
    kchunk = _cdiv(_cdiv(K, splits), _BK) * _BK
    return kchunk, _cdiv(K, kchunk)


def dequant_matmul(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """a (M, K) float32 @ (q (K, N) int8 as float32) * scale (N,) -> (M, N)
    float32 on the tensor cores: a split exactly into three bf16 parts,
    products exact, summed by the tensor cores' truncating float32
    accumulator and promoted into a float32 sum every 128 of K (no TF32
    rounding of a).  The
    cp.async variant takes K % 4 == 0, N % 16 == 0 and 16-byte aligned
    a and q; other shapes take the element-wise loads of the same kernel."""
    a = _check("dequant_matmul", a, torch.float32, 2)
    q = _check("dequant_matmul", q, torch.int8, 2)
    scale = _check("dequant_matmul", scale, torch.float32, 1)
    M, K = a.shape
    K2, N = q.shape
    if K2 != K or scale.shape[0] != N or not (a.device == q.device == scale.device):
        raise ValueError(f"dequant_matmul: a {tuple(a.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)} do not fit or are on different devices")
    if _cdiv(M, _TILE) > 65535:
        raise ValueError(f"dequant_matmul: {M} rows exceed the kernel's grid ({65535 * _TILE})")
    kchunk, splits = split_k(M, K, N)
    vec = int(K % 4 == 0 and N % 16 == 0 and a.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    evec = int(N % 4 == 0 and scale.data_ptr() % 16 == 0)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    lib = load()
    with torch.cuda.device(a.device):
        err = lib.kvquant_dequant_matmul(
            a.data_ptr(), q.data_ptr(), scale.data_ptr(), ws.data_ptr(), out.data_ptr(),
            M, K, N, kchunk, splits, vec, evec, stream(),
        )
    check_launch(err, "dequant_matmul")
    count_launch(LAUNCHES, "dequant_matmul")
    return out


#: the input types the append kernel reads as they are
_APPEND_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_append(k, v, k_cache, v_cache, k_scale, v_scale, slot) -> None:
    """Types, shapes and placement first, the device type last, so that
    each refusal is testable without a card."""
    if k.dtype not in _APPEND_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"quantize_append: k and v must both be float32 or bf16, got {k.dtype} and {v.dtype}")
    if k.ndim != 4 or k.shape[1] != 1 or 0 in k.shape or v.shape != k.shape:
        raise ValueError(f"quantize_append: k and v must be (B, 1, KV, hd), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    B, _, KV, hd = k.shape
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.dtype != torch.int8 or c.ndim != 4 or (c.shape[0], c.shape[2], c.shape[3]) != (B, KV, hd) \
                or c.shape[1] == 0:
            raise ValueError(f"quantize_append: {name} must be int8 (B, W, KV, hd) = ({B}, W, {KV}, {hd}), got "
                             f"{c.dtype} {tuple(c.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"quantize_append: k_cache {tuple(k_cache.shape)} and v_cache {tuple(v_cache.shape)} differ")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if sc.dtype != torch.float32 or tuple(sc.shape) != tuple(k_cache.shape[:3]):
            raise ValueError(f"quantize_append: {name} must be float32 {tuple(k_cache.shape[:3])}, got "
                             f"{sc.dtype} {tuple(sc.shape)}")
    if slot.dtype != torch.int64 or slot.numel() != 1:
        raise ValueError(f"quantize_append: slot must be one int64, got {slot.dtype} {tuple(slot.shape)}")
    tensors = (k, v, k_cache, v_cache, k_scale, v_scale, slot)
    if any(t.device != k_cache.device for t in tensors):
        raise ValueError("quantize_append: every tensor, the slot included, must be on the cache's device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache), ("k_scale", k_scale), ("v_scale", v_scale)):
        if not c.is_contiguous():
            raise ValueError(f"quantize_append: {name} must be contiguous: it is written in place")
    if k_cache.device.type != "cuda":
        raise ValueError(f"quantize_append: the CUDA kernel needs CUDA tensors, got {k_cache.device}")


def quantize_append(k: torch.Tensor, v: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_scale: torch.Tensor, v_scale: torch.Tensor, slot: torch.Tensor) -> None:
    """The int8 decode append of one attention layer, in one launch: each
    (b, h) row of the new token's k and v (B, 1, KV, hd), float32 or bf16,
    quantized per row (``scale = max(absmax / 127, 1e-8)``, ``q =
    clip(rint(x / scale), ±127)``, NaN -> 0) into ``k_cache[b, slot, h]``
    and ``v_cache[b, slot, h]`` (int8 (B, W, KV, hd)), the scales into
    ``k_scale[b, slot, h]`` and ``v_scale`` (float32 (B, W, KV)).  ``slot``
    is a 1-element int64 tensor on the card, read there (no host sync);
    a slot outside [0, W) writes nothing.  In place; bit-identical to
    :func:`.ref.quantize_append`."""
    _check_append(k, v, k_cache, v_cache, k_scale, v_scale, slot)
    k, v = k.contiguous(), v.contiguous()
    B, _, KV, hd = k.shape
    lib = load()
    with torch.cuda.device(k_cache.device):
        err = lib.kvquant_append(
            k.data_ptr(), v.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), slot.data_ptr(), B, KV, k_cache.shape[1], hd, _APPEND_DTYPES[k.dtype], stream(),
        )
    check_launch(err, "quantize_append")
    count_launch(LAUNCHES, "quantize_append")
