"""Build, bind and launch the CUDA Lorenzo kernels (``csrc/lorenzo.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  The first launch builds it
into ``build/`` beside this file (listed in ``.gitignore``); the library's
name carries a hash of the source, so an edited source is rebuilt and a
stale library is never loaded.  Nothing is built or loaded at import: the
CPU tests import this module on machines with no ``nvcc``.

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises if the launch reports an error, and
adds one to its entry in :data:`LAUNCHES`.  The choice between a kernel and
its plain version (``ref.py``) is made in ``ops.py``, by the tensor's device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

import torch

_SRC = pathlib.Path(__file__).parent / "csrc" / "lorenzo.cu"
_BUILD_DIR = pathlib.Path(__file__).parent / "build"

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "encode_1d": 0,
    "encode_2d": 0,
    "decode_1d": 0,
    "decode_2d": 0,
}

#: the grids launch at most this many blocks along x
_MAX_BLOCKS = (1 << 31) - 1
_TILE = 4096  # elements per row-scan tile (kTile in the source)
_SEG_ROWS = 64  # rows per column-scan segment (kSegRows in the source)
_THREADS = 256

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Lorenzo CUDA kernels cannot be built")


#: no ``--use_fast_math``: the kernels' bit identity with the JAX package
#: needs IEEE single multiplies
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_command(out: str) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, str(_SRC)]


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"liblorenzo-{digest}.so"


def build() -> pathlib.Path:
    """Compile the source unless a library for this exact source exists."""
    path = library_path()
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(nvcc_command(str(tmp)), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent process never loads a torn file
    return path


def load() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
            for name in ("lorenzo_encode_1d", "lorenzo_encode_2d"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, i64, i64, f32, i32, p]
                fn.restype = ctypes.c_int
            for name in ("lorenzo_decode_1d", "lorenzo_decode_2d"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, i64, i64, f32, p]
                fn.restype = ctypes.c_int
            lib.lorenzo_decode_scratch_words.argtypes = [i64, i64, i32]
            lib.lorenzo_decode_scratch_words.restype = i64
            _lib = lib
    return _lib


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
    n_seg_blocks = -(-rows // _SEG_ROWS) * -(-cols // _THREADS)
    if rows * -(-cols // _TILE) > _MAX_BLOCKS or n_seg_blocks > _MAX_BLOCKS:
        raise ValueError(f"{what}: shape {tuple(t.shape)} exceeds the launch grid")
    return rows, cols


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


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
            1.0 / (2.0 * float(eb)), int(radius), _stream(),
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return codes, draw


def _decode(name: str, d: torch.Tensor, eb: float) -> torch.Tensor:
    rows, cols = _check(d, torch.int32, name)
    lib = load()
    out = torch.empty((rows, cols), dtype=torch.float32, device=d.device)
    words = lib.lorenzo_decode_scratch_words(rows, cols, int(name == "decode_2d"))
    scratch = torch.empty(max(1, words), dtype=torch.int32, device=d.device)
    with torch.cuda.device(d.device):
        err = getattr(lib, f"lorenzo_{name}")(
            d.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, cols,
            2.0 * float(eb), _stream(),
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1
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
