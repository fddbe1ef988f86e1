"""Build and load the port's CUDA kernel sources.

Each kernel package keeps its source under ``csrc/`` and calls
:class:`CudaLibrary` from its ``kernel.py``.  A source is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes``.  The first launch builds it into ``build/`` beside the
package's ``kernel.py`` (listed in ``.gitignore``); the library's name carries
a hash of the source, so an edited source is rebuilt and a stale library is
never loaded.  Nothing is built or loaded at import: the CPU tests import the
kernel modules on machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, Dict, List

import torch

#: no ``--use_fast_math``: the kernels' bit identity with their plain
#: versions needs IEEE single and double arithmetic, rounded as written
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


#: guards every kernel module's launch counts: the chunked engine launches
#: kernels from several worker threads, and ``counts[name] += 1`` is a
#: read-modify-write the interpreter lock does not make atomic
_COUNT_LOCK = threading.Lock()


def count_launch(counts: Dict[str, int], name: str) -> None:
    """Add one to ``counts[name]``, safely across threads."""
    with _COUNT_LOCK:
        counts[name] += 1


def reset_counts(counts: Dict[str, int]) -> None:
    with _COUNT_LOCK:
        for k in counts:
            counts[k] = 0


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, as the C entry points take it."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


class CudaLibrary:
    """One ``.cu`` source, built at first use and loaded once per process.

    ``declare`` sets ``argtypes`` and ``restype`` of every entry point on
    the freshly loaded ``ctypes.CDLL``.
    """

    def __init__(self, src: pathlib.Path, stem: str, declare: Callable[[ctypes.CDLL], None]):
        self.src = src
        self.stem = stem
        self.build_dir = src.parent.parent / "build"
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()

    def nvcc_command(self, out: str) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, str(self.src)]

    def library_path(self) -> pathlib.Path:
        digest = hashlib.sha256(self.src.read_bytes()).hexdigest()[:16]
        return self.build_dir / f"lib{self.stem}-{digest}.so"

    def build(self) -> pathlib.Path:
        """Compile the source unless a library for this exact source exists."""
        path = self.library_path()
        if path.exists():
            return path
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        res = subprocess.run(self.nvcc_command(str(tmp)), capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src.name} ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent process never loads a torn file
        return path

    def load(self) -> ctypes.CDLL:
        """The built library with every entry point's C signature declared."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
        return self._lib
