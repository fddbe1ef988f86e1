"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

Each package: ``csrc/*.cu`` (the kernel), ``kernel.py`` (its ``ctypes``
binding, built at first launch), ``ops.py`` (the public wrappers, which pick
the kernel for CUDA tensors and the plain version for CPU ones) and
``ref.py`` (the plain version)."""
from . import bitplane, fastmode, huffman, kvquant, lorenzo, transform  # noqa: F401
