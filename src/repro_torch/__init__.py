"""PyTorch/CUDA port of the SZ3 compressor in ``repro``.

The package runs the JAX package's compression pipelines with torch array
math on CPU or CUDA tensors and hand-written CUDA kernels for Hopper.  It
never imports JAX or ``repro``; the two packages share only their container
format, so blobs written by either decode in the other.
"""
