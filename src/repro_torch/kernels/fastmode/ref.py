"""Plain version of the fast tier's classify+reduce kernel.

``block_stats`` repeats the CUDA kernel's arithmetic with ordinary torch
ops, so the kernel equals it bit for bit (NaN equal to NaN):

  * lane l of a warp holds elements 4l..4l+3 of the block (and, for
    bs = 256, 128+4l..128+4l+3) and sums them in that order in float32;
  * the 32 lane sums combine pairwise, halving: lanes l and l+16, then l
    and l+8, ... — the kernel's xor-shuffle tree;
  * mean = sum / bs; dev = max |x - mean|, propagating NaN.

It differs from the JAX package's oracle (``jnp.mean``, which XLA sums in
its own order) within float32 rounding.  The coder re-verifies every block
the statistics class as constant, so the order can cost ratio, never the
bound.
"""
from __future__ import annotations

from typing import Tuple

import torch

VALID_BS = (128, 256)


def block_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nb, bs) float32, bs in {128, 256} -> (means (nb,), devs (nb,))."""
    if x.ndim != 2 or x.shape[1] not in VALID_BS:
        raise ValueError(f"block_stats: expected (nb, 128 or 256), got {tuple(x.shape)}")
    nb, bs = x.shape
    x = x.to(torch.float32)
    v = x.reshape(nb, bs // 128, 32, 4)
    s = v[:, 0, :, 0]
    for c in range(bs // 128):
        for j in range(4):
            if c or j:
                s = s + v[:, c, :, j]
    while s.shape[1] > 1:
        h = s.shape[1] // 2
        s = s[:, :h] + s[:, h:]
    means = s[:, 0] / bs
    devs = (x - means[:, None]).abs().amax(dim=1)
    return means, devs
