"""Error-bounded optimizer-moment compression via the jit codec facade.

Moments are encoded with ``core/jitmode``'s fixed tier blocked along the
last axis: per-block predictor contest, fixed radius, mantissa-snapped
per-block scales.  Codes keep the parameter's shape (last dim padded to the
block size); the side channels (scale, tag, base) drop the last dim to
``ceil(last/BLOCK)`` blocks.

Two bound domains:

* ``compress``/``decompress`` — linear values, per-block REL bound: the
  first moment.
* ``compress_nonneg``/``decompress_nonneg`` — the SECOND moment, in the
  log2 domain (SZ's pointwise-relative construction): an ABS bound of d on
  ``log2 v`` is the multiplicative bound ``v_hat/v in [2**-d, 2**d]``, so
  a small element in a block of large ones keeps its magnitude and
  ``m/sqrt(v)`` stays bounded.  ``log2`` and ``exp2`` are not correctly
  rounded on any device, so this path agrees with the JAX package within
  a few float32 ulps of ``log2 v``, while its encode of the same ``log2 v``
  is bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import jitmode
from ..core.jitmode import JitPolicy

BLOCK = 256
SCALE_FLOOR = jitmode.SCALE_FLOOR

DEFAULT_POLICY = JitPolicy(tier="int8", bs=BLOCK)

#: Floor for log-domain compression, comfortably NORMAL in f32 (log2(0) =
#: -inf would poison the block stats).  sqrt(2**-100) ~= 9e-16 is far below
#: Adam's eps.
NONNEG_FLOOR = float(2.0 ** -100)


@dataclasses.dataclass
class Compressed(jitmode.ArrayState):
    codes: torch.Tensor  # int8 (param shape, last dim padded) / uint8 packed
    scale: torch.Tensor  # f32, (*lead, n_blocks)
    tags: torch.Tensor  # uint8, (*lead, n_blocks) — winning predictor
    base: torch.Tensor  # f32, (*lead, n_blocks) — predictor base value
    orig_last: int
    bits: int = 8
    domain: str = "linear"  # "linear" | "log2" (nonneg PW_REL)

    ARRAYS = ("codes", "scale", "tags", "base")

    def nbytes(self) -> int:
        """Bytes held: codes plus the three side channels."""
        return sum(a.numel() * a.element_size() for a in (self.codes, self.scale, self.tags, self.base))


def compress(x: torch.Tensor, policy: Optional[JitPolicy] = None) -> Compressed:
    pol = policy or DEFAULT_POLICY
    x = x.to(torch.float32)
    if x.ndim == 0:
        x = x.reshape(1)
    codes, scale, tags, base, last = jitmode.encode_lastaxis(x, pol)
    flat_codes = codes.reshape(*codes.shape[:-2], codes.shape[-2] * codes.shape[-1])
    return Compressed(codes=flat_codes, scale=scale, tags=tags, base=base, orig_last=last, bits=pol.bits)


def decompress(c: Compressed) -> torch.Tensor:
    shp = c.codes.shape
    nb = c.scale.shape[-1]
    blocks = c.codes.reshape(*shp[:-1], nb, shp[-1] // nb)
    x = jitmode.decode_lastaxis(blocks, c.scale, c.tags, c.base, c.orig_last, c.bits)
    if c.domain == "log2":
        x = torch.exp2(x)
        # values that were at the floor (incl. exact zeros) decode back to 0
        x = torch.where(x <= 2.0 * NONNEG_FLOOR, torch.zeros((), dtype=x.dtype, device=x.device), x)
    return x


def compress_nonneg(x: torch.Tensor, policy: Optional[JitPolicy] = None) -> Compressed:
    """Pointwise-relative compression of a nonnegative array (log2 domain)."""
    u = torch.log2(torch.clamp_min(x.to(torch.float32), NONNEG_FLOOR))
    return dataclasses.replace(compress(u, policy), domain="log2")


def decompress_nonneg(c: Compressed) -> torch.Tensor:
    return decompress(c)


def init_compressed(p: torch.Tensor, policy: Optional[JitPolicy] = None, domain: str = "linear") -> Compressed:
    """Compressed zeros of ``p``'s shape, on ``p``'s device."""
    zeros = torch.zeros(p.shape if p.ndim else (1,), dtype=torch.float32, device=p.device)
    if domain == "log2":
        return compress_nonneg(zeros, policy)
    return compress(zeros, policy)


def compression_ratio(p: torch.Tensor, policy: Optional[JitPolicy] = None) -> float:
    """Memory saving vs f32 moments."""
    return (p.numel() * 4) / init_compressed(p, policy).nbytes()
