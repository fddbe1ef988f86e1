"""KV-cache quantization policy (the paper's quantizer on the serving path).

Per-token-per-head symmetric int8 (radius 127): each token's (hd,) vector
is quantized against its own absmax — the linear-scaling quantizer with a
per-element bound of scale/2.  Plus the jit-tier prefill codes: bulk prompt
KV through the same per-block predictor contest the gradient and moment
paths use, one block per token vector.  The per-channel quantize and the
fused dequant-matmul kernels live in ``kernels/kvquant``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import jitmode
from ..core.jitmode import JitPolicy
from ..core.quantizers import true_div

SCALE_FLOOR = 1e-8


def quantize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> (int8 codes (..., hd), scales (...))."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    # an IEEE divide: on CUDA, torch turns a divide by a Python scalar into
    # a multiply by its reciprocal
    scale = torch.clamp_min(true_div(absmax, 127.0), SCALE_FLOOR)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_tokens(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def cache_bytes(seq: int, n_kv: int, hd: int, dtype: str) -> int:
    """Per-layer per-sequence cache bytes (K+V)."""
    if dtype == "int8":
        return 2 * seq * n_kv * (hd + 4)
    itemsize = 2 if dtype in ("bf16", "bfloat16") else 4
    return 2 * seq * n_kv * hd * itemsize


def quantization_snr_db(x: torch.Tensor) -> float:
    q, s = quantize_tokens(x)
    xf = x.to(torch.float32)
    err = dequantize_tokens(q, s) - xf
    p_sig = torch.mean(xf**2)
    p_err = torch.clamp_min(torch.mean(err**2), 1e-30)
    return float(10.0 * torch.log10(p_sig / p_err))


# -- jit-tier prefill compression (core/jitmode facade) ----------------------

@dataclasses.dataclass
class PrefillCodes(jitmode.ArrayState):
    codes: torch.Tensor  # (..., nb, bs) int8 / packed uint8
    scale: torch.Tensor  # (..., nb) f32
    tags: torch.Tensor  # (..., nb) uint8
    base: torch.Tensor  # (..., nb) f32
    orig_hd: int
    bits: int

    ARRAYS = ("codes", "scale", "tags", "base")

    def bound(self) -> torch.Tensor:
        """Per-block bound, same contract as ``BlockCodes.bound()``."""
        mag = jitmode._sel_magnitude(self.codes, self.tags, self.bits)
        slack = (self.base.abs() + self.scale * mag) * 2.0**-22
        return self.scale * 0.5 + slack


def prefill_policy(hd: int, bits: int = 8) -> JitPolicy:
    """One block per token vector (hd rounded up to even for int4)."""
    return JitPolicy(tier=f"int{bits}", bs=hd + (hd % 2))


def quantize_prefill(x: torch.Tensor, policy: Optional[JitPolicy] = None) -> PrefillCodes:
    """x: (..., hd) bulk prompt KV -> per-token jit-tier codes, on x's device."""
    pol = policy or prefill_policy(x.shape[-1])
    codes, scale, tags, base, last = jitmode.encode_lastaxis(x, pol)
    return PrefillCodes(codes=codes, scale=scale, tags=tags, base=base, orig_hd=last, bits=pol.bits)


def dequantize_prefill(c: PrefillCodes) -> torch.Tensor:
    return jitmode.decode_lastaxis(c.codes, c.scale, c.tags, c.base, c.orig_hd, c.bits)
