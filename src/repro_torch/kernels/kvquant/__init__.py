"""KV-cache quantization kernels in CUDA (per-channel absmax, quantize, fused
dequant-matmul), each beside its plain version."""
from .kernel import LAUNCHES, reset_launches
from .ops import kv_dequant_matmul, kv_quantize, ref_dequant_matmul, ref_quantize

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "kv_quantize",
    "kv_dequant_matmul",
    "ref_quantize",
    "ref_dequant_matmul",
]
