"""KV-cache quantization kernels in CUDA (per-channel absmax, quantize, fused
dequant-matmul, the fused int8 decode append), each beside its plain
version."""
from .kernel import LAUNCHES, reset_launches
from .ops import kv_dequant_matmul, kv_quantize, kv_quantize_append, ref_dequant_matmul, ref_quantize

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "kv_quantize",
    "kv_quantize_append",
    "kv_dequant_matmul",
    "ref_quantize",
    "ref_dequant_matmul",
]
