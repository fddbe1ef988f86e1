"""nemotron-4-340b [arXiv:2402.16819; unverified] — GQA, squared-ReLU MLP.
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
The flagship scale cell: needs remat + FSDP + (optionally) compressed
optimizer state and int8 KV cache to fit device memory.
Full attention => long_500k SKIPPED."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    mlp_act="relu2",
)

SMOKE = ModelConfig(
    name="nemotron-smoke",
    family="dense",
    n_layers=2,
    d_model=192,
    n_heads=8,
    n_kv_heads=2,
    d_ff=768,
    vocab=512,
    mlp_act="relu2",
    dtype="float32",
)
