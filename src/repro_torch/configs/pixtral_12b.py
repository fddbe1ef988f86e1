"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified] — pixtral-ViT
frontend (STUB: input_specs provides patch+token embeddings (B,S,d)) on a
mistral-nemo decoder.  40L d_model=5120 32H (GQA kv=8, head_dim=128)
d_ff=14336 vocab=131072.  Full attention => long_500k SKIPPED."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="pixtral-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    mlp_act="swiglu",
    dtype="float32",
)
