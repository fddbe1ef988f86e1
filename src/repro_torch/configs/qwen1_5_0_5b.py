"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; hf] — MHA with QKV bias, tied embeds.
24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.
Full attention => long_500k SKIPPED."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    qkv_bias=True,
    tie_embeddings=True,
    mlp_act="swiglu",
    dtype="float32",
)
