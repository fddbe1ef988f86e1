"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf] — 128 experts top-8, no
shared expert; head_dim=128 explicit.  48L d_model=2048 32H (GQA kv=4)
expert d_ff=768 vocab=151936.  Full attention => long_500k SKIPPED."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=6144,  # unused (all layers MoE); kept for completeness
    vocab=151936,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    n_shared_experts=0,
    dense_prefix_layers=0,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    n_experts=16,
    top_k=4,
    moe_d_ff=32,
    n_shared_experts=0,
    mlp_act="swiglu",
    dtype="float32",
)
