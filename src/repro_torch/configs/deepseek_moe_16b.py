"""deepseek-moe-16b [arXiv:2401.06066; hf] — fine-grained MoE: 2 shared +
64 routed experts top-6; layer 0 dense.  28L d_model=2048 16H (kv=16)
expert d_ff=1408 vocab=102400.  Full attention => long_500k SKIPPED."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,  # dense layer-0 FFN (per the HF reference config)
    vocab=102400,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    dense_prefix_layers=1,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    family="moe",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=320,
    vocab=512,
    n_experts=8,
    top_k=2,
    moe_d_ff=64,
    n_shared_experts=2,
    dense_prefix_layers=1,
    mlp_act="swiglu",
    dtype="float32",
)
