"""zamba2-7b [arXiv:2411.15242; unverified] — Mamba2 backbone + ONE shared
attention+MLP block applied every 6 SSM layers (weights shared across the 13
applications).  81L d_model=3584 attn 32H (kv=32) d_ff=14336 vocab=32000
ssm_state=64.  SSM/hybrid => long_500k RUNS.
Structural note: the Zamba2 concat-skip into the shared block is simplified
to a standard residual block (DESIGN.md §Arch-applicability)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=5,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=16,
    hybrid_attn_every=2,
    mlp_act="swiglu",
    dtype="float32",
)
