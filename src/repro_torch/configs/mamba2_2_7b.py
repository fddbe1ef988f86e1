"""mamba2-2.7b [arXiv:2405.21060; unverified] — pure SSD, attention-free.
64L d_model=2560 (d_inner=5120, 80 heads of 64) vocab=50280 ssm_state=128.
KV-cache compression is inapplicable (no KV) — the SSM state is compressed
with the same quantizer module instead (DESIGN.md §Arch-applicability).
long_500k RUNS (O(1) decode state)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=128,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=16,
    dtype="float32",
)
