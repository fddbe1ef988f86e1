"""granite-3-8b [hf:ibm-granite/granite-3.0-2b-base; hf] — GQA dense.
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155 (padded to 49408).
Full attention => long_500k SKIPPED."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=320,
    vocab=515,  # odd vocab exercises padding
    mlp_act="swiglu",
    dtype="float32",
)
