"""h2o-danube-1.8b [arXiv:2401.16818; hf] — llama+mistral mix with sliding-
window attention.  24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
SWA window 4096 (mistral-style); sub-quadratic => long_500k RUNS."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,
    mlp_act="swiglu",
)

SMOKE = ModelConfig(
    name="h2o-danube-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    sliding_window=16,
    mlp_act="swiglu",
    dtype="float32",
)
