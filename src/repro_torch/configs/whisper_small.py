"""whisper-small [arXiv:2212.04356; unverified] — enc-dec; conv/mel frontend
is a STUB (input_specs provides precomputed frame embeddings, enc_seq=1500).
12L enc + 12L dec, d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
GELU + LayerNorm.  Full attention => long_500k SKIPPED; decode shapes
exercise the decoder + cross-KV (structural at 32k per the brief)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    enc_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    mlp_act="gelu",
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    enc_seq=32,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    mlp_act="gelu",
    norm="layernorm",
    dtype="float32",
)
