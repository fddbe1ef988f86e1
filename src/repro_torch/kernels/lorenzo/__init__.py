from .kernel import LAUNCHES, reset_launches
from .ops import (
    PIPELINE_SAFE,
    decode_pipeline,
    encode_pipeline,
    lorenzo_decode,
    lorenzo_encode,
    ref_decode,
    ref_encode,
)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "PIPELINE_SAFE",
    "encode_pipeline",
    "decode_pipeline",
    "lorenzo_encode",
    "lorenzo_decode",
    "ref_encode",
    "ref_decode",
]
