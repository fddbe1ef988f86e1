"""SZ3 core in torch: modular prediction-based error-bounded lossy compression.

The paper's five-module abstraction (preprocessor -> predictor -> quantizer ->
encoder -> lossless) composed per §3.3.  Ported so far: the v1 single
pipeline ``sz3_lorenzo`` and the modules it is built from.
"""
from . import telemetry  # noqa: I001  (stdlib-only; imported first)
from . import encoders, lossless, metrics, predictors, preprocess, quantizers
from . import integrity
from .config import CompressionConfig, ErrorBoundMode
from .integrity import (
    ChunkDamage,
    ContainerError,
    IntegrityError,
    SalvageReport,
)
from .pipeline import (
    PIPELINES,
    CompressionResult,
    SZ3Compressor,
    decompress,
    parse_header,
    resolve_device,
    sz3_lorenzo,
)

__all__ = [
    "telemetry",
    "CompressionConfig",
    "ErrorBoundMode",
    "ContainerError",
    "IntegrityError",
    "SalvageReport",
    "ChunkDamage",
    "integrity",
    "SZ3Compressor",
    "CompressionResult",
    "decompress",
    "parse_header",
    "resolve_device",
    "PIPELINES",
    "sz3_lorenzo",
    "encoders",
    "lossless",
    "metrics",
    "predictors",
    "preprocess",
    "quantizers",
]
