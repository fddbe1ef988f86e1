"""SZ3 core in torch: modular prediction-based error-bounded lossy compression.

The paper's five-module abstraction (preprocessor -> predictor -> quantizer ->
encoder -> lossless) composed per §3.3.  Ported so far: the v1 single
pipeline ``sz3_lorenzo`` and the modules it is built from, the v3 transform
coder ``sz3_transform`` and the v6 fast tier ``sz3_fast``.
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
from . import fastmode, transform  # noqa: E402  (register their pipelines)
from .fastmode import FastModeCompressor, sz3_fast
from .transform import TransformCompressor, sz3_transform

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
    "sz3_transform",
    "sz3_fast",
    "TransformCompressor",
    "FastModeCompressor",
    "transform",
    "fastmode",
    "encoders",
    "lossless",
    "metrics",
    "predictors",
    "preprocess",
    "quantizers",
]
