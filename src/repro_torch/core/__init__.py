"""SZ3 core in torch: modular prediction-based error-bounded lossy compression.

The paper's five-module abstraction (preprocessor -> predictor -> quantizer ->
encoder -> lossless) composed per §3.3.  Ported so far: the v1 pipelines
``sz3_lorenzo``, ``sz3_lr`` and ``sz3_interp`` and the modules they are
built from, the v2 chunked engine ``sz3_chunked``, the v3 transform coder
``sz3_transform``, the v6 fast tier ``sz3_fast``, pointwise-relative bounds
(``LogTransform``, the v4 engine ``sz3_pwr``) and the customized pipelines of
§4 (GAMESS: ``sz3_pastri``, ``sz_pastri``, ``sz_pastri_zstd``), §5 (APS:
``sz3_aps``) and §6.2 (``sz3_truncation``).
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
from .pipeline import (  # noqa: I001  (chunking must import after pipeline)
    PIPELINES,
    AdaptiveAPSCompressor,
    CompressionResult,
    SZ3Compressor,
    TruncationCompressor,
    decompress,
    parse_header,
    resolve_device,
    sz3_aps,
    sz3_interp,
    sz3_lorenzo,
    sz3_lr,
    sz3_pastri,
    sz3_truncation,
    sz_pastri,
    sz_pastri_zstd,
)
from . import chunking
from .chunking import (
    ChunkedCompressor,
    ChunkedIndex,
    PWRelChunkedCompressor,
    compress_stream,
    decompress_chunk,
    decompress_stream,
    frames_to_blob,
    parse_chunked_index,
    read_frames,
    select_pipeline,
    sz3_chunked,
    sz3_pwr,
    write_frames,
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
    "TruncationCompressor",
    "AdaptiveAPSCompressor",
    "CompressionResult",
    "decompress",
    "parse_header",
    "resolve_device",
    "PIPELINES",
    "sz3_lr",
    "sz3_interp",
    "sz3_lorenzo",
    "sz3_truncation",
    "sz_pastri",
    "sz_pastri_zstd",
    "sz3_pastri",
    "sz3_aps",
    "ChunkedCompressor",
    "PWRelChunkedCompressor",
    "sz3_chunked",
    "sz3_pwr",
    "compress_stream",
    "decompress_stream",
    "decompress_chunk",
    "parse_chunked_index",
    "ChunkedIndex",
    "frames_to_blob",
    "write_frames",
    "read_frames",
    "select_pipeline",
    "chunking",
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
