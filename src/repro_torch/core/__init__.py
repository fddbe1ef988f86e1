"""SZ3 core in torch: modular prediction-based error-bounded lossy compression.

The paper's five-module abstraction (preprocessor -> predictor -> quantizer ->
encoder -> lossless) composed per §3.3.  Ported so far: the v1 pipelines
``sz3_lorenzo``, ``sz3_lr`` and ``sz3_interp`` and the modules they are
built from, the v2 chunked engine ``sz3_chunked``, the v3 transform coder
``sz3_transform`` and the v6 fast tier ``sz3_fast``.
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
    CompressionResult,
    SZ3Compressor,
    decompress,
    parse_header,
    resolve_device,
    sz3_interp,
    sz3_lorenzo,
    sz3_lr,
)
from . import chunking
from .chunking import (
    ChunkedCompressor,
    ChunkedIndex,
    compress_stream,
    decompress_chunk,
    decompress_stream,
    frames_to_blob,
    parse_chunked_index,
    read_frames,
    select_pipeline,
    sz3_chunked,
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
    "CompressionResult",
    "decompress",
    "parse_header",
    "resolve_device",
    "PIPELINES",
    "sz3_lr",
    "sz3_interp",
    "sz3_lorenzo",
    "ChunkedCompressor",
    "sz3_chunked",
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
