"""SZ3 core in torch: modular prediction-based error-bounded lossy compression.

The paper's five-module abstraction (preprocessor -> predictor -> quantizer ->
encoder -> lossless) composed per §3.3.  Ported so far: the v1 pipelines
``sz3_lorenzo``, ``sz3_lr`` and ``sz3_interp`` and the modules they are
built from, the v2 chunked engine ``sz3_chunked`` and its widest contest
``sz3_auto``, the v3 transform coder ``sz3_transform``, the v5 block hybrid
``sz3_hybrid``, the v6 fast tier ``sz3_fast``, the quality controller
``sz3_quality``, pointwise-relative bounds (``LogTransform``, the v4 engine
``sz3_pwr``) and the customized pipelines of §4 (GAMESS: ``sz3_pastri``,
``sz_pastri``, ``sz_pastri_zstd``), §5 (APS: ``sz3_aps``) and §6.2
(``sz3_truncation``); with them the telemetry spine (spans, decision
records, ``explain``, the metrics registry), the fault generator ``faults``
and ``verify_blob``.
"""
from . import telemetry  # noqa: I001  (imports no other core module; first)
from .telemetry import Trace, explain, trace_summary
from . import encoders, lossless, metrics, predictors, preprocess, quantizers
from . import integrity
from .config import CompressionConfig, ErrorBoundMode
from .integrity import (
    ChunkDamage,
    ContainerError,
    IntegrityError,
    SalvageReport,
    verify_blob,
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
from . import transform
from . import blockwise  # noqa: I001  (blockwise must import after transform:
# it registers sz3_hybrid and appends it to transform.AUTO_CANDIDATES)
from . import fastmode  # noqa: I001  (fastmode must import after blockwise:
# it registers sz3_fast and appends it to transform.AUTO_CANDIDATES)
from .fastmode import FastModeCompressor, sz3_fast
from .transform import (  # noqa: I001  (re-export AFTER blockwise extends it)
    AUTO_CANDIDATES,
    TransformCompressor,
    sz3_auto,
    sz3_transform,
)
from .blockwise import BlockHybridCompressor, sz3_hybrid
from . import quality
from .quality import (  # noqa: I001  (quality must import after transform)
    QualityCompressor,
    QualityTarget,
    achieved_quality,
    sz3_quality,
)
from . import faults  # noqa: I001  (faults reads containers through pipeline)

__all__ = [
    "telemetry",
    "Trace",
    "explain",
    "trace_summary",
    "CompressionConfig",
    "ErrorBoundMode",
    "ContainerError",
    "IntegrityError",
    "SalvageReport",
    "ChunkDamage",
    "verify_blob",
    "integrity",
    "faults",
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
    "QualityCompressor",
    "QualityTarget",
    "achieved_quality",
    "sz3_quality",
    "quality",
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
    "TransformCompressor",
    "sz3_transform",
    "sz3_auto",
    "AUTO_CANDIDATES",
    "transform",
    "BlockHybridCompressor",
    "sz3_hybrid",
    "blockwise",
    "FastModeCompressor",
    "sz3_fast",
    "fastmode",
    "encoders",
    "lossless",
    "metrics",
    "predictors",
    "preprocess",
    "quantizers",
]
