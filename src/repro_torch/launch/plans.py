"""Per-(arch x shape) parallelism policy (``repro/launch/plans.py``).

The reference's tables are kept here as they are: the per-arch
gradient-accumulation microbatches of a ``train`` cell, and the archs that
shard the sequence, compress moments or hold an int8 KV cache.
:func:`make_cell_plan` is the reference's policy:

  * train: FSDP over ``data`` (replicas over ``pod``), full remat, the
    per-arch microbatches; nemotron also shards the residual stream's
    sequence over ``model`` and compresses its optimizer moments;
  * decode: weights FSDP-sharded; nemotron's KV cache in int8;
  * a cell whose batch does not divide the data-parallel size
    (``long_500k``, batch 1) replicates the batch.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from ..models.common import ModelConfig
from ..optim import AdamWConfig
from ..parallel.plan import ParallelPlan

TRAIN_MICROBATCHES: Dict[str, int] = {
    "nemotron-4-340b": 16,
    "granite-3-8b": 8,
    "pixtral-12b": 8,
    "zamba2-7b": 8,
    "deepseek-moe-16b": 8,
    "qwen3-moe-30b-a3b": 8,
    "mamba2-2.7b": 4,
    "h2o-danube-1.8b": 4,
    "qwen1.5-0.5b": 2,
    "whisper-small": 2,
}

SEQ_SHARD_TRAIN = {"nemotron-4-340b"}
COMPRESS_MOMENTS = {"nemotron-4-340b"}
KV_INT8_DECODE = {"nemotron-4-340b"}


def make_cell_plan(
    arch: str,
    cfg: ModelConfig,
    cell,
    mesh,
    multi_pod: Optional[bool] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Tuple[ParallelPlan, AdamWConfig]:
    """The plan and optimizer config of one (arch x shape) cell on
    ``mesh``; ``multi_pod`` defaults to whether the mesh has a ``pod``
    axis."""
    if multi_pod is None:
        multi_pod = "pod" in mesh.mesh_dim_names
    overrides = dict(overrides or {})
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    names = mesh.mesh_dim_names
    dp = math.prod(int(mesh.size(names.index(a))) for a in dp_axes)
    batch_axes = dp_axes if cell.batch % dp == 0 else ()

    opt = AdamWConfig(compress_moments=arch in COMPRESS_MOMENTS)
    if "compress_moments" in overrides:
        opt = opt._replace(compress_moments=overrides.pop("compress_moments"))

    kw: Dict[str, Any] = dict(
        mesh=mesh,
        batch_axes=batch_axes,
        model_axis="model",
        fsdp_axes=("data",),
        remat="full",
        microbatches=1,
        kv_cache_dtype="bf16",
    )
    if cell.kind == "train":
        kw["microbatches"] = TRAIN_MICROBATCHES.get(arch, 4)
        if arch in SEQ_SHARD_TRAIN:
            kw["seq_axes"] = ("model",)
    elif cell.kind == "decode":
        if arch in KV_INT8_DECODE:
            kw["kv_cache_dtype"] = "int8"
    kw.update(overrides)
    return ParallelPlan(**kw), opt
