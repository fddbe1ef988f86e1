"""Per-(arch x shape) parallelism policy (``repro/launch/plans.py``).

The reference's tables are kept here as they are: the per-arch
gradient-accumulation microbatches of a ``train`` cell, and the archs that
shard the sequence, compress moments or hold an int8 KV cache.
:func:`make_cell_plan` builds FSDP and tensor-parallel plans over a
production mesh, which is slice 11d of the port (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Dict

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


def make_cell_plan(*args, **kwargs):
    raise NotImplementedError(
        "per-cell plans (FSDP over 'data', tensor parallelism over 'model') are slice 11d of the port (ROADMAP.md)"
    )
