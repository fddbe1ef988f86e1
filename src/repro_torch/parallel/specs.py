"""Head shardability of a model under a plan (``repro/parallel/specs.py``).

The reference's ``param_specs`` and ``batch_specs`` build PartitionSpec
trees for tensor, FSDP and sequence parallelism over a mesh; those are
slice 11d of the port (``ROADMAP.md``).  Data parallelism needs none: every
rank holds the whole model and its rows of the batch.
"""
from __future__ import annotations

from ..models.common import ModelConfig
from .plan import ParallelPlan


def heads_shardable(cfg: ModelConfig, plan: ParallelPlan) -> bool:
    if cfg.n_heads == 0:
        return True
    from ..models.layers import attn_dims

    dims = attn_dims(cfg, plan)
    tp = plan.tp
    return dims.n_q % tp == 0 and dims.n_kv % tp == 0


def param_specs(*args, **kwargs):
    raise NotImplementedError("parameter placements for sharded training are slice 11d of the port (ROADMAP.md)")


def batch_specs(*args, **kwargs):
    raise NotImplementedError("batch placements for sharded training are slice 11d of the port (ROADMAP.md)")
