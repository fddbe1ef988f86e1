"""Head shardability of a model under a plan (``repro/parallel/specs.py``).

The reference's ``param_specs`` and ``batch_specs`` build PartitionSpec
trees over a mesh; they come with the port's ``DeviceMesh`` plan in slice
11b (``ROADMAP.md``).
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
