"""Serve-step factory: the single-token decode on one device.

The JAX package's ``repro/serve/step.py`` jits the decode step with
sharded (optionally int8) caches.  :func:`cache_specs` gives the
reference's placement of each cache leaf (empty without a mesh), and
:func:`jit_serve_step` returns the eager step: the port does not compile
it (no ``torch.compile``).  The step runs
under ``torch.no_grad`` and updates the cache in place (the reference
donates it).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import models
from .. import tree as tree_util
from ..models.common import ModelConfig
from ..parallel.plan import ParallelPlan
from ..parallel.specs import heads_shardable


def cache_specs(cache, cfg: ModelConfig, plan: ParallelPlan):
    """The cache's structure with each leaf's spec (the reference's
    placements: batch over the DP axes, kv and ssm heads over the model
    axis where they divide it, ring and state dims whole).  Without a mesh
    every spec is empty; the port serves on one device."""
    b = plan.b
    m = plan.model_axis if heads_shardable(cfg, plan) else None
    ms = plan.model_axis  # ssm dims use their own divisibility

    def spec(name: str):
        if name in ("k", "v", "cross_k", "cross_v"):
            return plan.ps(None, b, None, m, None)
        if name in ("k_scale", "v_scale"):
            return plan.ps(None, b, None, m)
        if name == "pos":
            return plan.ps(b, None)
        if name == "ssm":  # (L, B, H, P, N)
            return plan.ps(None, b, ms if cfg.ssm_heads % plan.tp == 0 else None, None, None)
        if name == "conv":  # (L, B, K-1, C)
            c = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            return plan.ps(None, b, None, ms if c % plan.tp == 0 else None)
        return plan.ps()

    def walk(node, name: str):
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{f.name: walk(getattr(node, f.name), f.name)
                                                for f in dataclasses.fields(node)})
        return tree_util.tree_map(lambda _: spec(name), node)

    return walk(cache, "")


def make_serve_step(cfg: ModelConfig, plan: ParallelPlan):
    def serve_step(params, cache, tokens):
        with torch.no_grad():
            return models.decode_step(params, cache, tokens, cfg, plan)

    return serve_step


def jit_serve_step(serve_step, params, cache, cfg: ModelConfig, plan: ParallelPlan):
    return serve_step
