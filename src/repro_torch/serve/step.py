"""Serve-step factory: the single-token decode on one device.

The JAX package's ``repro/serve/step.py`` jits the decode step with
sharded (optionally int8) caches.  Without a mesh every cache spec is
empty (:func:`cache_specs`), and :func:`jit_serve_step` returns the eager
step: the port does not compile it (no ``torch.compile``).  The step runs
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


def cache_specs(cache, cfg: ModelConfig, plan: ParallelPlan):
    """The cache's structure with an empty spec at every leaf (one device:
    nothing is sharded)."""
    if isinstance(cache, models.DecodeCache):
        return dataclasses.replace(cache, **{
            f.name: tree_util.tree_map(lambda _: (), getattr(cache, f.name))
            for f in dataclasses.fields(cache)
        })
    return tree_util.tree_map(lambda _: (), cache)


def make_serve_step(cfg: ModelConfig, plan: ParallelPlan):
    def serve_step(params, cache, tokens):
        with torch.no_grad():
            return models.decode_step(params, cache, tokens, cfg, plan)

    return serve_step


def jit_serve_step(serve_step, params, cache, cfg: ModelConfig, plan: ParallelPlan):
    return serve_step
