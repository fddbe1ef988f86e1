"""Serve-step factory: the single-token decode, on one device or a mesh.

The JAX package's ``repro/serve/step.py`` jits the decode step with
sharded (optionally int8) caches.  :func:`cache_specs` gives the
reference's placement of each cache leaf (empty without a mesh), and
:func:`jit_serve_step` returns the eager step (the port does not compile
it; no ``torch.compile``).  The step runs under ``torch.no_grad`` and
updates the cache in place (the reference donates it).

On a mesh, :func:`jit_serve_step` holds the parameters in ``param_specs``
placements and the cache in :func:`cache_specs` placements (DTensors;
whole tensors given to it are placed at the first call).  The cache's
tensors are this rank's rows and heads: attention K/V and the SSM state
are this rank's heads; the conv state is gathered whole over the model
axis for the step and cut back after it (``models/mamba2.py``).  The
logits come back whole on every rank.  Each step runs one of two ways:

  * gathered (the default): the weights are gathered over the FSDP axes
    each step (``parallel.specs.model_local``) and the model runs on this
    rank's rows of the tokens;
  * weight-stationary (``decode_feature_shard`` with ``fsdp_axes``,
    ``ParallelPlan.weight_stationary``): no weight is gathered.  The
    tokens go whole to every rank and the residual stream holds every row
    and this rank's features; products that contract the features sum
    float32 partial products over the FSDP axes, attention and the SSM
    recurrence run on the cache's rows and their outputs are gathered over
    the batch axes (``models/lm.py``, ``moe.py``, ``mamba2.py``,
    ``encdec.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import models
from .. import tree as tree_util
from ..models.common import ModelConfig
from ..models.lm import param_tree
from ..parallel.plan import ParallelPlan
from ..parallel.specs import heads_shardable


def cache_specs(cache, cfg: ModelConfig, plan: ParallelPlan):
    """The cache's structure with each leaf's spec (the reference's
    placements: batch over the DP axes, kv and ssm heads over the model
    axis where they divide it, ring and state dims whole).  Without a mesh
    every spec is empty."""
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


#: cache leaves the step needs whole over the model axis: the conv state's
#: channels are placed in pieces that cut across its x/B/C parts
_WHOLE_OVER_MODEL = ("conv",)


def _walk(fn, specs, *caches, name: str = ""):
    """``fn(name, spec, *leaves)`` over the tensor fields of caches of one
    structure (dataclasses nested), rebuilt as the first cache's
    dataclasses."""
    first = caches[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _walk(fn, getattr(specs, f.name), *(getattr(c, f.name) for c in caches), name=f.name)
            for f in dataclasses.fields(first)})
    return None if first is None else fn(name, specs, *caches)


def jit_serve_step(serve_step, params, cache, cfg: ModelConfig, plan: ParallelPlan):
    """The decode entry point: ``serve_step`` itself without a mesh; on a
    mesh, a step ``(params, cache, tokens) -> (logits, cache)`` over the
    parameters and cache in their placements (see the module docstring)
    and the tokens whole or as a DTensor over the batch axes."""
    if plan.mesh is None:
        return serve_step
    from ..parallel import comm
    from ..parallel import specs as sp

    pspecs = sp.param_specs(params, cfg, plan)
    cspecs = cache_specs(cache, cfg, plan)
    m = plan.model_axis

    def place_params(ps):
        tree = param_tree(ps)
        flat = sp.spec_leaves(tree, pspecs)
        if all(sp.is_dtensor(t) for _, t, _ in flat):
            return tree
        out = {p: (t if sp.is_dtensor(t) else sp.place(t, s, plan)) for p, t, s in flat}
        return sp.map_paths(lambda path, _: out["/".join(path)], tree)

    def place_cache(c):
        return _walk(lambda _, s, t: t if sp.is_dtensor(t) else sp.place(t, s, plan), cspecs, c)

    def view(name, spec, t):
        local = t.to_local()
        if name in _WHOLE_OVER_MODEL:
            local = sp.gather_axes(local, tuple(e if e == m else None for e in spec), plan)
        return local

    def write_back(name, spec, dst, src):
        local = dst.to_local()
        if name in _WHOLE_OVER_MODEL:
            src = sp.shard_local(src, tuple(e if e == m else None for e in spec), plan)
        if src.data_ptr() != local.data_ptr():
            local.copy_(src)

    given, placed = params, place_params(params)

    def step(params, cache, tokens):
        params = placed if params is given else place_params(params)
        cache = place_cache(cache)
        local = _walk(view, cspecs, cache)
        if plan.weight_stationary:  # every row on every rank
            tok = tokens.full_tensor() if sp.is_dtensor(tokens) else tokens
        else:
            tok = tokens.to_local() if sp.is_dtensor(tokens) else comm.local_slice(tokens, 0, plan.dp_groups())
        logits, out = serve_step(params, local, tok)
        with torch.no_grad():
            _walk(write_back, cspecs, cache, out)
            if not plan.weight_stationary:
                logits = comm.all_gather(logits, 0, plan.dp_groups())
        return logits, cache

    return step

