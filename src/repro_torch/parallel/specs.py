"""Parameter and batch placements (``repro/parallel/specs.py``).

:func:`param_specs` and :func:`batch_specs` are the reference's name-based
rules (TP over ``model``, FSDP over the plan's ``fsdp_axes``), with each
spec a tuple of axis entries where the reference has a ``PartitionSpec``:
stacked layer dims get leading ``None``s, head sharding applies only when
the (virtual) head counts divide the TP size, otherwise attention weights
fall back to FSDP only (whisper's 12 heads on TP=16).  They read only each
leaf's path and ``ndim``, so a tree of meta tensors gives the placements of
a full config without allocating it.

A spec tree has the structure of its tree with a tuple at each leaf (a
compressed AdamW moment's spec is a ``Compressed`` whose array fields hold
the specs).  :func:`spec_leaves` pairs it with a tree's leaves;
:func:`place` turns a whole tensor into a DTensor with the spec's
placements (``ParallelPlan.placements``), cutting this rank's piece
locally; :func:`model_local` is what the model computes on: a parameter
whole over every axis but the model axis; :func:`stationary_local` is what
the weight-stationary decode computes on: every parameter at its shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .. import tree as tree_util
from ..models.common import ModelConfig
from . import comm
from .plan import ParallelPlan


def heads_shardable(cfg: ModelConfig, plan: ParallelPlan) -> bool:
    if cfg.n_heads == 0:
        return True
    from ..models.layers import attn_dims

    dims = attn_dims(cfg, plan)
    tp = plan.tp
    return dims.n_q % tp == 0 and dims.n_kv % tp == 0


def _fsdp(plan: ParallelPlan):
    if not plan.fsdp_axes:
        return None
    return plan.fsdp_axes if len(plan.fsdp_axes) > 1 else plan.fsdp_axes[0]


def _leaf_spec(names: Sequence[str], nd: int, m, f, hs: bool) -> Tuple:
    last = names[-1]

    def pad(*tail) -> Tuple:
        """Left-pad with Nones for stacked layer/group dims."""
        return (None,) * (nd - len(tail)) + tail

    routed = "moe" in names and "shared" not in names
    if last == "embed":
        return (m, f)
    if last == "lm_head":
        return (f, m)
    if last in ("wq", "wk", "wv"):
        return pad(f, m) if hs else pad(f, None)
    if last == "wo":
        return pad(m, f) if hs else pad(None, f)
    if last in ("bq", "bk", "bv"):
        return pad(m) if hs else pad(None)
    if last in ("w1", "w3", "w2") and routed:  # (E, d, f) / (E, f, d), stacked (L, E, ...)
        tail = (m, None, f) if last == "w2" else (m, f, None)
        return (None,) * (nd - 3) + tail
    if last in ("w1", "w3"):
        return pad(f, m)
    if last == "w2":
        return pad(m, f)
    if last == "router":
        return pad(None, None)
    if last == "in_proj":
        return pad(f, m)
    if last == "out_proj":
        return pad(m, f)
    if last == "conv_w":
        return pad(None, m)
    if last in ("conv_b", "norm_w", "dt_bias", "A_log", "D"):
        return pad(m)
    # norms / scalars
    return pad(*((None,) * min(nd, 1)))


def map_paths(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, rebuilt as dicts."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, cfg: ModelConfig, plan: ParallelPlan):
    """The spec tree of ``params`` (a nested dict of tensors, meta tensors
    or DTensors, or a model); every spec is ``()`` without a mesh."""
    from ..models.lm import param_tree

    params = param_tree(params)
    if plan.mesh is None:
        return map_paths(lambda _, __: (), params)
    m, f, hs = plan.model_axis, _fsdp(plan), heads_shardable(cfg, plan)
    return map_paths(lambda path, leaf: _leaf_spec(path, leaf.ndim, m, f, hs), params)


def batch_specs(batch_shapes, plan: ParallelPlan):
    """Batch inputs: the leading dim over the DP axes."""
    return {k: (plan.b,) + (None,) * (len(v.shape) - 1) for k, v in batch_shapes.items()}


def spec_at(specs, path: str):
    """The spec at a ``/``-joined leaf path of a spec tree."""
    node = specs
    for key in path.split("/") if path else ():
        node = getattr(node, key) if dataclasses.is_dataclass(node) else node[key]
    return node


def spec_leaves(tree, specs):
    """``(path, leaf, spec)`` for every leaf of ``tree`` in leaf order."""
    return [(p, leaf, spec_at(specs, p)) for p, leaf in tree_util.flatten_with_path(tree)[0]]


def flat_specs(tree, specs) -> Dict[str, Tuple]:
    """``{path: spec}`` over the leaves of ``tree``."""
    return {p: s for p, _, s in spec_leaves(tree, specs)}


# ---------------------------------------------------------------------------
# placing tensors, and the model's view of them
# ---------------------------------------------------------------------------

def spec_entries(spec, ndim: int):
    """Per tensor dim, the tuple of axis names its entry shards over."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return [(e,) if isinstance(e, str) else tuple(e or ()) for e in spec]


def shard_local(full: torch.Tensor, spec, plan: ParallelPlan) -> torch.Tensor:
    """This rank's piece of a whole tensor under ``spec`` (no collective)."""
    out = full
    for dim, axes in enumerate(spec_entries(spec, full.ndim)):
        out = comm.local_slice(out, dim, plan.groups(axes))
    return out


def place(full: torch.Tensor, spec, plan: ParallelPlan):
    """A DTensor of ``full`` (whole on every rank) with ``spec``'s
    placements on the plan's mesh; each rank keeps its piece."""
    from torch.distributed.tensor import DTensor

    local = shard_local(full, spec, plan)
    if local is full:
        local = full.detach().clone() if full.requires_grad else full
    return DTensor.from_local(local, plan.mesh, plan.placements(spec), run_check=False,
                              shape=full.shape, stride=full.stride())


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x) -> torch.Tensor:
    """A DTensor's local tensor (the same storage), or ``x``."""
    return x.to_local() if is_dtensor(x) else x


def gather_axes(x: torch.Tensor, spec, plan: ParallelPlan, keep: Optional[str] = None) -> torch.Tensor:
    """A local piece made whole along every dim sharded over an axis other
    than ``keep`` (all-gathers, no autograd)."""
    for dim, axes in enumerate(spec_entries(spec, x.ndim)):
        axes = tuple(a for a in axes if a != keep)
        if axes:
            x = comm.all_gather(x, dim, plan.groups(axes))
    return x


def _gathers(spec, ndim: int, plan: ParallelPlan) -> list:
    """``(dim, groups, reduce)`` for each dim of a leaf sharded over axes
    other than the model axis: ``reduce`` where those axes split the batch
    (the gather's backward sums the ranks' gradients), not where they do
    not (every rank computed the same)."""
    batch = set(plan.present(plan.batch_axes))
    out = []
    for dim, axes in enumerate(spec_entries(spec, ndim)):
        axes = tuple(a for a in plan.present(axes) if a != plan.model_axis)
        if not axes or all(plan.axis_size(a) == 1 for a in axes):
            continue
        if all(a in batch for a in axes):
            out.append((dim, plan.groups(axes), True))
        elif not any(a in batch for a in axes):
            out.append((dim, plan.groups(axes), False))
        else:
            raise ValueError(f"spec entry {axes} mixes batch and other axes")
    return out


def fsdp_view(params, specs, plan: ParallelPlan):
    """The train step's view of this rank's shards (the FSDP gather, with
    autograd): each leaf whole but along the model axis.  A stacked layer
    leaf (under a top-level key ending in ``blocks``) stays this rank's
    shard, a :class:`comm.Sharded` that the layer loop gathers inside each
    layer; every other leaf is gathered here.  Each gather's backward
    leaves the gradient of this rank's shard, summed over the batch axes
    that shard it."""
    def view(path, leaf):
        gathers = _gathers(spec_at(specs, "/".join(path)), leaf.ndim, plan)
        if not gathers:
            return leaf
        shard = comm.Sharded(leaf, gathers)
        return shard if path[0].endswith("blocks") else shard.gather()

    return map_paths(view, params)


def model_local(params, cfg: ModelConfig, plan: ParallelPlan):
    """What the model computes on: each parameter whole but along a dim
    sharded over the model axis, where it holds this rank's piece.  A
    DTensor leaf is gathered over its other axes (the FSDP gather); a
    plain tensor is taken as whole on every rank and cut.  No mesh: the
    tree as it is."""
    from ..models.lm import param_tree

    params = param_tree(params)
    if plan.mesh is None:
        return params
    specs = param_specs(params, cfg, plan)
    m = plan.model_axis

    def view(path, leaf):
        spec = spec_at(specs, "/".join(path))
        if is_dtensor(leaf):
            return gather_axes(leaf.to_local(), spec, plan, keep=m)
        model_only = tuple(e if e == m else None for e in spec)
        return shard_local(leaf, model_only, plan)

    return map_paths(view, params)


#: replicated leaves that act on the residual stream's features, and the dim
#: that holds them: the norms' weights and biases, the MoE router's rows
_STREAM_DIMS = {"w": -1, "b": -1, "router": -2}


def stationary_local(params, cfg: ModelConfig, plan: ParallelPlan):
    """What the weight-stationary decode computes on
    (``plan.weight_stationary``): each parameter at its shard in
    ``param_specs`` placements, along the FSDP and the model axes alike (a
    DTensor's local tensor, no collective; a plain tensor, taken as whole
    on every rank, is cut to it).  A leaf that is whole over the FSDP axes
    but acts on the stream's features (:data:`_STREAM_DIMS`) is cut to
    this rank's features."""
    from ..models.lm import param_tree

    params = param_tree(params)
    specs = param_specs(params, cfg, plan)
    features = plan.feature_groups()

    def view(path, leaf):
        spec = spec_at(specs, "/".join(path))
        x = leaf.to_local() if is_dtensor(leaf) else shard_local(leaf, spec, plan)
        dim = _STREAM_DIMS.get(path[-1])
        if dim is not None:
            x = comm.local_slice(x, dim % x.ndim, features)
        return x

    return map_paths(view, params)
