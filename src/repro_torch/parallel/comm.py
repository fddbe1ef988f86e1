"""Collectives over the axes of a ``DeviceMesh``, each with its conjugate
in backward.

Inside a sharded step the model runs on local shards, and these functions
are the points where the reference's XLA partitioner would insert a
collective.  Every one that lies on the autograd path is an
``autograd.Function`` whose backward is the forward's conjugate, under the
convention of Megatron-style tensor parallelism: the cotangent of a tensor
that every rank of the group holds whole (replicated) is itself whole and
equal on every rank, and the cotangent of a rank's own part is that
rank's alone.

==================  ======================  ==========================
function            forward                 backward
==================  ======================  ==========================
``reduce_from``     all-reduce (sum)        identity
``copy_to``         identity                all-reduce (sum)
``gather_from``     all-gather along a dim  this rank's slice
``gather_to``       all-gather along a dim  reduce-scatter along it
``split_to``        this rank's slice       all-gather along the dim
``scatter_from``    reduce-scatter          all-gather along the dim
``mean_from``       all-reduce, then / n    identity
==================  ======================  ==========================

``copy_to`` goes where a replicated tensor enters rank-specific compute
(the input of a column-parallel product), ``reduce_from`` where the
partial sums of a row-parallel product become replicated.  ``gather_from``
feeds replicated compute, ``gather_to`` rank-specific compute.  Every
function is the identity on a group of one rank, so a mesh of size 1
computes what one device does, op for op.

:class:`Sharded` holds a parameter's shard until the model uses it, then
gathers it through these functions (the train step's FSDP gather).

A group here is a ``torch.distributed`` process group; a sequence of
groups stands for their product, major first (the reference's tuple entry
``("pod", "data")``): a gather runs over the minor group first, a
reduce-scatter over the major first, so each rank's piece sits where a
``jax.sharding`` placement over those axes puts it.
"""
from __future__ import annotations

import warnings
from typing import List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .. import tree as tree_util

Groups = Union[None, object, Sequence[object]]


def _groups(groups: Groups):
    if groups is None:
        return []
    if isinstance(groups, (list, tuple)):
        return [g for g in groups if dist.get_world_size(g) > 1]
    return [groups] if dist.get_world_size(groups) > 1 else []


def group_size(groups: Groups) -> int:
    n = 1
    for g in _groups(groups):
        n *= dist.get_world_size(g)
    return n


def group_rank(groups: Groups) -> int:
    """This rank's index in the product of the groups (major first)."""
    r = 0
    for g in _groups(groups):
        r = r * dist.get_world_size(g) + dist.get_rank(g)
    return r


def _quiet(fn, *args, **kw):
    # the *_tensor collectives are deprecated in newer torch for *_single
    # ones, which older versions lack
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(*args, **kw)


# ---------------------------------------------------------------------------
# the collectives themselves (no autograd)
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, groups: Groups, op=None) -> torch.Tensor:
    """A new tensor: ``x`` summed (or ``op``) over the groups."""
    out = x.detach().clone().contiguous()
    for g in _groups(groups):
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op, group=g)
    return out


def all_reduce_(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """``x`` itself, summed in place over the groups (a contiguous tensor
    the caller owns: no copy)."""
    for g in _groups(groups):
        dist.all_reduce(x, group=g)
    return x


def all_gather(x: torch.Tensor, dim: int, groups: Groups) -> torch.Tensor:
    """The pieces of every rank concatenated along ``dim`` (``x`` itself
    on a group of one)."""
    gs = _groups(groups)
    if not gs:
        return x
    out = x.detach()
    for g in reversed(gs):
        n = dist.get_world_size(g)
        moved = out.movedim(dim, 0).contiguous()
        whole = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]), dtype=moved.dtype, device=moved.device)
        _quiet(dist.all_gather_into_tensor, whole, moved, group=g)
        out = whole.movedim(0, dim)
    return out.contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, groups: Groups) -> torch.Tensor:
    """``x`` summed over the groups, of which this rank keeps its piece
    along ``dim`` (the dim must divide evenly; ``x`` itself on a group of
    one)."""
    gs = _groups(groups)
    if not gs:
        return x
    out = x.detach()
    for g in gs:
        n = dist.get_world_size(g)
        moved = out.movedim(dim, 0).contiguous()
        if moved.shape[0] % n:
            raise ValueError(f"a dim of {moved.shape[0]} does not split over {n} ranks")
        part = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]), dtype=moved.dtype, device=moved.device)
        _quiet(dist.reduce_scatter_tensor, part, moved, op=dist.ReduceOp.SUM, group=g)
        out = part.movedim(0, dim)
    return out.contiguous()


def local_slice(x: torch.Tensor, dim: int, groups: Groups) -> torch.Tensor:
    """This rank's piece of ``x`` along ``dim`` (even pieces)."""
    n = group_size(groups)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"a dim of {x.shape[dim]} does not split over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, group_rank(groups) * k, k).contiguous()


# ---------------------------------------------------------------------------
# on the autograd path
# ---------------------------------------------------------------------------

class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce(x, groups)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct, ctx.groups), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return all_gather(x, dim, groups)

    @staticmethod
    def backward(ctx, ct):
        return local_slice(ct, ctx.dim, ctx.groups), None, None


class _GatherTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups, wide):
        ctx.dim, ctx.groups, ctx.wide = dim, groups, wide
        return all_gather(x, dim, groups)

    @staticmethod
    def backward(ctx, ct):
        if ctx.wide and ct.dtype != torch.float32:
            return reduce_scatter(ct.to(torch.float32), ctx.dim, ctx.groups).to(ct.dtype), None, None, None
        return reduce_scatter(ct, ctx.dim, ctx.groups), None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return local_slice(x, dim, groups)

    @staticmethod
    def backward(ctx, ct):
        return all_gather(ct, ctx.dim, ctx.groups), None, None


class _ScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return reduce_scatter(x, dim, groups)

    @staticmethod
    def backward(ctx, ct):
        return all_gather(ct, ctx.dim, ctx.groups), None, None


class _MeanFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        n = group_size(groups)
        s = all_reduce(x, groups)
        return s / torch.full((), n, dtype=s.dtype, device=s.device)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def reduce_from(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    return x if group_size(groups) == 1 else _ReduceFrom.apply(x, groups)


def copy_to(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    return x if group_size(groups) == 1 else _CopyTo.apply(x, groups)


def gather_from(x: torch.Tensor, dim: int, groups: Groups) -> torch.Tensor:
    return x if group_size(groups) == 1 else _GatherFrom.apply(x, dim, groups)


def gather_to(x: torch.Tensor, dim: int, groups: Groups, wide: bool = False) -> torch.Tensor:
    """With ``wide`` the backward's reduce-scatter sums in float32 and
    rounds once to the cotangent's dtype."""
    return x if group_size(groups) == 1 else _GatherTo.apply(x, dim, groups, wide)


def split_to(x: torch.Tensor, dim: int, groups: Groups) -> torch.Tensor:
    return x if group_size(groups) == 1 else _SplitTo.apply(x, dim, groups)


def scatter_from(x: torch.Tensor, dim: int, groups: Groups) -> torch.Tensor:
    return x if group_size(groups) == 1 else _ScatterFrom.apply(x, dim, groups)


def mean_from(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """The mean over the groups; backward passes the cotangent through
    unscaled, since each rank's gradient is later averaged with the
    others' (the data-parallel mean)."""
    return x if group_size(groups) == 1 else _MeanFrom.apply(x, groups)


# ---------------------------------------------------------------------------
# a parameter gathered where it is used
# ---------------------------------------------------------------------------

class Sharded:
    """A parameter's local shard whose whole view is gathered where the
    model uses it: a stacked layer leaf, gathered layer by layer inside the
    layer loop (``models/lm.py``), so one layer's gathered weights live at
    a time and remat gathers them again in the backward pass.  ``gathers``
    lists ``(dim, groups, reduce)``: with ``reduce`` the gather is
    :func:`gather_to` (the ranks of the groups saw different rows, so the
    cotangent is reduce-scattered, summed in float32), else
    :func:`gather_from` (the ranks computed the same, so each keeps its
    slice)."""

    __slots__ = ("local", "gathers")

    def __init__(self, local: torch.Tensor, gathers: List[Tuple[int, list, bool]]):
        self.local, self.gathers = local, gathers

    def __getitem__(self, i: int) -> "Sharded":
        """Layer ``i`` of a stacked leaf (whose stacked dim is unsharded)."""
        if any(d == 0 for d, _, _ in self.gathers):
            raise ValueError("a stacked leaf's layer dim is sharded")
        return Sharded(self.local[i], [(d - 1, g, r) for d, g, r in self.gathers])

    def gather(self) -> torch.Tensor:
        x = self.local
        for d, g, r in self.gathers:
            x = gather_to(x, d, g, wide=True) if r else gather_from(x, d, g)
        return x


def gathered(tree):
    """``tree`` with each :class:`Sharded` leaf gathered."""
    return tree_util.tree_map(lambda t: t.gather() if isinstance(t, Sharded) else t, tree)
