"""FLOPs, memory traffic and collective wire bytes of one call of a torch
function, counted op by op (the counterpart of ``repro/launch/hlo_cost.py``).

The reference parses XLA's optimized HLO text.  The port has no HLO: it
runs eagerly, so it counts the call itself.  :func:`count` runs a function
under a ``TorchDispatchMode`` (on meta tensors or real ones) and charges
every aten and ``c10d`` op that reaches the dispatcher.  Per rank, as the
reference's figures are per device:

  flops            -- ``dot_flops`` + one FLOP per output element of every
                      other op that is not a view, metadata, allocation or
                      collective op (the reference's elementwise estimate)
  dot_flops        -- ``torch.utils.flop_counter.FlopCounterMode``'s count:
                      mm, bmm, addmm, baddbmm, convolution, attention
  hbm_bytes        -- each op's operand and result bytes: in eager mode
                      every op is a kernel boundary, the counterpart of the
                      reference's fusion boundary.  An in-place update
                      counts what it moves: ``copy_`` its source and its
                      destination (a view's slice), ``index_put_`` and the
                      other indexed writes twice their values plus their
                      indices, as the reference's ``dynamic-update-slice``
                      rule does
  collective_bytes -- each ``c10d`` op charged with the reference's ring
                      model (:func:`_collective_wire_bytes`) at its own
                      process group's size; ``log`` lists each one's kind,
                      input and output bytes and group size, in order

The reference multiplies a while loop's body by its trip count, because
XLA's cost analysis visits the body once.  Eager mode runs every trip, so
there are no loops to correct and :class:`Cost` has no ``while_trips``.

A DTensor op reaches the mode at its global shapes before DTensor unwraps
it; the count skips it and sees nothing of the local ops it runs, so
callers count functions that work on local tensors (the train and serve
steps do: they unwrap their DTensors first).  ``dtensor_ops`` records how
many were skipped.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: ops that move no data: metadata queries and allocations that write
#: nothing (the reference's ``parameter``, ``constant``, ``bitcast``, ...)
_SKIP_NAMES = {
    "_unsafe_view", "lift_fresh", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "resize_", "set_", "size", "stride",
    "dim", "is_same_size", "_local_scalar_dense", "device", "layout", "record_stream", "wait_tensor",
}

#: indexed in-place writes: charged twice their values plus their indices
_INDEXED_WRITES = {"index_put_", "_index_put_impl_", "index_copy_", "index_add_", "scatter_",
                   "scatter_add_", "scatter_reduce_"}

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

#: c10d op name -> the reference's collective kind
_COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}


@dataclasses.dataclass
class Cost:
    """Per-rank counts of one call (the reference's ``Cost`` without
    ``while_trips``; ``collectives`` counts the ops of each kind, ``log``
    holds ``(kind, input bytes, output bytes, group size)`` of each)."""

    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    collectives: Dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    log: List[Tuple[str, int, int, int]] = dataclasses.field(default_factory=list)
    dtensor_ops: int = 0

    def scaled(self, k: float) -> "Cost":
        c = Cost(flops=self.flops * k, dot_flops=self.dot_flops * k, hbm_bytes=self.hbm_bytes * k,
                 collective_bytes=self.collective_bytes * k)
        for kk, v in self.per_collective.items():
            c.per_collective[kk] = v * k
        return c

    def add(self, other: "Cost"):
        self.flops += other.flops
        self.dot_flops += other.dot_flops
        self.hbm_bytes += other.hbm_bytes
        self.collective_bytes += other.collective_bytes
        for kk, v in other.per_collective.items():
            self.per_collective[kk] += v
        for kk, v in other.collectives.items():
            self.collectives[kk] += v
        self.log.extend(other.log)
        self.dtensor_ops += other.dtensor_ops


def _collective_wire_bytes(kind: str, in_bytes: float, out_bytes: float, group: int) -> float:
    """The reference's ring model: bytes a device sends or receives."""
    r = max(2, group)
    if kind == "all-reduce":
        return 2.0 * in_bytes * (r - 1) / r
    if kind == "all-gather":
        return max(0, out_bytes - in_bytes)  # received bytes
    if kind == "reduce-scatter":
        return max(0, in_bytes - out_bytes)  # sent beyond own shard
    if kind == "all-to-all":
        return in_bytes * (r - 1) / r
    return in_bytes  # collective-permute


def _tensors(x, out=None) -> list:
    """The tensors in ``x``: a tensor, or lists, tuples and dicts of them
    (what op arguments hold)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(func, args, kwargs) -> int:
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    pg = named.get("process_group")
    if isinstance(pg, torch.ScriptObject):
        return int(dist.ProcessGroup.unbox(pg).size())
    if pg is not None:
        return int(pg.size())
    if "group_size" in named:
        return int(named["group_size"])
    if "group_name" in named:
        return int(c10d._resolve_process_group(named["group_name"]).size())
    raise ValueError(f"no process group in the arguments of {func}")


def _collective_io(func, args, kwargs, out) -> Tuple[int, int]:
    """Input and output bytes of a collective: its ``input*`` (or
    ``tensors``) and ``output*`` arguments, or its result where it has no
    output argument (the functional ops, and an all-reduce in place)."""
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    ins = sum(_nbytes(v) for k, v in named.items() if k.startswith("input") or k in ("tensors", "tensor", "self"))
    outs = sum(_nbytes(v) for k, v in named.items() if k.startswith("output"))
    if not outs:
        outs = _nbytes(out) if func.namespace != "c10d" else ins
    return ins, outs


class CostMode(TorchDispatchMode):
    """Charges every op dispatched under it to ``self.cost`` (all but
    ``dot_flops``, which :func:`count` takes from ``FlopCounterMode``)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dots = set(flop_registry)
        self._dtensor = DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._charge(func, args, kwargs, out)
        return out

    def _charge(self, func, args, kwargs, out) -> None:
        c = self.cost
        name = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        if any(isinstance(t, self._dtensor) for t in ins):
            c.dtensor_ops += 1
            return
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_KINDS.get(name)
            if kind is None:  # barriers, waits
                return
            ins, outs = _collective_io(func, args, kwargs, out)
            group = _group_size(func, args, kwargs)
            wire = _collective_wire_bytes(kind, ins, outs, group)
            c.collective_bytes += wire
            c.per_collective[kind] += wire
            c.collectives[kind] += 1
            c.log.append((kind, ins, outs, group))
            c.hbm_bytes += ins + outs
            return
        if func.is_view or name in _SKIP_NAMES or func.namespace not in ("aten", "prims"):
            return
        if func._overloadpacket not in self._dots:
            c.flops += sum(t.numel() for t in _tensors(out))
        if name == "copy_":
            c.hbm_bytes += _nbytes(args[0]) + _nbytes(args[1])
        elif name in _INDEXED_WRITES:
            rest = _nbytes((args[1:], kwargs))
            c.hbm_bytes += rest + _nbytes(args[-1] if isinstance(args[-1], torch.Tensor) else ())
        elif name.endswith("_") and args and isinstance(args[0], torch.Tensor):
            c.hbm_bytes += _nbytes(ins) + _nbytes(args[0])  # read all, write self
        else:
            c.hbm_bytes += _nbytes(ins) + _nbytes(out)


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, Cost]:
    """``(fn(*args, **kwargs), its Cost)``: the call run once under the
    counter, on whatever device its arguments are."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc, CostMode() as mode:
        out = fn(*args, **kwargs)
    cost = mode.cost
    cost.dot_flops = float(fc.get_total_flops())
    cost.flops += cost.dot_flops
    return out, cost
