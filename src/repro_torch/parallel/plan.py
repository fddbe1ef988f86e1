"""Parallelism plan: how one model instance maps onto devices.

The JAX package's plan (``repro/parallel/plan.py``) places every tensor on
a ``jax.sharding.Mesh`` with three axes (``pod``, ``data``, ``model``) and
threads through the model code, where each sharding decision goes through
:meth:`ParallelPlan.ps` and :meth:`ParallelPlan.constrain`.  Here ``mesh``
is ``None`` (one device) or a ``torch.distributed`` ``DeviceMesh`` with one
process per device, and the model code runs on each rank's local shards:

  * the batch splits over ``batch_axes`` (each rank takes its rows);
  * ``model`` (tensor and expert parallelism): attention heads, the MLP's
    hidden width, MoE experts and the vocabulary split over the axis.  A
    column-parallel product's input passes :func:`comm.copy_to`, a
    row-parallel product's partial sums are all-reduced
    (:meth:`tp_project`), the embedding and the loss are vocab-parallel;
  * ``fsdp_axes``: the train step's model gathers each parameter over
    these axes where it uses it, a layer's weights inside its layer, and
    the gather's backward reduce-scatters the gradient
    (``parallel.specs.fsdp_view``, ``train/step.py``);
  * ``seq_axes`` (sequence parallelism over the model axis): between
    blocks the residual stream holds this rank's slice of the sequence; a
    block gathers it at entry (:meth:`seq_gather`) and its output
    projection reduce-scatters instead of all-reducing;
  * ``decode_feature_shard`` with ``fsdp_axes`` (the weight-stationary
    decode, :attr:`weight_stationary`): a decode step keeps every weight
    at its FSDP shard.  The residual stream holds the whole batch and this
    rank's features (:meth:`feature_groups`); a product that contracts the
    features sums its float32 partial products over the FSDP axes
    (:func:`feature_product`), one whose output is the features writes
    this rank's slice, and the KV cache and SSM states keep their batch
    rows.  Prefill, the loss and the train step keep the gathered route.

Every collective goes through :mod:`.comm`, which pairs it with its
conjugate in backward.  On a group of one rank each is the identity, so a
mesh whose axes have size 1 computes what one device does, op for op.
``constrain`` stays the identity: the layouts are explicit.

``bwd_cast_bf16`` rounds the cotangent flowing backward through each block
entry and each ``act_btd`` point to bf16 (:class:`_Bf16GradBarrier`), with
or without a mesh, as the reference's ``custom_vjp`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from . import comm


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    mesh: Optional[Any] = None  # a torch.distributed DeviceMesh
    batch_axes: Tuple[str, ...] = ("data",)  # batch dim sharding
    model_axis: Optional[str] = "model"  # TP/EP axis
    fsdp_axes: Tuple[str, ...] = ()  # ZeRO-3 param sharding axes
    seq_axes: Tuple[str, ...] = ()  # sequence/context parallel axes
    remat: str = "full"  # "none" | "full" | "dots"
    microbatches: int = 1  # gradient-accumulation steps
    kv_cache_dtype: str = "bf16"  # "bf16" | "int8" (paper-technique lever)
    grad_compress_bits: int = 0  # 0 = off; 8/4 = error-bounded grad quant
    grad_policy: str = ""  # full jit-codec policy spec for the DP grad
    # reduction (e.g. "int8:eb=1e-6:bs=512:pred=zero+lorenzo1+mean");
    # wins over grad_compress_bits when set
    bwd_cast_bf16: bool = False  # cast activation cotangents to bf16 at block
    # boundaries -> backward TP all-reduces run at half width
    grad_accum_dtype: str = "float32"  # bf16 halves the per-microbatch
    # gradient reduce-scatter wire bytes (and the accumulator memory)
    manual_tp_psum: bool = False  # reduce row-parallel partial products in
    # the model dtype (without it: in float32, then cast)
    decode_feature_shard: bool = False  # shard the feature dim over the fsdp
    # axis at decode: products sum small partial activations over the axis
    # instead of gathering the weight shards every token (weight-stationary)

    def __post_init__(self):
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {self.kv_cache_dtype!r}")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be 'none', 'full' or 'dots', got {self.remat!r}")

    def grad_compression(self):
        """The resolved gradient-compression JitPolicy, or None when off."""
        if self.grad_policy or self.grad_compress_bits:
            from ..compression.grad import as_policy

            return as_policy(self.grad_policy or self.grad_compress_bits)
        return None

    # -- mesh facts ----------------------------------------------------------
    def _memo(self, key, fn):
        """``fn()`` once per ``key`` for this plan: the mesh facts below are
        read many times a decode step (a cache beside the frozen fields,
        outside equality and ``dataclasses.replace``)."""
        memo = self.__dict__.setdefault("_mesh_memo", {})
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    def axis_size(self, name: Optional[str]) -> int:
        if self.mesh is None or name is None or name not in self.mesh.mesh_dim_names:
            return 1
        return self._memo(("size", name), lambda: int(self.mesh.size(self.mesh.mesh_dim_names.index(name))))

    @property
    def tp(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def dp(self) -> int:
        return math.prod(self.axis_size(a) for a in self.batch_axes)

    def present(self, axes) -> Tuple[str, ...]:
        """The axes of ``axes`` that this plan's mesh has."""
        if self.mesh is None:
            return ()
        return tuple(a for a in axes if a in self.mesh.mesh_dim_names)

    def groups(self, axes) -> list:
        """The process groups of the mesh axes ``axes`` (a name or a tuple of
        names, major first) that this mesh has with more than one rank (a
        collective over one rank is the identity, ``comm``'s convention)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return list(self._memo(("groups", axes), lambda: [
            self.mesh.get_group(a) for a in self.present(axes) if self.axis_size(a) > 1]))

    def axis_rank(self, axes) -> int:
        """This process's coordinate on ``axes`` (major first)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())

        def rank():
            r = 0
            for a in self.present(axes):
                r = r * self.axis_size(a) + int(self.mesh.get_local_rank(a))
            return r

        return self._memo(("rank", axes), rank)

    @property
    def tp_groups(self) -> list:
        return self.groups(self.model_axis) if self.tp > 1 else []

    @property
    def tp_rank(self) -> int:
        return self.axis_rank(self.model_axis) if self.model_axis else 0

    def dp_groups(self) -> list:
        """The process groups of the batch axes (their collectives run the
        DP reduction)."""
        return self.groups(self.batch_axes)

    def dp_group(self):
        """The ``torch.distributed`` process group of the batch: one axis's
        group, or one group over every batch axis of the mesh (flattened)."""
        axes = self.present(self.batch_axes)
        if not axes:
            raise ValueError("the data-parallel reduction needs a ParallelPlan with a mesh that has a batch axis")
        big = [a for a in axes if self.axis_size(a) > 1]
        if len(big) <= 1:
            return self.mesh.get_group((big or list(axes))[0])
        return self.mesh[tuple(big)]._flatten().get_group()

    @property
    def dp_rank(self) -> int:
        """This process's coordinate on the batch axes: it takes rows
        ``[dp_rank * B / dp, (dp_rank + 1) * B / dp)`` of a global batch."""
        return self.axis_rank(self.batch_axes)

    def kv_repeat(self, n_kv: int, n_q: Optional[int] = None) -> int:
        """Virtual KV-head duplication so kv-heads shard evenly over TP
        (GQA -> wider GQA; mathematically identical, standard TP practice).
        Only applied when the duplicated head count still divides the query
        heads (whisper's 12 heads on TP=16 stay unduplicated + unsharded)."""
        tp = self.tp
        if tp <= 1 or n_kv % tp == 0:
            return 1
        rep = math.lcm(n_kv, tp) // n_kv
        if n_q is not None and (n_q % (n_kv * rep) != 0 or n_q % tp != 0):
            return 1
        return rep

    @property
    def b(self):
        """Batch-dim spec entry: tuple of axes, single axis, or None."""
        if not self.batch_axes:
            return None
        return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]

    # -- spec builders: a spec is the tuple of axis entries (no mesh: empty) --
    def ps(self, *axes) -> Tuple:
        if self.mesh is None:
            return ()
        return tuple(axes)

    def placements(self, spec) -> list:
        """The DTensor placements of ``spec`` on this plan's mesh: each
        mesh axis named on a tensor dim is ``Shard(dim)``, every other axis
        ``Replicate()``.  A tuple entry shards its dim over its axes major
        to minor, which must be the mesh's order of them."""
        from torch.distributed.tensor import Replicate, Shard

        names = self.mesh.mesh_dim_names
        out = [Replicate() for _ in names]
        for dim, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            idx = [names.index(a) for a in axes if a in names]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry!r} names mesh axes out of the mesh's order {names}")
            for i in idx:
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"mesh axis {names[i]!r} shards two dims of spec {spec!r}")
                out[i] = Shard(dim)
        return out

    def constrain(self, x: torch.Tensor, spec) -> torch.Tensor:
        """The identity: the port's layouts are explicit (see the module
        docstring)."""
        return x

    # -- the residual stream's layout -----------------------------------------
    def _seq_groups(self) -> list:
        axes = self.present(self.seq_axes)
        if not axes or all(self.axis_size(a) == 1 for a in axes):
            return []
        if len(axes) > 1 or axes[0] in self.batch_axes:
            raise ValueError(f"sequence parallelism runs over one mesh axis outside the batch axes, got {axes}")
        return self.groups(axes)

    def _sp_over_model(self) -> bool:
        return self.tp > 1 and self.present(self.seq_axes) == (self.model_axis,)

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream (B, S_local, d) whole along the sequence, for
        the replicated compute of a block's entry (its norm)."""
        return comm.gather_from(x, 1, self._seq_groups())

    def to_stream(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated (B, S, d) activation in the stream's layout: this
        rank's slice of the sequence under sequence parallelism."""
        return comm.split_to(x, 1, self._seq_groups())

    def reduce_to_stream(self, y: torch.Tensor) -> torch.Tensor:
        """Partial sums over the model axis (B, S, d), summed into the
        stream's layout: a reduce-scatter along the sequence under
        sequence parallelism over the model axis, else an all-reduce."""
        if self._sp_over_model():
            return comm.scatter_from(y, 1, self.tp_groups)
        return self.to_stream(comm.reduce_from(y, self.tp_groups))

    def tp_enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated activation entering rank-specific compute (a
        column-parallel product, this rank's experts): the identity, whose
        backward sums the ranks' cotangents over the model axis."""
        return comm.copy_to(x, self.tp_groups)

    # -- common activation constraints ---------------------------------------
    def act_btd(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, seq, d_model) activations: already in the stream's layout
        here; the bf16 cotangent barrier when ``bwd_cast_bf16``."""
        if self.bwd_cast_bf16:
            x = _bf16_grad_barrier(x)
        return x

    def grad_barrier(self, x: torch.Tensor) -> torch.Tensor:
        """Cast the cotangent flowing backward through this point to bf16
        (placed at layer-block entry)."""
        if self.bwd_cast_bf16:
            return _bf16_grad_barrier(x)
        return x

    def tp_project(self, h: torch.Tensor, w: torch.Tensor, shardable: bool = True) -> torch.Tensor:
        """Output projection ``h @ w`` into the stream's layout.

        Under tensor parallelism with ``shardable``, ``h`` (..., F) holds
        this rank's features and ``w`` (F, D) its rows: the local product's
        partial sums are reduced over the model axis.  With
        ``manual_tp_psum`` they are reduced in ``h.dtype`` (the reference's
        explicit psum); without it the product keeps its float32
        accumulator, which is reduced and then cast: what the reference's
        partitioner does on the CPU.  Otherwise ``h @ w`` is whole on every
        rank."""
        if self.tp == 1 or not shardable:
            return self.to_stream(h @ w)
        if self.manual_tp_psum:
            return self.reduce_to_stream(h @ w)
        return self.reduce_to_stream(_float32_product(h, w)).to(h.dtype)

    def act_heads(self, x: torch.Tensor, shardable: bool = True) -> torch.Tensor:
        """(batch, seq, heads, head_dim): this rank's heads where they
        shard."""
        return x

    # -- the weight-stationary decode -----------------------------------------
    @property
    def weight_stationary(self) -> bool:
        """Whether a decode step keeps every weight at its FSDP shard (the
        reference's ``act_btd`` under ``decode_feature_shard``): the flag,
        with FSDP axes on this plan's mesh."""
        return bool(self.decode_feature_shard and self.present(self.fsdp_axes))

    def feature_groups(self) -> list:
        """The groups of the FSDP axes (major first; those of one rank
        left out), over which the weight-stationary decode's stream splits
        its features: this rank holds the piece ``comm.local_slice(x, -1,
        feature_groups())``, where ``param_specs`` puts its shard of every
        weight."""
        return self.groups(self.fsdp_axes)


class _Bf16ProductFloat32Out(torch.autograd.Function):
    """``h @ w`` of 2-D bf16 operands with the float32 accumulator as the
    output (cuBLAS's bf16 GEMM, ``mm`` with ``out_dtype``, which has no
    derivative of its own).  Backward: bf16 GEMMs of the cotangent in
    bf16, which is exact where the output is later cast to bf16, as in
    :meth:`ParallelPlan.tp_project` (the cotangent is then a bf16 value)."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, ct):
        h, w = ctx.saved_tensors
        ct = ct.to(h.dtype)
        dh = ct @ w.t() if ctx.needs_input_grad[0] else None
        dw = h.t() @ ct if ctx.needs_input_grad[1] else None
        return dh, dw


def _float32_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` with its float32 accumulator as the output.  On the card
    a bf16 product with a 2-D ``w`` stays on the bf16 tensor-core path
    (:class:`_Bf16ProductFloat32Out`); elsewhere (a batched ``w``, the CPU,
    a torch without ``mm``'s ``out_dtype``) the operands are cast up, which gives the same
    value: a product of two bf16 numbers is exact in float32, and both sum
    in float32."""
    if h.dtype == torch.float32 and w.dtype == torch.float32:
        return h @ w
    if h.is_cuda and w.ndim == 2 and h.dtype == w.dtype == torch.bfloat16 and hasattr(torch.ops.aten.mm, "dtype"):
        h2 = h.reshape(-1, h.shape[-1])
        y = _Bf16ProductFloat32Out.apply(h2, w) if torch.is_grad_enabled() else \
            torch.mm(h2, w, out_dtype=torch.float32)
        return y.reshape(*h.shape[:-1], w.shape[-1])
    return torch.matmul(h.to(torch.float32), w.to(torch.float32))


def feature_product(x: torch.Tensor, w: torch.Tensor, groups=None) -> torch.Tensor:
    """``x @ w`` where ``x`` (..., F) holds this rank's piece of the
    features split over ``groups`` and ``w`` (..., F, N) the matching rows
    (the weight-stationary decode, ``ParallelPlan.feature_groups``): this
    rank's partial product keeps its float32 accumulator, is summed over
    the groups, then cast to ``x``'s dtype, as
    :meth:`ParallelPlan.tp_project` sums its partial products (no autograd:
    the decode runs under ``no_grad``).  ``groups`` None, or of one rank:
    ``x @ w`` itself."""
    return feature_products(x, [w], groups)[0]


def feature_products(x: torch.Tensor, ws, groups=None) -> list:
    """:func:`feature_product` of ``x`` with each of ``ws`` (the same
    leading dims), their partial products summed in one all-reduce."""
    if comm.group_size(groups) == 1:
        return [x @ w for w in ws]
    parts = [_float32_product(x, w) for w in ws]
    total = comm.all_reduce_(torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0].contiguous(), groups)
    return [t.to(x.dtype) for t in torch.split(total, [p.shape[-1] for p in parts], dim=-1)]


def single_device_plan(**kw) -> ParallelPlan:
    return ParallelPlan(mesh=None, **kw)


class _Bf16GradBarrier(torch.autograd.Function):
    """The identity forward; backward rounds the cotangent through bf16 and
    back to the input's dtype (the reference's ``custom_vjp`` barrier)."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(torch.bfloat16).to(ctx.dtype)


def _bf16_grad_barrier(x: torch.Tensor) -> torch.Tensor:
    return _Bf16GradBarrier.apply(x)
