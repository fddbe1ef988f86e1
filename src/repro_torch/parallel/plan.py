"""Parallelism plan: how one model instance maps onto devices.

The JAX package's plan (``repro/parallel/plan.py``) places every tensor on
a ``jax.sharding.Mesh`` with three axes (``pod``, ``data``, ``model``) and
threads through the model code, where each sharding decision goes through
:meth:`ParallelPlan.ps` and :meth:`ParallelPlan.constrain`.  Here ``mesh``
is ``None`` (one device) or a ``torch.distributed`` ``DeviceMesh`` for data
parallelism: every rank holds the whole model and its rows of the batch,
and the train step reduces the gradients over the group of the batch axis
(:meth:`ParallelPlan.dp_group`).  On such a mesh every constraint is the
identity, as it is without one, and :meth:`ParallelPlan.tp_project` is the
plain product.

Tensor parallelism (a ``model`` axis above 1), FSDP (``fsdp_axes``),
sequence parallelism (``seq_axes``), ``manual_tp_psum`` and
``decode_feature_shard`` on a mesh are slice 11d of the port
(``ROADMAP.md``) and raise ``NotImplementedError``.  Without a mesh those
fields change nothing, as in the reference.

``bwd_cast_bf16`` rounds the cotangent flowing backward through each block
entry and each ``act_btd`` constraint to bf16 (:class:`_Bf16GradBarrier`),
with or without a mesh, as the reference's ``custom_vjp`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch


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
    manual_tp_psum: bool = False  # explicit bf16 TP reductions (mesh only)
    decode_feature_shard: bool = False  # shard the feature dim over the fsdp
    # axis at decode (mesh only)

    def __post_init__(self):
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {self.kv_cache_dtype!r}")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be 'none', 'full' or 'dots', got {self.remat!r}")
        if self.mesh is None:
            return
        sharded = [f"a '{self.model_axis}' axis of {self.tp}"] if self.tp > 1 else []
        sharded += [name for name in ("fsdp_axes", "seq_axes", "manual_tp_psum", "decode_feature_shard")
                    if getattr(self, name)]
        present = [a for a in self.batch_axes if a in self.mesh.mesh_dim_names and self.axis_size(a) > 1]
        if len(present) > 1:
            sharded.append(f"data parallelism over {len(present)} axes {tuple(present)}")
        others = [a for a in self.mesh.mesh_dim_names
                  if a not in self.batch_axes and a != self.model_axis and self.axis_size(a) > 1]
        sharded += [f"a mesh axis '{a}' of {self.axis_size(a)} outside the batch axes" for a in others]
        if sharded:
            raise NotImplementedError(
                "sharded training (" + ", ".join(sharded) + ") is slice 11d of the port (ROADMAP.md): "
                "this port runs data parallelism on a DeviceMesh whose model axis has size 1"
            )

    def grad_compression(self):
        """The resolved gradient-compression JitPolicy, or None when off."""
        if self.grad_policy or self.grad_compress_bits:
            from ..compression.grad import as_policy

            return as_policy(self.grad_policy or self.grad_compress_bits)
        return None

    # -- mesh facts ----------------------------------------------------------
    def axis_size(self, name: Optional[str]) -> int:
        if self.mesh is None or name is None or name not in self.mesh.mesh_dim_names:
            return 1
        return int(self.mesh.size(self.mesh.mesh_dim_names.index(name)))

    @property
    def tp(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def dp(self) -> int:
        return math.prod(self.axis_size(a) for a in self.batch_axes)

    def _dp_axis(self) -> Optional[str]:
        """The mesh axis the batch is split over (one at most, see
        ``__post_init__``), or None without one."""
        if self.mesh is None:
            return None
        axes = [a for a in self.batch_axes if a in self.mesh.mesh_dim_names]
        big = [a for a in axes if self.axis_size(a) > 1]
        return (big or axes or [None])[0]

    def dp_group(self):
        """The ``torch.distributed`` process group of the batch axis (its
        collectives run the DP reduction)."""
        axis = self._dp_axis()
        if axis is None:
            raise ValueError("the data-parallel reduction needs a ParallelPlan with a mesh that has a batch axis")
        return self.mesh.get_group(axis)

    @property
    def dp_rank(self) -> int:
        """This process's coordinate on the batch axis: it takes rows
        ``[dp_rank * B / dp, (dp_rank + 1) * B / dp)`` of a global batch."""
        axis = self._dp_axis()
        return 0 if axis is None else int(self.mesh.get_local_rank(axis))

    def kv_repeat(self, n_kv: int, n_q: Optional[int] = None) -> int:
        """Virtual KV-head duplication so kv-heads shard evenly over TP; 1
        without tensor parallelism."""
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

    def constrain(self, x: torch.Tensor, spec) -> torch.Tensor:
        """The identity: without a mesh, and on a data-parallel mesh, where
        every rank holds its activations whole."""
        return x

    # -- common activation constraints ---------------------------------------
    def act_btd(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, seq, d_model) activations."""
        x = self.constrain(x, self.ps(self.b, None, None))
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
        """Output projection ``h @ w`` (the reference's explicit TP psum is
        slice 11d)."""
        return h @ w

    def act_heads(self, x: torch.Tensor, shardable: bool = True) -> torch.Tensor:
        return self.constrain(x, self.ps(self.b, None, self.model_axis if shardable else None, None))


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
