"""Parallelism plan: how one model instance maps onto devices.

The JAX package's plan (``repro/parallel/plan.py``) places every tensor on
a ``jax.sharding.Mesh`` with three axes (``pod``, ``data``, ``model``) and
threads through the model code, where each sharding decision goes through
:meth:`ParallelPlan.ps` and :meth:`ParallelPlan.constrain`.  This port has
the single-device plan only (``mesh=None``): every constraint is the
identity, every axis has size 1, and :meth:`ParallelPlan.tp_project` is the
plain product.  The fields are all the reference's, so a plan is built and
``dataclasses.replace``-d as there (``kv_cache_dtype="int8"`` turns on the
quantized KV cache).  A plan on a ``torch.distributed`` ``DeviceMesh`` is
slice 11b of the port (``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    mesh: Optional[Any] = None
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
        if self.mesh is not None or self.bwd_cast_bf16:
            raise NotImplementedError(
                "a ParallelPlan with a mesh, or with bwd_cast_bf16 (a backward-pass "
                "lever), is slice 11b of the port (ROADMAP.md): this slice runs "
                "forward passes on one device (mesh=None)"
            )
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {self.kv_cache_dtype!r}")

    def grad_compression(self):
        """The resolved gradient-compression JitPolicy, or None when off."""
        if self.grad_policy or self.grad_compress_bits:
            from ..compression.grad import as_policy

            return as_policy(self.grad_policy or self.grad_compress_bits)
        return None

    # -- mesh facts (one device: every axis has size 1) ----------------------
    def axis_size(self, name: Optional[str]) -> int:
        return 1  # no mesh

    @property
    def tp(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def dp(self) -> int:
        return math.prod(self.axis_size(a) for a in self.batch_axes)

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

    # -- spec builders (no mesh: the empty spec, no sharding) ---------------
    def ps(self, *axes) -> Tuple:
        return ()

    def constrain(self, x: torch.Tensor, spec) -> torch.Tensor:
        return x

    # -- common activation constraints ---------------------------------------
    def act_btd(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, seq, d_model) activations."""
        return x

    def grad_barrier(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def tp_project(self, h: torch.Tensor, w: torch.Tensor, shardable: bool = True) -> torch.Tensor:
        """Output projection ``h @ w`` (the reference's explicit TP psum
        needs a mesh)."""
        return h @ w

    def act_heads(self, x: torch.Tensor, shardable: bool = True) -> torch.Tensor:
        return x


def single_device_plan(**kw) -> ParallelPlan:
    return ParallelPlan(mesh=None, **kw)

