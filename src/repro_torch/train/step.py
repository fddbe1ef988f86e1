"""Train-step factory: microbatched, remat'd, data-parallel, optionally with
error-bounded gradient compression on the DP reduction
(``repro/train/step.py``).

State = ``{params, opt{m, v, step}, feedback?}`` under the reference's
paths, so checkpoints cross between the packages.  ``params`` holds the
model's tensors (not requiring grad); each step takes gradients of
detached aliases of them with ``torch.autograd.grad``, in the leaf order of
:mod:`repro_torch.tree` (the reference's ``jax.tree.leaves`` order, which
the gradient codec's block boundaries follow), and then writes the new
parameters and moments back into the same tensors (``adamw.update_``) —
the port's form of the reference's ``donate_argnums``.

Three reductions, as in the reference:

  * one device (``plan.mesh is None``): none;
  * data parallel on a ``DeviceMesh`` (``plan.dp > 1``): each rank takes
    its rows of the global batch; the gradients are summed over the batch
    axis's group and divided by ``dp`` (a true divide): the mean that the
    reference's XLA inserts;
  * compressed (``plan.grad_compression()``): ``compressed_reduce_tree``
    on the batch axis's group (reduce-scatter bf16, error feedback, jit
    codec, all-gather of the codes), and the loss averaged over the group.

On the card, bf16 products should accumulate in float32 as XLA's do: the
launcher runs its steps inside ``models.common.float32_bf16_reductions``.
``state_specs`` and ``jit_train_step`` (sharded placements) are slice 11d
of the port (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import models
from .. import tree as tree_util
from ..compression import grad as gradc
from ..core.quantizers import true_div
from ..models.common import ModelConfig
from ..optim import AdamWConfig, adamw, warmup_cosine
from ..parallel.plan import ParallelPlan


def init_train_state(key, cfg: ModelConfig, plan: ParallelPlan, opt_cfg: AdamWConfig, device=None) -> Dict[str, Any]:
    """Parameters drawn from ``key`` (an int seed or a ``torch.Generator``)
    on ``device`` (default ``"cuda"``), zero moments, and with gradient
    compression this rank's zero feedback shard."""
    model = models.init_params(key, cfg, plan, device=device)
    params = tree_util.tree_map(lambda t: t.detach(), model.tree())
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    if plan.grad_compression() is not None:
        state["feedback"] = gradc.init_feedback(params, plan.dp)
    return state


def _value_and_grad(loss_fn: Callable, leaves: Sequence[torch.Tensor], batch) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    with torch.enable_grad():
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss = loss_fn(live, batch)
        # a parameter the loss does not read (a VLM's embedding) gets zeros,
        # as under jax.grad
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), list(grads)


def _microbatched_grads(loss_fn: Callable, leaves: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor],
                        n_micro: int, accum_dtype: torch.dtype = torch.float32):
    """``(loss, grads)`` of ``loss_fn(leaves, batch)``.  With ``n_micro > 1``
    the batch splits into ``n_micro`` equal microbatches along its first
    axis; gradients accumulate in ``accum_dtype`` and, like the loss, are
    multiplied by ``1 / n_micro`` and returned as float32.  Otherwise the
    gradients keep the parameters' dtype."""
    if n_micro <= 1:
        return _value_and_grad(loss_fn, leaves, batch)
    rows = next(iter(batch.values())).shape[0]
    if rows % n_micro:
        raise ValueError(f"a batch of {rows} rows does not split into {n_micro} microbatches")
    per = rows // n_micro
    loss_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    g_acc = [torch.zeros(t.shape, dtype=accum_dtype, device=t.device) for t in leaves]
    for i in range(n_micro):
        mb = {k: v[i * per : (i + 1) * per] for k, v in batch.items()}
        loss, g = _value_and_grad(loss_fn, leaves, mb)
        for a, b in zip(g_acc, g):
            a.add_(b.to(accum_dtype))  # in place: no second accumulator at full size
        loss_acc.add_(loss)
        del g
    inv = 1.0 / n_micro
    return loss_acc * inv, [g.to(torch.float32) * inv for g in g_acc]


def _group_mean(x: torch.Tensor, group, dp: int) -> torch.Tensor:
    """The mean of ``x`` over the group: a sum, then a true divide."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return true_div(out, float(dp))


def make_train_step(
    cfg: ModelConfig,
    plan: ParallelPlan,
    opt_cfg: AdamWConfig = AdamWConfig(),
    total_steps: int = 10000,
    attn_mode: str = "blocked",
) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.  The state
    is updated in place and returned; ``batch`` is this rank's rows (on the
    parameters' device); metrics are ``loss`` and ``grad_norm`` (float32
    scalars on the device, the loss averaged over the data-parallel group)."""
    grad_pol = plan.grad_compression()
    if grad_pol is not None and plan.mesh is None:
        raise ValueError("compressed gradient reduction needs a ParallelPlan with a mesh (--mesh data=N)")
    group = plan.dp_group() if plan.mesh is not None else None
    dp = plan.dp
    accum_dtype = getattr(torch, plan.grad_accum_dtype)

    def train_step(state, batch):
        leaves, treedef = tree_util.flatten(state["params"])

        def loss_fn(live, b):
            return models.loss_fn(tree_util.unflatten(treedef, live), b, cfg, plan, attn_mode=attn_mode)

        loss, grads = _microbatched_grads(loss_fn, leaves, batch, plan.microbatches, accum_dtype)
        with torch.no_grad():
            if grad_pol is not None:
                reduced, fb = gradc.compressed_reduce_tree(
                    tree_util.unflatten(treedef, grads), state["feedback"], group, grad_pol)
                grads = tree_util.flatten(reduced)[0]
                state["feedback"].copy_(fb)
                loss = _group_mean(loss, group, dp)
            elif dp > 1:
                for g in grads:
                    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
                grads = [true_div(g, float(dp)) for g in grads]
                loss = _group_mean(loss, group, dp)
            lr_scale = warmup_cosine(state["opt"]["step"], total=total_steps)
            metrics = adamw.update_(state["params"], tree_util.unflatten(treedef, grads), state["opt"], opt_cfg,
                                    lr_scale)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def state_specs(*args, **kwargs):
    raise NotImplementedError("sharded state placements are slice 11d of the port (ROADMAP.md)")


def jit_train_step(*args, **kwargs):
    raise NotImplementedError(
        "the sharded, ahead-of-time train step (jit_train_step) is slice 11d of the port (ROADMAP.md)"
    )
