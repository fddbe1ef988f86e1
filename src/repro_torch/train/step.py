"""Train-step factory: microbatched, remat'd, on one device or a mesh,
optionally with error-bounded gradient compression on the DP reduction
(``repro/train/step.py``).

State = ``{params, opt{m, v, step}, feedback?}`` under the reference's
paths, so checkpoints cross between the packages.  ``params`` holds the
model's tensors (not requiring grad); each step takes gradients of
detached aliases of them with ``torch.autograd.grad``, in the leaf order of
:mod:`repro_torch.tree` (the reference's ``jax.tree.leaves`` order, which
the gradient codec's block boundaries follow), and then writes the new
parameters and moments back into the same tensors, leaf by leaf: the
port's form of the reference's ``donate_argnums``.

One step serves every plan.  On a mesh the state's leaves are DTensors in
:func:`state_specs` placements (replicated on a mesh of batch axes alone,
where each rank takes its rows of the global batch).  The model runs on
this rank's shards: each parameter is gathered over its non-model axes
where it is used (``parallel.specs.fsdp_view``: a layer's weights inside
its layer, so under remat one layer's gathered weights live at a time),
and that gather's backward reduce-scatters the gradient over the batch
axes that shard it, so the microbatches accumulate gradients at the
shards' size.  Tensor, expert and sequence parallelism run inside the
model (``parallel/plan.py``).  Each gradient is then all-reduced over the
other batch axes and divided by ``dp`` (a true divide: the mean that the
reference's XLA inserts); tensor parallel gradients stay local.  The grad
norm sums each shard once over the whole mesh, and a compressed moment
whose last dim is sharded is decoded and re-encoded on whole rows, as the
reference's are.  Without a mesh every collective is skipped.

With gradient compression (``plan.grad_compression()``) the reduction is
``compressed_reduce_tree`` on the batch group (reduce-scatter bf16, error
feedback, jit codec, all-gather of the codes), and the loss is averaged
over the group.  The parameters are then replicated over every axis, the
model runs whole on each rank (a model axis duplicates work) and only the
feedback is sharded, over the batch axes: the reference's layout.

On the card, bf16 products should accumulate in float32 as XLA's do: the
launcher runs its steps inside ``models.common.float32_bf16_reductions``.
:func:`jit_train_step` is the mesh's entry point: it takes the state in
:func:`state_specs` placements and the global batch (or its DTensor in
``parallel.specs.batch_specs`` placements); there is no compile.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import models
from .. import tree as tree_util
from ..compression import grad as gradc
from ..compression import opt_state as oc
from ..core.quantizers import true_div
from ..models.common import ModelConfig
from ..models.lm import param_tree
from ..optim import AdamWConfig, adamw, warmup_cosine
from ..parallel import comm
from ..parallel import specs as sp
from ..parallel.plan import ParallelPlan

#: Compressed-moment side channels: the parameter's spec with an unsharded
#: blocks dim (codes keeps the full spec)
_SIDE_CHANNELS = ("scale", "tags", "base")


def _moment_spec(moment, pspec: Tuple):
    """A moment's spec from its parameter's: the same for a float32 moment;
    for a compressed one, a ``Compressed`` holding each array's spec."""
    if not isinstance(moment, oc.Compressed):
        return pspec
    entries = tuple(pspec) + (None,) * (moment.codes.ndim - len(tuple(pspec)))
    side = entries[:-1] + (None,)
    return dataclasses.replace(moment, codes=entries, **{k: side for k in _SIDE_CHANNELS})


def _replicated(moment, plan: ParallelPlan):
    if isinstance(moment, oc.Compressed):
        return dataclasses.replace(moment, **{k: plan.ps() for k in oc.Compressed.ARRAYS})
    return plan.ps()


def state_specs(state, cfg: ModelConfig, plan: ParallelPlan, opt_cfg: AdamWConfig):
    """The spec tree of a train state (the reference's ``state_specs``):
    parameters by ``param_specs``, each moment by its parameter's (a
    compressed moment's ``codes`` by the parameter's spec, its side
    channels with the last dim unsharded), ``step`` replicated.  With
    gradient compression on a mesh everything is replicated but
    ``feedback``, which splits over the batch axes."""
    params = param_tree(state["params"] if isinstance(state, dict) and "params" in state else state)
    pspecs = sp.param_specs(params, cfg, plan)
    _, treedef = tree_util.flatten(params)
    flat_p = [s for _, _, s in sp.spec_leaves(params, pspecs)]

    def moments(tree, fn):
        return tree_util.unflatten(treedef, [fn(m, s) for m, s in zip(tree_util.flatten_up_to(treedef, tree), flat_p)])

    comp = plan.grad_compression() is not None
    if comp and plan.mesh is not None:
        specs = {
            "params": sp.map_paths(lambda _, __: plan.ps(), params),
            "opt": {k: moments(state["opt"][k], lambda m, _: _replicated(m, plan)) for k in ("m", "v")},
        }
    else:
        specs = {"params": pspecs, "opt": {k: moments(state["opt"][k], _moment_spec) for k in ("m", "v")}}
    specs["opt"]["step"] = plan.ps()
    if comp:
        specs["feedback"] = (plan.b,)
    return specs


def _place_state(state, cfg: ModelConfig, plan: ParallelPlan, opt_cfg: AdamWConfig):
    """The state (whole on every rank, and this rank's feedback shard) as
    DTensors in :func:`state_specs` placements."""
    from torch.distributed.tensor import DTensor

    specs = state_specs(state, cfg, plan, opt_cfg)
    rest = {k: v for k, v in state.items() if k != "feedback"}
    flat, treedef = tree_util.flatten_with_path(rest)
    out = tree_util.unflatten(treedef, [sp.place(t, sp.spec_at(specs, p), plan) for p, t in flat])
    if "feedback" in state:
        fb = state["feedback"]
        out["feedback"] = DTensor.from_local(fb, plan.mesh, plan.placements(specs["feedback"]), run_check=False,
                                             shape=(plan.dp * fb.shape[0],), stride=(1,))
    return out


def init_train_state(key, cfg: ModelConfig, plan: ParallelPlan, opt_cfg: AdamWConfig, device=None) -> Dict[str, Any]:
    """Parameters drawn from ``key`` (an int seed or a ``torch.Generator``)
    on ``device`` (default ``"cuda"``), zero moments, and with gradient
    compression this rank's zero feedback shard.  On a mesh the
    whole state is drawn exactly as without a mesh, then placed: every
    leaf a DTensor in :func:`state_specs` placements, this rank holding its
    piece."""
    model = models.init_params(key, cfg, plan, device=device)
    params = tree_util.tree_map(lambda t: t.detach(), model.tree())
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    if plan.grad_compression() is not None:
        state["feedback"] = gradc.init_feedback(params, plan.dp)
    if plan.mesh is not None:
        state = _place_state(state, cfg, plan, opt_cfg)
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


def _group_mean(x: torch.Tensor, groups, dp: int) -> torch.Tensor:
    """The mean of ``x`` over the groups: a sum, then a true divide."""
    return true_div(comm.all_reduce(x, groups), float(dp))


def _reduce_grad(g: torch.Tensor, spec, plan: ParallelPlan) -> torch.Tensor:
    """The gradient of this rank's shard of a parameter (already summed
    over the batch axes that shard it, by the FSDP gathers' backward) as
    the mean over the batch: all-reduced over the other batch axes,
    divided by ``dp``."""
    named = {a for axes in sp.spec_entries(spec, g.ndim) for a in axes}
    g = comm.all_reduce(g, plan.groups(tuple(a for a in plan.present(plan.batch_axes) if a not in named)))
    return true_div(g, float(plan.dp)) if plan.dp > 1 else g


def _owner(spec, ndim: int, plan: ParallelPlan) -> bool:
    """Whether this rank counts its shard of a leaf in a sum over the mesh:
    coordinate 0 on every axis the leaf is replicated over."""
    if plan.mesh is None:
        return True
    named = {a for axes in sp.spec_entries(spec, ndim) for a in axes}
    return all(plan.axis_rank(a) == 0 for a in plan.mesh.mesh_dim_names if a not in named)


def _local_moment(m):
    if isinstance(m, oc.Compressed):
        return dataclasses.replace(m, **{k: sp.local(getattr(m, k)) for k in oc.Compressed.ARRAYS})
    return sp.local(m)


def _update_(params, grads: List[torch.Tensor], opt_state, pspecs: List, opt_cfg: AdamWConfig, lr_scale,
             plan: ParallelPlan):
    """AdamW in place on this rank's shards, leaf by leaf (one leaf's
    temporaries live at a time): the grad norm sums each shard once over
    the mesh (in leaf order, as one device does), and a compressed moment
    whose last dim is sharded is decoded and re-encoded on rows gathered
    whole along it."""
    flat_p, treedef = tree_util.flatten(params)
    m_l = [_local_moment(m) for m in tree_util.flatten_up_to(treedef, opt_state["m"])]
    v_l = [_local_moment(v) for v in tree_util.flatten_up_to(treedef, opt_state["v"])]
    step_l = sp.local(opt_state["step"])
    owners = [_owner(s, p.ndim, plan) for p, s in zip(flat_p, pspecs)]

    def over_mesh(sums):
        vec = torch.stack([x if own else torch.zeros_like(x) for x, own in zip(sums, owners)])
        return list(comm.all_reduce(vec, [dist.group.WORLD]).unbind(0))

    local_state = {"m": tree_util.unflatten(treedef, m_l), "v": tree_util.unflatten(treedef, v_l), "step": step_l}
    step, gnorm, upd = adamw.leaf_update(tree_util.unflatten(treedef, grads), local_state, opt_cfg, lr_scale,
                                          reduce=over_mesh if plan.mesh is not None else None)
    for p, g, m, v, spec in zip(flat_p, grads, m_l, v_l, pspecs):
        p = sp.local(p)
        last = sp.spec_entries(spec, p.ndim)[-1] if p.ndim else ()
        groups = plan.groups(tuple(a for a in last if plan.axis_size(a) > 1))
        if opt_cfg.compress_moments and groups:
            def whole(c):
                return dataclasses.replace(c, codes=comm.all_gather(c.codes, -1, groups))

            p_new, m_new, v_new = upd(comm.all_gather(p, -1, groups), comm.all_gather(g, -1, groups), whole(m), whole(v))
            p_new = comm.local_slice(p_new, -1, groups)
            m_new, v_new = (dataclasses.replace(c, codes=comm.local_slice(c.codes, -1, groups)) for c in (m_new, v_new))
        else:
            p_new, m_new, v_new = upd(p, g, m, v)
        p.copy_(p_new)
        adamw.write_(m, m_new)
        adamw.write_(v, v_new)
        del p_new, m_new, v_new
    step_l.copy_(step)
    return {"grad_norm": gnorm}


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
    scalars on the device, the loss averaged over the data-parallel
    group).  On a mesh the state's leaves are DTensors
    (:func:`init_train_state`)."""
    grad_pol = plan.grad_compression()
    if grad_pol is not None and plan.mesh is None:
        raise ValueError("compressed gradient reduction needs a ParallelPlan with a mesh (--mesh data=N)")
    # compressed: the model runs whole on every rank, the plan's mesh only
    # carries the batch (the reference's fully manual region)
    inner = dataclasses.replace(plan, model_axis=None, fsdp_axes=(), seq_axes=()) if grad_pol is not None else plan
    accum_dtype = getattr(torch, plan.grad_accum_dtype)

    placed = {}  # the parameters' specs, from the first state seen

    def train_step(state, batch):
        params = state["params"]
        flat, treedef = tree_util.flatten(params)
        if not placed:
            placed["tree"] = state_specs(state, cfg, plan, opt_cfg)["params"]
            placed["specs"] = [s for _, _, s in sp.spec_leaves(params, placed["tree"])]
        pspecs = placed["specs"]

        def loss_fn(live, b):
            view = sp.fsdp_view(tree_util.unflatten(treedef, live), placed["tree"], plan)
            return models.loss_fn(view, b, cfg, inner, attn_mode=attn_mode, local=True)

        loss, grads = _microbatched_grads(loss_fn, [sp.local(t) for t in flat], batch, plan.microbatches, accum_dtype)
        with torch.no_grad():
            if grad_pol is not None:
                fb = sp.local(state["feedback"])
                reduced, fb_new = gradc.compressed_reduce_tree(
                    tree_util.unflatten(treedef, grads), fb, plan.dp_group(), grad_pol)
                grads = tree_util.flatten(reduced)[0]
                fb.copy_(fb_new)
            else:
                grads = [_reduce_grad(g, s, plan) for g, s in zip(grads, pspecs)]
            if plan.dp > 1:
                loss = _group_mean(loss, plan.dp_groups(), plan.dp)
            lr_scale = warmup_cosine(sp.local(state["opt"]["step"]), total=total_steps)
            metrics = _update_(params, grads, state["opt"], pspecs, opt_cfg, lr_scale, plan)
        metrics["loss"] = loss
        return state, metrics

    return train_step


def local_rows(batch: Dict[str, Any], plan: ParallelPlan) -> Dict[str, torch.Tensor]:
    """This rank's rows of a batch: a DTensor's local piece, or rows
    ``[dp_rank * B / dp, ...)`` of a global batch held whole."""
    out = {}
    for k, v in batch.items():
        if sp.is_dtensor(v):
            out[k] = v.to_local()
        else:
            out[k] = comm.local_slice(v, 0, plan.dp_groups())
    return out


def jit_train_step(
    train_step,
    state,
    cfg: ModelConfig,
    plan: ParallelPlan,
    opt_cfg: AdamWConfig,
    batch_shapes: Dict[str, Any],
):
    """The sharded entry point (the reference's AOT ``jit`` with explicit
    shardings, here without a compile): a step that takes and returns the
    state in :func:`state_specs` placements (updated in place, the port's
    donation) and the batch whole or in ``parallel.specs.batch_specs`` placements,
    of which each rank trains on its rows.  It checks the state's
    placements once, at the first call.  Without a mesh it is
    ``train_step``."""
    if plan.mesh is None:
        return train_step
    specs = state_specs(state, cfg, plan, opt_cfg)
    bspecs = sp.batch_specs(batch_shapes, plan)
    if sorted(bspecs) != sorted(batch_shapes):
        raise ValueError("batch specs do not cover the batch")
    checked = []

    def step(state, batch):
        if not checked:
            for path, leaf, spec in sp.spec_leaves(state, specs):
                if not sp.is_dtensor(leaf) or list(leaf.placements) != plan.placements(spec):
                    raise ValueError(f"state leaf {path} is not placed as {spec}")
            checked.append(True)
        return train_step(state, local_rows(batch, plan))

    return step
