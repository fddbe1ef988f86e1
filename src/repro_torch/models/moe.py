"""Fine-grained MoE with shared experts (DeepSeekMoE / Qwen3-MoE style).

The JAX package's ``repro/models/moe.py`` on one device: top-k routing over
the float32 router with renormalized gates, the Switch load-balance aux
loss, and a static-capacity dispatch.  Each call takes
``C = max(1, ceil(1.25 · T · k / E))`` tokens per expert; assignments are
sorted stably by expert, and those past an expert's capacity are dropped in
that order (GShard-style), as the reference drops them.  The experts run
as one batched SwiGLU over (E, C, d).

The combine is deterministic: the reference scatter-adds each slot's
output into its token's row (``.at[token_row].add``), which XLA applies in
slot order; here the slot map is inverted into a (T, k) table of each
token's slots in ascending order, and the partial outputs are added in
that order, each add rounded to the model dtype (``index_add_`` on the card
adds through atomics, in no fixed order).

Expert parallelism (the reference's ``shard_map`` path): on a mesh with a
``model`` axis of ``tp`` ranks, rank ``r`` holds experts ``[r * E / tp,
(r + 1) * E / tp)``.  Tokens are replicated over the axis (they are after
the attention's reduction), every rank routes all of them the same way,
takes the assignments to its own experts at the capacity of its local
token count (this data-parallel rank's rows, as the reference's shard
does), runs its experts and combines their outputs; the ranks' partial
combines are summed over the axis in the model dtype.  The shared experts
are column/row-parallel like the dense MLP.  ``aux`` is averaged over the
batch axes (it is equal over the model axis already).

The weight-stationary decode (``features``) keeps the experts at their FSDP
shards: every rank routes every row, the router's and the experts' first
products summing float32 partial products over the FSDP axes, ``w2``
writing this rank's features.  Its tokens are dispatched in the
reference's data-parallel blocks, each at its own capacity, so the drops
are the reference's with the batch replicated or over ``data``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..parallel import comm
from ..parallel.plan import ParallelPlan, feature_product, feature_products
from .common import ModelConfig
from .layers import dense_init

CAPACITY_FACTOR = 1.25


def capacity(T: int, top_k: int, n_experts: int) -> int:
    """Slots per expert for a call over ``T`` tokens: ``max(1, ceil(1.25 ·
    T · k / E))`` (deepseek-moe-16b: 1 at a batch-4 decode, 8 over 64
    tokens)."""
    return max(1, math.ceil(CAPACITY_FACTOR * T * top_k / n_experts))


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (d, E), torch.float32, scale=0.02),
        # scaled by 1/sqrt(shape[0]) = 1/sqrt(E), as the reference's are
        "w1": dense_init(gen, (E, d, f), cfg.param_dtype),
        "w3": dense_init(gen, (E, d, f), cfg.param_dtype),
        "w2": dense_init(gen, (E, f, d), cfg.param_dtype),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["shared"] = {
            "w1": dense_init(gen, (d, fs), cfg.param_dtype),
            "w3": dense_init(gen, (d, fs), cfg.param_dtype),
            "w2": dense_init(gen, (fs, d), cfg.param_dtype),
        }
    return p


def _expert_ffn(w1, w3, w2, x, features=None):
    """Batched per-expert SwiGLU: x (E, C, d) -> (E, C, d).  ``features``:
    ``x``'s d holds this rank's features split over these groups, and so
    do ``w1``/``w3``'s rows and ``w2``'s columns: the first two products'
    partial sums are summed over them, ``w2`` writes this rank's features."""
    h, g = feature_products(x, [w1, w3], features)
    return torch.bmm(F.silu(h) * g, w2)


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int, features=None):
    """Float32 router logits, softmax, top-k (ties to the lower expert, as
    ``lax.top_k``) and the gates renormalized over the k picks.  Returns
    (probs (T, E), gates (T, k), idx (T, k)).  ``features``: ``x`` and the
    router's rows hold this rank's features, whose float32 partial logits
    are summed over these groups, so every rank picks the same experts."""
    probs = torch.softmax(feature_product(x.to(torch.float32), router, features), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def _dispatch(idx: torch.Tensor, gates: torch.Tensor, n_experts: int, C: int):
    """The static-capacity slot map of the (T, k) assignments ``idx``.

    Assignments are sorted stably by expert; the ``pos``-th of an expert
    takes slot ``e * C + pos`` when ``pos < C`` and is dropped otherwise.
    Returns ``token_row`` (E·C,) int64 (the token in each slot, T where the
    slot is empty), ``gate_val`` (E·C,) float32 (its gate, 0 where empty)
    and ``keep`` (T·k,) bool over the sorted assignments."""
    T, top_k = idx.shape
    dev = idx.device
    key = idx.reshape(-1)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    starts = torch.searchsorted(sorted_key, torch.arange(n_experts + 1, device=dev, dtype=sorted_key.dtype))
    pos = torch.arange(T * top_k, device=dev) - starts[sorted_key]
    keep = (sorted_key < n_experts) & (pos < C)
    trash = n_experts * C
    slot = torch.where(keep, sorted_key * C + pos, trash)  # only the trash slot repeats
    token_row = torch.full((trash + 1,), T, dtype=torch.int64, device=dev)
    token_row = token_row.index_put((slot,), order // top_k)
    gate_val = torch.zeros(trash + 1, dtype=torch.float32, device=dev)
    gate_val = gate_val.index_put((slot,), gates.reshape(-1)[order])
    return token_row[:-1], gate_val[:-1], keep


def _combine(ye: torch.Tensor, token_row: torch.Tensor, T: int, top_k: int) -> torch.Tensor:
    """``zeros(T, d).at[token_row].add(ye)`` in slot order, deterministic:
    each token's slots (at most k, ascending) in a (T, k) table, empty
    entries pointing at a zero row, added one column at a time in ``ye``'s
    dtype."""
    n_slots, d = ye.shape
    dev = ye.device
    order = torch.argsort(token_row, stable=True)  # by token, slots ascending
    tok = token_row[order]
    starts = torch.searchsorted(tok, torch.arange(T + 1, device=dev, dtype=tok.dtype))
    col = torch.clamp_max(torch.arange(n_slots, device=dev) - starts[tok], top_k - 1)
    # empty slots land in row T, which is cut; a kept token has at most k
    table = torch.full((T + 1, top_k), n_slots, dtype=torch.int64, device=dev)
    table = table.index_put((tok, col), order)[:T]
    ye_pad = torch.cat([ye, ye.new_zeros((1, d))], dim=0)
    y = ye.new_zeros((T, d))
    for j in range(top_k):
        y = y + ye_pad[table[:, j]]
    return y


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The Switch load-balance loss ``E * sum_e f_e * p_e`` of T tokens;
    the counts are integers, exact in any order."""
    T, top_k = idx.shape
    me = probs.mean(0)
    counts = torch.zeros(n_experts, dtype=torch.float32, device=probs.device)
    counts = counts.index_add(0, idx.reshape(-1), torch.ones(T * top_k, dtype=torch.float32, device=probs.device))
    return n_experts * torch.sum(me * (counts / (T * top_k)))


def _dispatch_blocks(idx: torch.Tensor, gates: torch.Tensor, n_experts: int, C: int, blocks: int):
    """:func:`_dispatch` of each of ``blocks`` equal row blocks of the
    (T, k) assignments on its own, at capacity ``C`` each, as the reference
    dispatches each data-parallel shard's tokens: the blocks' slots side by
    side in an (E, blocks · C) map, ``token_row`` indexing the whole T
    (T where empty).  A token's slots all lie in its block's columns, in
    the order its block gives them, so :func:`_combine` adds them as the
    block's own combine does."""
    if blocks == 1:
        return _dispatch(idx, gates, n_experts, C)
    T = idx.shape[0]
    Tb = T // blocks
    rows, vals, keeps = [], [], []
    for j in range(blocks):
        tr, gv, kp = _dispatch(idx[j * Tb:(j + 1) * Tb], gates[j * Tb:(j + 1) * Tb], n_experts, C)
        rows.append(torch.where(tr < Tb, tr + j * Tb, T).reshape(n_experts, C))
        vals.append(gv.reshape(n_experts, C))
        keeps.append(kp)
    return torch.cat(rows, 1).reshape(-1), torch.cat(vals, 1).reshape(-1), torch.cat(keeps)


def _moe_local(x, router, w1, w3, w2, *, top_k: int, n_experts: int, plan: ParallelPlan = None, features=None,
               blocks: int = 1):
    """x (T, d) -> (y (T, d), aux, dropped share) over this rank's
    ``E_loc = w1.shape[0]`` experts: all of them without expert
    parallelism, else ``plan``'s model-axis rank's, whose partial combine
    the caller sums over the axis.  On a mesh with a model axis the
    expert-parallel dispatch runs at any size of the axis (at size 1 its
    discard bucket stays empty).

    The weight-stationary decode (``features``, the groups over which
    ``x``'s d and the experts' d are split) routes the whole batch on every
    rank: the router's partial logits and the experts' partial products
    are summed over the groups, and the T tokens are dispatched in
    ``blocks`` row blocks (the reference's data-parallel shards), each at
    its own capacity; ``aux`` is the blocks' mean."""
    T, d = x.shape
    E = w1.shape[0]
    probs, gates, idx = _route(x, router, top_k, features)
    Tb = T // blocks
    if blocks == 1:
        aux = _aux_loss(probs, idx, n_experts)
    else:
        aux = torch.stack([_aux_loss(probs[j * Tb:(j + 1) * Tb], idx[j * Tb:(j + 1) * Tb], n_experts)
                           for j in range(blocks)]).mean()

    C = capacity(Tb, top_k, n_experts)
    if plan is not None and plan.present((plan.model_axis,)):
        # expert parallel: other ranks' assignments go to a discard bucket E
        e0 = plan.tp_rank * E
        idx = torch.where((idx >= e0) & (idx < e0 + E), idx - e0, E)
        gates, x = plan.tp_enter(gates), plan.tp_enter(x)
    token_row, gate_val, keep = _dispatch_blocks(idx, gates, E, C, blocks)
    xp = torch.cat([x, x.new_zeros((1, d))], dim=0)
    gx = xp[token_row].reshape(E, blocks * C, d)
    ye = _expert_ffn(w1, w3, w2, gx, features).reshape(E * blocks * C, d)
    ye = ye * gate_val[:, None].to(ye.dtype)
    # combine in the model dtype, as the reference's (half-width) combine
    y = _combine(ye.to(x.dtype), token_row, T, top_k)
    dropped = 1.0 - keep.sum() / (T * top_k)
    return y.to(x.dtype), aux, dropped


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan,
              features=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Capacity and drops are per call over
    its B·S tokens.  ``features`` (the weight-stationary decode): ``x``
    holds the whole batch and this rank's features, split over these
    groups; the tokens are routed in ``plan.dp`` blocks, the reference's
    data-parallel shards, each at its own capacity (:func:`_moe_local`),
    and ``aux`` is equal on every rank already."""
    B, S, d = x.shape
    y, aux, _ = _moe_local(x.reshape(B * S, d), p["router"], p["w1"], p["w3"], p["w2"],
                           top_k=cfg.top_k, n_experts=cfg.n_experts, plan=plan, features=features,
                           blocks=1 if features is None else plan.dp)
    y = plan.to_stream(comm.reduce_from(y.reshape(B, S, d), plan.tp_groups))
    if plan.mesh is not None and features is None:
        aux = comm.mean_from(aux, plan.dp_groups())
    if "shared" in p:
        sh = p["shared"]
        xs = plan.tp_enter(x)
        h, g = feature_products(xs, [sh["w1"], sh["w3"]], features)
        h = (F.silu(h) * g).to(x.dtype)
        y = y + plan.tp_project(h, sh["w2"])
    return y, aux
