"""Mamba2 / SSD block (state-space duality, arXiv:2405.21060).

The JAX package's ``repro/models/mamba2.py`` in torch.  Chunked SSD: the
sequence splits into chunks of ``ssm_chunk``; within a chunk the dual
(attention-like) quadratic form runs in parallel, and a loop over the
chunks carries the (H, P, N) state (the reference's ``lax.scan``), all in
float32.  The depthwise causal conv is K shifted float32 adds, in the
reference's order (not ``F.conv1d``).  ``dt`` goes through
``softplus(x) = logaddexp(x, 0)``, the reference's ``jax.nn.softplus``
(``F.softplus`` switches to the identity above 20).  Decode is the O(1)
recurrence on the (ssm, conv) state, the whole "cache" of an SSM layer.

Tensor parallelism splits the heads over ``model``, as the reference's
``xh`` constraint does: each rank runs the SSD scan on its heads, with the
one group's B and C on every rank, the gated RMSnorm sums its mean square
over the axis, and ``out_proj`` is row-parallel (:func:`_tp_view`).  Heads
that do not divide the axis run whole on every rank.  The weight-stationary
decode gathers activations instead of ``in_proj`` and the conv's weights
(:func:`_decode_stationary`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import comm
from ..parallel.plan import ParallelPlan, feature_product
from .common import ModelConfig
from .layers import apply_norm, dense_init, draw


def init_mamba2(gen: torch.Generator, cfg: ModelConfig):
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    K = cfg.ssm_conv
    dev = gen.device
    d_in_proj = 2 * di + 2 * G * N + H  # z, x, B, C, dt
    conv_dim = di + 2 * G * N
    u = draw(torch.rand, (H,), gen)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": dense_init(gen, (d, d_in_proj), cfg.param_dtype),
        "conv_w": dense_init(gen, (K, conv_dim), cfg.param_dtype, scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.param_dtype, device=dev),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(torch.float32),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm_w": torch.ones((di,), dtype=cfg.param_dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), cfg.param_dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)`` (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv as K shifted adds.  x: (B, T, C), w: (K, C).

    state: (B, K-1, C) trailing context for decode; returns (y float32,
    new_state).  With a state, x joins it in the state's dtype (float32)."""
    K = w.shape[0]
    if state is not None:
        x = torch.cat([state, x.to(state.dtype)], dim=1)
    else:  # training: causal same-length (zero left pad)
        x = F.pad(x, (0, 0, K - 1, 0))
    T_out = x.shape[1] - (K - 1)
    y = torch.zeros((x.shape[0], T_out, x.shape[2]), dtype=torch.float32, device=x.device)
    for j in range(K):
        y = y + x[:, j : j + T_out].to(torch.float32) * w[j].to(torch.float32)
    y = F.silu(y + b.to(torch.float32))
    new_state = x[:, -(K - 1) :] if K > 1 else None
    return y, new_state


def _ssd_chunk_scan(xh, Bc, Cc, dt, A, chunk: int):
    """Chunked SSD.  xh: (B,T,H,P); Bc/Cc: (B,T,N) (G = 1); dt: (B,T,H)
    (post-softplus); A: (H,) negative.  Returns y: (B,T,H,P) and the final
    state (B,H,P,N), float32.

    The within-chunk decay ``exp(seg)`` is masked by ``where`` above the
    diagonal, as the reference's is: where ``seg`` overflows there, the
    forward value is 0 and the backward pass meets 0 · inf = NaN, in both."""
    Bsz, T, H, P = xh.shape
    N = Bc.shape[-1]
    L = min(chunk, T)
    if T % L:
        raise AssertionError(f"seq {T} % chunk {L} != 0")
    nc = T // L
    f32 = torch.float32
    xc = xh.reshape(Bsz, nc, L, H, P).to(f32)
    bc = Bc.reshape(Bsz, nc, L, N).to(f32)
    cc = Cc.reshape(Bsz, nc, L, N).to(f32)
    dtc = dt.reshape(Bsz, nc, L, H).to(f32)
    cum = torch.cumsum(dtc * A[None, None, None, :], dim=2)  # inclusive log decay, (B,nc,L,H)

    li = torch.arange(L, device=xh.device)
    mask = (li[:, None] >= li[None, :])[None, :, :, None]
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
    ys = []
    for c in range(nc):
        xk, bk, ck, cumk, dtk = xc[:, c], bc[:, c], cc[:, c], cum[:, c], dtc[:, c]
        seg = cumk[:, :, None, :] - cumk[:, None, :, :]  # (B,L,L,H)
        decay = torch.where(mask, torch.exp(seg), 0.0)
        scores = torch.einsum("bin,bjn->bij", ck, bk)  # (B,L,L)
        w = scores[:, :, :, None] * decay * dtk[:, None, :, :]  # (B,L,L,H)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xk)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bin,bhpn,bih->bihp", ck, h, torch.exp(cumk))
        # state update: decay to the end of the chunk
        tail = torch.exp(cumk[:, -1:, :] - cumk)  # (B,L,H)
        s_new = torch.einsum("bjn,bjhp,bjh->bhpn", bk, xk, tail * dtk)
        h = h * torch.exp(cumk[:, -1])[:, :, None, None] + s_new
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(Bsz, T, H, P), h


#: the dim of each Mamba2 leaf that shards over the model axis (the
#: reference's ``parallel/specs.py``)
_TP_DIM = {"in_proj": -1, "out_proj": 0, "conv_w": -1, "conv_b": 0, "norm_w": 0, "dt_bias": 0, "A_log": 0, "D": 0}


def _heads_local(cfg: ModelConfig, plan: ParallelPlan) -> bool:
    return plan.tp > 1 and cfg.ssm_heads % plan.tp == 0


def _tp_view(p, cfg: ModelConfig, plan: ParallelPlan):
    """The block's parameters for this rank, and its head count.

    Without tensor parallelism: ``p`` and all heads.  With heads that
    divide the model axis: this rank's heads.  ``dt_bias``, ``A_log``,
    ``D``, ``norm_w`` and ``out_proj`` hold them already; ``in_proj`` and
    ``conv_w``/``conv_b`` are placed in contiguous pieces that cut across
    the z/x/B/C/dt boundaries, so they are gathered over the axis (backward:
    a reduce-scatter, every rank using the shared B and C columns) and this
    rank's columns taken.  Otherwise every parameter is gathered (backward:
    this rank's slice) and the block runs whole on every rank."""
    if plan.tp == 1:
        return p, cfg.ssm_heads
    g = plan.tp_groups
    if not _heads_local(cfg, plan):
        return {k: comm.gather_from(v, _TP_DIM[k] % v.ndim, g) for k, v in p.items()}, cfg.ssm_heads
    di, GN, P = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_head_dim
    nh = cfg.ssm_heads // plan.tp
    h0 = plan.tp_rank * nh
    dev = p["in_proj"].device

    def ar(lo, n):
        return torch.arange(lo, lo + n, device=dev)

    xs = ar(h0 * P, nh * P)
    cols = torch.cat([xs, di + xs, ar(2 * di, 2 * GN), ar(2 * di + 2 * GN + h0, nh)])
    chans = torch.cat([xs, ar(di, 2 * GN)])
    view = dict(p)
    view["in_proj"] = comm.gather_to(p["in_proj"], p["in_proj"].ndim - 1, g).index_select(-1, cols)
    view["conv_w"] = comm.gather_to(p["conv_w"], p["conv_w"].ndim - 1, g).index_select(-1, chans)
    view["conv_b"] = comm.gather_to(p["conv_b"], 0, g).index_select(0, chans)
    return view, nh


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig, nh: int):
    dl, GN = nh * cfg.ssm_head_dim, cfg.ssm_groups * cfg.ssm_state
    return torch.split(zxbcdt, [dl, dl, GN, GN, nh], dim=-1)


def _gated_norm(y: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan) -> torch.Tensor:
    """The RMSnorm over the whole inner width: with this rank's heads, the
    mean square's sum is taken over the model axis."""
    if not _heads_local(cfg, plan):
        return apply_norm({"w": w}, y)
    g = plan.tp_groups
    xf = y.to(torch.float32)
    ss = comm.copy_to(comm.reduce_from((xf * xf).sum(-1, keepdim=True), g), g)
    return (xf * torch.rsqrt(ss / cfg.d_inner + 1e-6) * w.to(torch.float32)).to(y.dtype)


def apply_mamba2(p, x: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d); under tensor parallelism on this rank's
    heads (:func:`_tp_view`)."""
    p, nh = _tp_view(p, cfg, plan)
    local = _heads_local(cfg, plan)
    if local:
        x = plan.tp_enter(x)
    B, T, d = x.shape
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    z, xs, Bc, Cc, dt = _split_proj(x @ p["in_proj"], cfg, nh)
    conv_out, _ = _causal_conv(torch.cat([xs, Bc, Cc], dim=-1), p["conv_w"], p["conv_b"])
    xs, Bc, Cc = torch.split(conv_out, [nh * P, G * N, G * N], dim=-1)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, T, nh, P)
    if G != 1:
        raise AssertionError("groups>1 not needed for assigned archs")
    y, _ = _ssd_chunk_scan(xh, Bc, Cc, dt, A, cfg.ssm_chunk)
    y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(B, T, nh * P)
    y = y * F.silu(z.to(torch.float32))
    y = _gated_norm(y.to(x.dtype), p["norm_w"], cfg, plan)
    return plan.act_btd(plan.tp_project(y, p["out_proj"], shardable=local))


def mamba2_decode_step(
    p,
    x: torch.Tensor,  # (B, 1, d)
    state: Tuple[torch.Tensor, torch.Tensor],  # (ssm (B,H,P,N), conv (B,K-1,C))
    cfg: ModelConfig,
    plan: ParallelPlan,
    features=None,
):
    """One token through the recurrence: returns (y (B, 1, d), (ssm, conv)).
    Under tensor parallelism with this rank's heads, ``ssm`` holds them and
    ``conv`` is whole (this rank's channels taken from it, and the other
    ranks' gathered back into the new state).  ``features``: the
    weight-stationary decode (:func:`_decode_stationary`)."""
    if features is not None:
        return _decode_stationary(p, x, state, cfg, plan, features)
    p, nh = _tp_view(p, cfg, plan)
    local = _heads_local(cfg, plan)
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    dl = nh * P
    h_prev, conv_state = state
    if local:
        x = plan.tp_enter(x)
        h0 = plan.tp_rank * dl
        conv_state = torch.cat([conv_state[..., h0 : h0 + dl], conv_state[..., cfg.d_inner :]], dim=-1)
    z, xs, Bc, Cc, dt = _split_proj(x @ p["in_proj"], cfg, nh)
    conv_out, conv_state = _causal_conv(torch.cat([xs, Bc, Cc], dim=-1), p["conv_w"], p["conv_b"], conv_state)
    if local:
        conv_state = torch.cat([comm.all_gather(conv_state[..., :dl], -1, plan.tp_groups), conv_state[..., dl:]], -1)
    xs, Bc, Cc = torch.split(conv_out, [dl, G * N, G * N], dim=-1)
    y, h_new = _recur(p, z, xs, Bc, Cc, dt, h_prev, cfg, plan, x.dtype)
    return plan.tp_project(y, p["out_proj"], shardable=local), (h_new, conv_state)


def _recur(p, z, xs, Bc, Cc, dt, h_prev, cfg: ModelConfig, plan: ParallelPlan, dtype):
    """The recurrence of one token on ``nh = dt.shape[-1]`` heads, then the
    gate and the gated RMSnorm: returns (y (B, 1, nh·P) in ``dtype``, the
    new ssm state)."""
    B, nh = dt.shape[0], dt.shape[-1]
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])[:, 0]  # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None, :])  # (B,H)
    xh = xs.reshape(B, nh, P).to(torch.float32)
    bk = Bc.reshape(B, N).to(torch.float32)
    ck = Cc.reshape(B, N).to(torch.float32)
    h_new = h_prev * a[:, :, None, None] + torch.einsum("bn,bhp,bh->bhpn", bk, xh, dt)
    y = torch.einsum("bn,bhpn->bhp", ck, h_new) + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, nh * P) * F.silu(z.to(torch.float32))
    return _gated_norm(y.to(dtype), p["norm_w"], cfg, plan), h_new


def _decode_stationary(p, x, state, cfg: ModelConfig, plan: ParallelPlan, features):
    """The weight-stationary decode step: ``x`` is the whole batch with
    this rank's features (split over ``features``), ``p`` this rank's
    shards, the state this rank's batch rows (``conv`` whole over the model
    axis).  No weight is gathered: ``in_proj``'s partial products are
    summed over ``features`` into this rank's contiguous piece of the
    z/x/B/C/dt columns, which is gathered over the model axis (an
    activation); the depthwise conv runs on the channels whose ``conv_w``
    and ``conv_b`` this rank holds and its output is gathered the same way;
    the recurrence runs on this rank's rows and heads, whose output is
    gathered over the batch axes before ``out_proj``, which writes this
    rank's features."""
    local = _heads_local(cfg, plan)
    if plan.tp > 1 and not local:
        raise ValueError(f"{cfg.ssm_heads} SSM heads do not split over a model axis of {plan.tp}")
    g, rows = plan.tp_groups, plan.dp_groups()
    di, GN, P = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_head_dim
    nh = cfg.ssm_heads // plan.tp
    h0 = plan.tp_rank * nh
    h_prev, conv_state = state
    zxbcdt = comm.all_gather(feature_product(plan.tp_enter(x), p["in_proj"], features), -1, g)
    z, xs, Bc, Cc, dt = _split_proj(comm.local_slice(zxbcdt, 0, rows), cfg, cfg.ssm_heads)
    xbc = torch.cat([xs, Bc, Cc], dim=-1)
    piece, _ = _causal_conv(comm.local_slice(xbc, -1, g), p["conv_w"], p["conv_b"],
                            comm.local_slice(conv_state, -1, g))
    xs, Bc, Cc = torch.split(comm.all_gather(piece, -1, g), [di, GN, GN], dim=-1)
    new_conv = torch.cat([conv_state, xbc.to(conv_state.dtype)], dim=1)[:, 1:]
    cols = slice(h0 * P, (h0 + nh) * P)
    y, h_new = _recur(p, z[..., cols], xs[..., cols], Bc, Cc, dt[..., h0 : h0 + nh], h_prev, cfg, plan, x.dtype)
    y = comm.all_gather(y, 0, rows)
    return plan.tp_project(y, p["out_proj"], shardable=local), (h_new, new_conv)


def init_ssm_state(cfg: ModelConfig, batch: int, device=None):
    """Zero (ssm (B, H, P, N), conv (B, K-1, C)) states, float32."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return (
        torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=torch.float32, device=device),
    )
