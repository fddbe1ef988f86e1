"""Shared transformer layers: norms, RoPE, chunked GQA attention, MLPs.

The JAX package's layers (``repro/models/layers.py``) in torch.  Parameters
are nested dicts of tensors under the reference's names.  Attention is
memory-efficient (flash-style online softmax over KV chunks):

  * mode "scan"    — every KV chunk in turn;
  * mode "blocked" — per Q chunk, only the KV chunks its causal/SWA mask
    allows (fully masked chunk pairs are skipped).

Numerics follow the reference: norms and RoPE compute in float32 and cast
back, attention scores and the online softmax are float32, masked scores
are ``-1e30``.  ``gelu`` is the tanh approximation, which is what
``jax.nn.gelu`` computes by default.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel import comm
from ..parallel.plan import ParallelPlan, feature_product, feature_products
from .common import ModelConfig

NEG_INF = -1e30

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a ``torch.Generator`` to draw a parameter tree on the
    meta device: shapes and dtypes, no storage, no draws."""

    device = torch.device("meta")


def draw(fn, shape, gen, **kw) -> torch.Tensor:
    """``fn`` (``torch.randn`` or ``torch.rand``) of ``shape`` from ``gen``
    on its device, float32; an empty meta tensor for a :class:`MetaGenerator`."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return fn(shape, generator=gen, device=gen.device, dtype=torch.float32, **kw)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype, scale: Optional[float] = None) -> torch.Tensor:
    """Normal draws times ``scale`` (default 1/sqrt(fan_in), fan_in =
    ``shape[0]``), made in float32 on the generator's device, then cast."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    return (draw(torch.randn, shape, gen) * s).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, with_bias: Optional[bool] = None, device=None) -> Params:
    d = cfg.d_model
    w = torch.ones((d,), dtype=cfg.param_dtype, device=device)
    if (with_bias is None and cfg.norm == "layernorm") or with_bias:
        return {"w": w, "b": torch.zeros((d,), dtype=cfg.param_dtype, device=device)}
    return {"w": w}


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6, features=None) -> torch.Tensor:
    """RMSnorm, or layernorm exactly when ``p`` has a bias ``"b"``; in
    float32, cast back to ``x``'s dtype.

    ``features``: the process groups over which ``x``'s last dim is split
    (the weight-stationary decode's stream, with ``p`` cut to this rank's
    features): the sums over the features (the mean square; the mean and
    the centred sum of squares) are all-reduced over them.  None, or of one
    rank: the plain norm."""
    xf = x.to(torch.float32)
    n = comm.group_size(features)
    if n == 1:
        def mean(t):
            return t.mean(-1, keepdim=True)
    else:
        d = x.shape[-1] * n

        def mean(t):
            return comm.all_reduce_(t.sum(-1, keepdim=True), features) / d
    if "b" in p:  # layernorm
        mu = mean(xf)
        var = mean((xf - mu) ** 2)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["w"].to(torch.float32) + p["b"].to(torch.float32)).to(x.dtype)
    ms = mean(xf * xf)
    y = xf * torch.rsqrt(ms + eps)
    return (y * p["w"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    """1 / theta^(2i / hd) in float32.  The base is a Python number: a
    tensor made from it on the card would be a host-to-device copy, which
    waits for the stream."""
    e = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(float(theta), e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S).  The head splits in halves
    (no interleave); angles are float32 ``positions * freqs``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : hd // 2], xf[..., hd // 2 :]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_q: int  # query heads (global)
    n_kv: int  # effective kv heads after duplication (global)
    hd: int

    @property
    def group(self) -> int:
        return self.n_q // self.n_kv


def attn_dims(cfg: ModelConfig, plan: ParallelPlan) -> AttnDims:
    rep = plan.kv_repeat(cfg.n_kv_heads, cfg.n_heads)
    return AttnDims(n_q=cfg.n_heads, n_kv=cfg.n_kv_heads * rep, hd=cfg.hd)


def init_attention(gen: torch.Generator, cfg: ModelConfig, plan: ParallelPlan) -> Params:
    dims = attn_dims(cfg, plan)
    d, hd, dt = cfg.d_model, dims.hd, cfg.param_dtype
    p = {
        "wq": dense_init(gen, (d, dims.n_q * hd), dt),
        "wk": dense_init(gen, (d, dims.n_kv * hd), dt),
        "wv": dense_init(gen, (d, dims.n_kv * hd), dt),
        "wo": dense_init(gen, (dims.n_q * hd, d), dt),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", dims.n_q), ("bk", dims.n_kv), ("bv", dims.n_kv)):
            p[name] = torch.zeros((n * hd,), dtype=dt, device=gen.device)
    return p


def _chunk_mask(q_pos, k_pos, causal: bool, window: Optional[int], kv_len=None) -> torch.Tensor:
    """(Sq, Sk) additive mask for one chunk pair from absolute positions."""
    m = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32, device=q_pos.device)
    if causal:
        m = m.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
    if window is not None:
        m = m.masked_fill(q_pos[:, None] - k_pos[None, :] >= window, NEG_INF)
    if kv_len is not None:
        m = m.masked_fill(k_pos[None, :] >= kv_len, NEG_INF)
    return m


def _attend_chunk(q, k, v, mask, state):
    """Online-softmax update.  q: (B, Sq, KV, G, hd) float32; k/v: (B, Sk,
    KV, hd) float32."""
    m_prev, l_prev, acc = state
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k)
    s = s + mask[None, None, None, :, :]
    m_cur = s.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(-1)
    pv = torch.einsum("bkgqs,bskh->bkgqh", p, v)
    acc_new = acc * corr[..., None] + pv
    return m_new, l_new, acc_new


def attention_core(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int] = None,
    q_offset: int = 0,  # absolute position of q[0] (decode: kv_len - Sq)
    kv_len=None,  # valid prefix of k/v (decode with padded cache)
    chunk_k: int = 1024,
    mode: str = "blocked",
    k_scale: Optional[torch.Tensor] = None,  # (B, Sk, KV) int8-dequant scales
    v_scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    B, Sq, Hq, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = Hq // KV
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, hd).to(torch.float32) / math.sqrt(hd)
    nck = max(1, math.ceil(Sk / chunk_k))
    ck = Sk // nck if Sk % nck == 0 else chunk_k
    # pad Sk to a chunk multiple (the mask drops the tail through kv_len)
    pad = (-Sk) % ck
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if k_scale is not None:
            k_scale = F.pad(k_scale, (0, 0, 0, pad))
            v_scale = F.pad(v_scale, (0, 0, 0, pad))
        if kv_len is None:
            kv_len = Sk
    nck = k.shape[1] // ck

    q_pos = q_offset + torch.arange(Sq, device=dev)

    def dequant(kc, sc):
        if sc is None:
            return kc
        return kc.to(torch.float32) * sc[..., None]

    def kv_chunk(i):
        sl = slice(i * ck, (i + 1) * ck)
        kc = dequant(k[:, sl], k_scale[:, sl] if k_scale is not None else None)
        vc = dequant(v[:, sl], v_scale[:, sl] if v_scale is not None else None)
        return kc.to(torch.float32), vc.to(torch.float32)

    def init(sq):
        return (
            torch.full((B, KV, G, sq), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((B, KV, G, sq), dtype=torch.float32, device=dev),
            torch.zeros((B, KV, G, sq, hd), dtype=torch.float32, device=dev),
        )

    out_dtype = out_dtype or torch.float32

    def finalize(m, l, acc, sq):
        o = acc / torch.clamp_min(l[..., None], 1e-30)
        return o.permute(0, 3, 1, 2, 4).reshape(B, sq, Hq, hd).to(out_dtype)

    def run(qc, qp, state, chunks):
        for i in chunks:
            kc, vc = kv_chunk(i)
            k_pos = i * ck + torch.arange(ck, device=dev)
            mask = _chunk_mask(qp, k_pos, causal, window, kv_len)
            state = _attend_chunk(qc, kc, vc, mask, state)
        return state

    if mode == "scan" or Sq == 1 or nck == 1:
        return finalize(*run(qg, q_pos, init(Sq), range(nck)), Sq)

    # blocked: per Q chunk, visit only the KV chunks its mask allows; each
    # chunk is normalized and cast at once, so the float32 accumulator never
    # exceeds one (B, KV, G, cq, hd) tile
    cq = min(Sq, 1024)
    if Sq % cq:
        raise ValueError(f"blocked mode needs Sq % {cq} == 0, got Sq = {Sq}")
    outs = []
    for qi in range(Sq // cq):
        qc = qg[:, qi * cq : (qi + 1) * cq]
        qp = q_pos[qi * cq : (qi + 1) * cq]
        lo_pos = 0 if window is None else max(0, (qi * cq) - window - ck + 1)
        lo = lo_pos // ck
        hi = nck if not causal else min(nck, ((qi + 1) * cq + ck - 1) // ck)
        outs.append(finalize(*run(qc, qp, init(cq), range(lo, hi)), cq))
    return torch.cat(outs, dim=1)


def attention_block(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    plan: ParallelPlan,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    attn_mode: str = "blocked",
    kv_from: Optional[torch.Tensor] = None,  # cross-attention source
) -> torch.Tensor:
    from ..parallel.specs import heads_shardable

    B, S, d = x.shape
    hd = attn_dims(cfg, plan).hd
    shardable = heads_shardable(cfg, plan)
    if shardable:  # this rank's heads (all of them without TP)
        x = plan.tp_enter(x)
        kv_from = None if kv_from is None else plan.tp_enter(kv_from)
    src = x if kv_from is None else kv_from
    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, src.shape[1], -1, hd)
    v = v.reshape(B, src.shape[1], -1, hd)
    q = plan.act_heads(q, shardable)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if kv_from is None:  # self-attention: rotary on q and k
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attention_core(q, k, v, causal=causal, window=window, mode=attn_mode, out_dtype=x.dtype)
    out = out.reshape(B, S, -1)
    return plan.act_btd(plan.tp_project(out, p["wo"], shardable=shardable))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None) -> Params:
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.param_dtype
    if cfg.mlp_act == "swiglu":
        return {
            "w1": dense_init(gen, (d, f), dt),
            "w3": dense_init(gen, (d, f), dt),
            "w2": dense_init(gen, (f, d), dt),
        }
    return {"w1": dense_init(gen, (d, f), dt), "w2": dense_init(gen, (f, d), dt)}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan, features=None) -> torch.Tensor:
    """Column-parallel ``w1``/``w3`` and row-parallel ``w2`` under tensor
    parallelism (this rank's hidden units).  ``features``: ``x`` holds this
    rank's piece of the features split over these groups, and so do
    ``w1``/``w3``'s rows and ``w2``'s columns (the weight-stationary
    decode): ``w1``/``w3``'s partial products are summed over them
    (``feature_products``), ``w2`` writes this rank's features."""
    x = plan.tp_enter(x)
    if cfg.mlp_act == "swiglu":
        h, g = feature_products(x, [p["w1"], p["w3"]], features)
        h = F.silu(h) * g
    elif cfg.mlp_act == "relu2":
        r = F.relu(feature_product(x, p["w1"], features))
        h = r * r
    else:  # gelu, tanh approximation as jax.nn.gelu's default
        h = F.gelu(feature_product(x, p["w1"], features), approximate="tanh")
    return plan.act_btd(plan.tp_project(h.to(x.dtype), p["w2"]))
