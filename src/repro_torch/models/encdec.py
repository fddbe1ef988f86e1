"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

The JAX package's ``repro/models/encdec.py`` in torch.  The conv/mel
frontend is a stub: precomputed frame embeddings (B, enc_seq, d_model) go
straight into the encoder stack.  Encoder: bidirectional attention, GELU
MLP, LayerNorm.  Decoder: causal self-attention (RoPE), cross-attention to
the encoder output, GELU MLP.

Serving: :func:`init_encdec_cache` runs the encoder once and caches every
decoder layer's cross K/V (with the ``bk``/``bv`` biases where present);
the self-attention cache is :class:`~repro_torch.models.lm.DecodeCache`,
int8 included, appended through ``lm._decode_attn``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from ..parallel.plan import ParallelPlan, feature_product
from .common import ModelConfig
from .layers import (
    apply_mlp,
    apply_norm,
    attention_block,
    attn_dims,
    dense_init,
    init_attention,
    init_mlp,
    init_norm,
)
from .lm import (
    DecodeCache,
    _check_family,
    _decode_attn,
    _layer,
    _ParamTree,
    _scan_blocks,
    _stack_init,
    chunked_xent,
    decode_plan,
    embed_tokens,
    full_logits,
    init_decode_cache,
    param_tree,
    unembed_matrix,
)


def init_encdec(gen: torch.Generator, cfg: ModelConfig, plan: ParallelPlan) -> Dict[str, Any]:
    """The parameter tree, drawn from ``gen`` on its device."""
    _check_family(cfg, ("encdec",))
    Vp, d = cfg.padded_vocab, cfg.d_model
    dev = gen.device

    def enc_block(g):
        return {
            "ln1": init_norm(cfg, device=dev),
            "attn": init_attention(g, cfg, plan),
            "ln2": init_norm(cfg, device=dev),
            "mlp": init_mlp(g, cfg),
        }

    def dec_block(g):
        return {
            "ln1": init_norm(cfg, device=dev),
            "self_attn": init_attention(g, cfg, plan),
            "lnx": init_norm(cfg, device=dev),
            "cross_attn": init_attention(g, cfg, plan),
            "ln2": init_norm(cfg, device=dev),
            "mlp": init_mlp(g, cfg),
        }

    return {
        "embed": dense_init(gen, (Vp, d), cfg.param_dtype, scale=0.02),
        "lm_head": dense_init(gen, (d, Vp), cfg.param_dtype),
        "enc_blocks": _stack_init(enc_block, gen, cfg.n_enc_layers),
        "enc_norm": init_norm(cfg, device=dev),
        "dec_blocks": _stack_init(dec_block, gen, cfg.n_layers),
        "final_norm": init_norm(cfg, device=dev),
    }


def encode(params, frames: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan,
           attn_mode: str = "scan") -> torch.Tensor:
    """frames: (B, enc_seq, d) stub embeddings -> encoder hidden states."""
    params = param_tree(params)
    x = plan.act_btd(plan.to_stream(frames.to(cfg.param_dtype)))

    def block(p, h):
        hh = apply_norm(p["ln1"], plan.seq_gather(h))
        h = h + attention_block(p["attn"], hh, cfg, plan, causal=False, attn_mode=attn_mode)
        hh = apply_norm(p["ln2"], plan.seq_gather(h))
        return h + apply_mlp(p["mlp"], hh, cfg, plan), torch.zeros((), dtype=torch.float32, device=h.device)

    x, _ = _scan_blocks(x, params["enc_blocks"], range(cfg.n_enc_layers), block, plan)
    return apply_norm(params["enc_norm"], plan.seq_gather(x))


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan,
                 attn_mode: str = "blocked") -> torch.Tensor:
    """The decoder over whole token sequences (teacher forcing): the final
    hidden states (B, S, d)."""
    params = param_tree(params)
    x = embed_tokens(params, tokens, cfg, plan)

    def block(p, h):
        hh = apply_norm(p["ln1"], plan.seq_gather(h))
        h = h + attention_block(p["self_attn"], hh, cfg, plan, causal=True, attn_mode=attn_mode)
        hh = apply_norm(p["lnx"], plan.seq_gather(h))
        h = h + attention_block(p["cross_attn"], hh, cfg, plan, causal=False, attn_mode="scan", kv_from=enc_out)
        hh = apply_norm(p["ln2"], plan.seq_gather(h))
        return h + apply_mlp(p["mlp"], hh, cfg, plan), torch.zeros((), dtype=torch.float32, device=h.device)

    x, _ = _scan_blocks(x, params["dec_blocks"], range(cfg.n_layers), block, plan)
    return apply_norm(params["final_norm"], plan.seq_gather(x))


def encdec_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, plan: ParallelPlan,
                attn_mode: str = "blocked") -> torch.Tensor:
    """Cross-entropy of the decoder on ``tokens``/``labels`` given the
    encoder's ``enc_frames``."""
    params = param_tree(params)
    enc_out = encode(params, batch["enc_frames"], cfg, plan)
    hidden = decode_train(params, batch["tokens"], enc_out, cfg, plan, attn_mode)
    return chunked_xent(hidden, params["lm_head"], batch["labels"], cfg, plan)


class EncoderDecoder(_ParamTree):
    """The encoder-decoder with its parameters registered under the
    reference's paths (``dec_blocks.cross_attn.wk`` is the stack of
    ``dec_blocks/cross_attn/wk``).  Parameters do not require grad.
    ``forward`` is :func:`repro_torch.models.prefill_logits` (the batch
    holds ``enc_frames`` and ``tokens``)."""

    def __init__(self, cfg: ModelConfig, plan: ParallelPlan, tree: Dict[str, Any]):
        _check_family(cfg, ("encdec",))
        super().__init__(tree)
        self.cfg = cfg
        self.plan = plan

    def forward(self, batch: Dict[str, torch.Tensor], attn_mode: str = "blocked") -> torch.Tensor:
        from . import prefill_logits

        return prefill_logits(self, batch, self.cfg, self.plan, attn_mode)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncDecCache:
    """The decoder's self-attention cache and the cross K/V (L, B, S_enc,
    KV, hd), computed once from the encoder output."""

    self_cache: DecodeCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor

    def leaves(self) -> List[torch.Tensor]:
        """The leaves in ``jax.tree.leaves``'s order of the reference's
        registered dataclass: the self cache's, then cross_k, cross_v."""
        return self.self_cache.leaves() + [self.cross_k, self.cross_v]


def init_encdec_cache(params, enc_frames: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan, batch: int,
                      max_len: int) -> EncDecCache:
    """Prefill: run the encoder and precompute every layer's cross K/V."""
    params = param_tree(params)
    plan = decode_plan(plan)
    enc_out = encode(params, enc_frames, cfg, plan)
    hd = attn_dims(cfg, plan).hd
    B, Se, _ = enc_out.shape
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer(params["dec_blocks"], i)["cross_attn"]
        k = (enc_out @ p["wk"]).reshape(B, Se, -1, hd)  # this rank's heads, where they shard
        v = (enc_out @ p["wv"]).reshape(B, Se, -1, hd)
        if "bk" in p:
            k = k + p["bk"].reshape(1, 1, -1, hd)
            v = v + p["bv"].reshape(1, 1, -1, hd)
        ks.append(k)
        vs.append(v)
    sc = init_decode_cache(dataclasses.replace(cfg, family="dense"), plan, batch, max_len, device=enc_out.device)
    return EncDecCache(self_cache=sc, cross_k=torch.stack(ks), cross_v=torch.stack(vs))


def encdec_decode_step(params, cache: EncDecCache, tokens: torch.Tensor, cfg: ModelConfig,
                       plan: ParallelPlan) -> Tuple[torch.Tensor, EncDecCache]:
    """One serve step of the decoder: self-attention against the ring cache
    (updated in place), dense cross-attention over the cached encoder K/V.
    Returns the logits (B, vocab) float32 and the same cache, advanced.
    Under ``plan.weight_stationary`` the stream holds the whole batch and
    this rank's features, as ``lm.lm_decode_step``'s does: the layernorms
    sum over the features' groups, and cross-attention's query is cut to
    the cache's rows, its output gathered over the batch axes before
    ``wo``."""
    from ..parallel import comm
    from ..parallel.specs import heads_shardable

    params = param_tree(params)
    plan = decode_plan(plan)
    fs = plan.feature_groups() if plan.weight_stationary else None
    rows = plan.dp_groups() if fs is not None else None
    shardable = heads_shardable(cfg, plan)
    h = embed_tokens(params, tokens, cfg, plan)
    sc = cache.self_cache
    length = sc.length
    slot = torch.remainder(length, sc.k.shape[2]).reshape(1).to(torch.int64)
    dims = attn_dims(cfg, plan)
    int8 = sc.k_scale is not None
    new_pos = sc.pos
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_blocks"], i)
        lc = (sc.k[i], sc.v[i], sc.k_scale[i] if int8 else None, sc.v_scale[i] if int8 else None, sc.pos)
        o, (_, _, _, _, new_pos) = _decode_attn(lp["self_attn"], apply_norm(lp["ln1"], h, features=fs), lc, length,
                                                slot, cfg, plan, fs)
        h = h + o
        # cross attention (dense over the encoder frames), float32
        hn = apply_norm(lp["lnx"], h, features=fs)
        if shardable:
            hn = plan.tp_enter(hn)
        xp = lp["cross_attn"]
        q = feature_product(hn, xp["wq"], fs).reshape(h.shape[0], 1, -1, dims.hd)
        if "bq" in xp:
            q = q + xp["bq"].reshape(1, 1, -1, dims.hd)
        q = comm.local_slice(q, 0, rows)  # the cache's rows
        B = q.shape[0]
        qg = q.reshape(B, -1, dims.group, dims.hd).to(torch.float32) / math.sqrt(dims.hd)
        s = torch.einsum("bkgh,bskh->bkgs", qg, cache.cross_k[i].to(torch.float32))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskh->bkgh", w, cache.cross_v[i].to(torch.float32))
        o = comm.all_gather(o.reshape(B, 1, -1).to(h.dtype), 0, rows)
        h = h + plan.tp_project(o, xp["wo"], shardable)
        h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, features=fs), cfg, plan, fs)
    sc.pos = new_pos
    sc.length = length + 1
    h = apply_norm(params["final_norm"], h, features=fs)
    return full_logits(h, unembed_matrix(params, cfg), cfg, plan, fs)[:, 0], cache
