"""Decoder-only LM: the dense and VLM families of ``repro/models/lm.py``.

One implementation, configured per arch (``repro_torch/configs``).  The
parameters form the reference's tree (``embed``, ``final_norm``,
``lm_head`` unless tied, and ``blocks`` with every leaf stacked over the
layers), so a reference tree carries over leaf by leaf
(:func:`repro_torch.models.params_from_numpy`) and checkpoints name the
same paths.  :class:`DecoderLM` registers that tree as an ``nn.Module``.

Serving uses a ring KV cache (:class:`DecodeCache`), optionally int8
per token and head through the paper's linear-scaling quantizer.  The
reference computes that quantizer in ``jnp`` and writes the codes and
scales into the ring slot with ``dynamic_update_slice_in_dim``; here the
decode step does both through ``kv_quantize_append``, the kvquant
kernels' fused append (one launch per attention layer for K and V) on
CUDA tensors and its plain version on CPU tensors, with a true divide for
``absmax / 127`` (the reference's jitted divide is XLA's multiply by
``f32(1/127)``, which can differ by one ulp).  :func:`_quantize_token`,
the reference's function of that name, runs the standalone ``absmax``
and ``quantize_with_scale`` kernels.

bf16 numerics follow the reference's: norms, RoPE and attention scores in
float32; the int8 dequant product rounds once to bf16, and attention's two
products accumulate in float32 (operands upcast, which is exact).  The
bf16 weight products are plain ``@``; the launcher runs them inside
``models.common.float32_bf16_reductions``, which turns off
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` so
that cuBLAS accumulates them in float32 as XLA does (the flag is
process-wide, so this module does not set it).

Training: :func:`lm_loss` runs the layer stack under the plan's remat
policy (``torch.utils.checkpoint`` per block) and :func:`chunked_xent`, the
cross-entropy over sequence chunks of at most 512 positions, whose logits
are the parameter-dtype product cast to float32, as the reference's are.

Families: ``dense`` and ``vlm`` stack attention blocks; ``moe`` stacks
``dense_prefix_layers`` dense blocks (``dense_blocks``) and then MoE blocks
(``models/moe.py``), whose aux load-balance loss joins the training loss;
``ssm`` stacks Mamba2 blocks (``models/mamba2.py``), whose decode state is
the (ssm, conv) pair per layer; ``hybrid`` stacks Mamba2 blocks and applies
the one ``shared_attn`` block after every ``hybrid_attn_every`` of them,
with a KV cache per application.  The encoder-decoder family is
``models/encdec.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from .. import tree as tree_util
from ..kernels.kvquant.ops import kv_quantize, kv_quantize_append
from ..parallel import comm
from ..parallel.plan import ParallelPlan, feature_product, feature_products
from .common import ModelConfig
from .layers import (
    apply_mlp,
    apply_norm,
    apply_rope,
    attention_block,
    attn_dims,
    dense_init,
    init_attention,
    init_mlp,
    init_norm,
)
from .mamba2 import apply_mamba2, init_mamba2, init_ssm_state, mamba2_decode_step
from .moe import apply_moe, init_moe

#: the families of this module; ``encdec`` is ``models/encdec.py``'s
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


def _check_family(cfg: ModelConfig, families=FAMILIES) -> None:
    if cfg.family not in families:
        raise ValueError(f"model family {cfg.family!r} is not one of {families}")


def _stack_init(fn, gen: torch.Generator, n: int):
    """``fn(gen)`` drawn ``n`` times, each leaf stacked along a new axis 0
    (filled layer by layer: one layer's temporaries at a time)."""
    first = fn(gen)
    leaves, treedef = tree_util.flatten(first)
    stacked = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device) for t in leaves]
    for s, t in zip(stacked, leaves):
        s[0] = t
    for i in range(1, n):
        for s, t in zip(stacked, tree_util.flatten(fn(gen))[0]):
            s[i] = t
    return tree_util.unflatten(treedef, stacked)


def _layer(stacked, i: int):
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return tree_util.tree_map(lambda t: t[i], stacked)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig, plan: ParallelPlan) -> Dict[str, Any]:
    """The parameter tree, drawn from ``gen`` on its device: dense weights
    normal times 1/sqrt(fan_in), the embedding normal times 0.02, norms
    ones, biases zeros (the Mamba2 and router leaves as ``init_mamba2`` and
    ``init_moe`` draw them)."""
    _check_family(cfg)
    Vp, d = cfg.padded_vocab, cfg.d_model
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (Vp, d), cfg.param_dtype, scale=0.02),
        "final_norm": init_norm(cfg, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, Vp), cfg.param_dtype)
    if cfg.family in ("dense", "vlm"):
        params["blocks"] = _stack_init(lambda g: _init_attn_block(g, cfg, plan, moe=False), gen, cfg.n_layers)
    elif cfg.family == "moe":
        pre = cfg.dense_prefix_layers
        if pre:
            params["dense_blocks"] = _stack_init(lambda g: _init_attn_block(g, cfg, plan, moe=False), gen, pre)
        params["blocks"] = _stack_init(lambda g: _init_attn_block(g, cfg, plan, moe=True), gen, cfg.n_layers - pre)
    else:  # ssm, hybrid
        params["blocks"] = _stack_init(lambda g: _init_ssm_block(g, cfg), gen, cfg.n_layers)
        if cfg.family == "hybrid":
            params["shared_attn"] = _init_attn_block(gen, cfg, plan, moe=False)
    return params


def _init_attn_block(gen: torch.Generator, cfg: ModelConfig, plan: ParallelPlan, *, moe: bool):
    p = {
        "ln1": init_norm(cfg, device=gen.device),
        "attn": init_attention(gen, cfg, plan),
        "ln2": init_norm(cfg, device=gen.device),
    }
    if moe:
        p["moe"] = init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _init_ssm_block(gen: torch.Generator, cfg: ModelConfig):
    return {"ln": init_norm(cfg, device=gen.device), "ssm": init_mamba2(gen, cfg)}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block(p, x, cfg, plan, attn_mode, moe: bool):
    x = plan.grad_barrier(x)
    h = apply_norm(p["ln1"], plan.seq_gather(x))
    x = x + attention_block(p["attn"], h, cfg, plan, causal=True, window=cfg.sliding_window, attn_mode=attn_mode)
    h = apply_norm(p["ln2"], plan.seq_gather(x))
    if moe:
        y, aux = apply_moe(p["moe"], h, cfg, plan)
        return x + y, aux
    return x + apply_mlp(p["mlp"], h, cfg, plan), torch.zeros((), dtype=torch.float32, device=x.device)


def _ssm_block(p, x, cfg, plan):
    x = plan.grad_barrier(x)
    h = apply_norm(p["ln"], plan.seq_gather(x))
    return x + apply_mamba2(p["ssm"], h, cfg, plan), torch.zeros((), dtype=torch.float32, device=x.device)


#: the products without batch dims, whose outputs remat "dots" saves (the
#: reference's ``dots_with_no_batch_dims_saveable``): a weight product
#: ``(B, S, d) @ (d, f)`` runs as one ``mm`` or ``addmm``, while attention's
#: einsums run as ``bmm``, which is recomputed
_SAVEABLE_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) + (
    (torch.ops.aten.mm.dtype,) if hasattr(torch.ops.aten.mm, "dtype") else ())  # tp_project's bf16 product


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVEABLE_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, plan: ParallelPlan):
    """``fn`` under the plan's remat policy when autograd records: "none"
    saves everything, "full" recomputes the whole block in the backward
    pass, "dots" saves only the outputs of products without batch dims.
    Remat changes memory, never numbers."""
    if plan.remat == "none":
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if plan.remat == "dots" else None)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return wrapped


def _scan_blocks(x, stacked, layers, block_fn, plan: ParallelPlan):
    """The reference's ``lax.scan`` over stacked layers, as a loop over the
    indices ``layers``: layer ``i`` sees views of the stacked leaves, a
    leaf held as this rank's shard (``comm.Sharded``, the train step's
    FSDP view) gathered inside the layer, under its remat."""
    fn = _maybe_remat(lambda p, h: block_fn(comm.gathered(p), h), plan)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in layers:
        x, aux_i = fn(_layer(stacked, i), x)
        aux = aux + aux_i
    return x, aux


def lm_backbone(
    params,
    x: torch.Tensor,  # (B, S, d) embedded inputs
    cfg: ModelConfig,
    plan: ParallelPlan,
    attn_mode: str = "blocked",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layer stack; returns (hidden, aux_loss)."""
    def attn(moe):
        return lambda p, h: _attn_block(p, h, cfg, plan, attn_mode, moe=moe)

    def ssm(p, h):
        return _ssm_block(p, h, cfg, plan)

    if cfg.family in ("dense", "vlm"):
        x, aux_total = _scan_blocks(x, params["blocks"], range(cfg.n_layers), attn(False), plan)
    elif cfg.family == "moe":
        pre = cfg.dense_prefix_layers
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        if pre:
            x, aux = _scan_blocks(x, params["dense_blocks"], range(pre), attn(False), plan)
            aux_total = aux_total + aux
        x, aux = _scan_blocks(x, params["blocks"], range(cfg.n_layers - pre), attn(True), plan)
        aux_total = aux_total + aux
    elif cfg.family == "ssm":
        x, aux_total = _scan_blocks(x, params["blocks"], range(cfg.n_layers), ssm, plan)
    elif cfg.family == "hybrid":
        # the one shared attention block after every k SSM layers, then the
        # tail of L % k SSM layers
        k = cfg.hybrid_attn_every or 6
        n_groups, rem = divmod(cfg.n_layers, k)
        shared_fn = _maybe_remat(attn(False), plan)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(n_groups):
            x, aux = _scan_blocks(x, params["blocks"], range(g * k, (g + 1) * k), ssm, plan)
            x, _ = shared_fn(params["shared_attn"], x)
            aux_total = aux_total + aux
        if rem:
            x, aux = _scan_blocks(x, params["blocks"], range(n_groups * k, cfg.n_layers), ssm, plan)
            aux_total = aux_total + aux
    else:
        raise ValueError(cfg.family)
    return apply_norm(params["final_norm"], plan.seq_gather(x)), aux_total


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan) -> torch.Tensor:
    """The embedding rows of ``tokens``, in the stream's layout.
    ``F.embedding``, not indexing: the backward of ``embed[tokens]``
    accumulates repeated tokens' rows in an order that changes from call to
    call on the CPU, while the embedding's backward sums them in a fixed
    order, so a step is reproducible.

    Vocab-parallel under tensor parallelism: this rank holds rows
    ``[r * V / tp, (r + 1) * V / tp)``; ids outside them look up row 0 and
    are zeroed, and the ranks' partial embeddings are summed."""
    w = params["embed"]
    if plan.tp == 1:
        return plan.act_btd(plan.to_stream(torch.nn.functional.embedding(tokens.long(), w)))
    ids = tokens.long() - plan.tp_rank * w.shape[0]
    mine = (ids >= 0) & (ids < w.shape[0])
    e = torch.nn.functional.embedding(torch.where(mine, ids, 0), w)
    e = torch.where(mine[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))
    return plan.act_btd(plan.reduce_to_stream(e))


def unembed_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def chunked_xent(
    hidden: torch.Tensor,  # (B, S, d)
    w_unembed: torch.Tensor,  # (d, Vp)
    labels: torch.Tensor,  # (B, S) int; < 0 = ignore
    cfg: ModelConfig,
    plan: ParallelPlan,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean softmax cross-entropy over the positions whose label lies in
    ``[0, cfg.vocab)``, in sequence chunks of ``min(chunk, S)``: one
    chunk's (B, c, Vp) logits at a time in the forward pass.  The logits
    are ``h @ w`` in the parameter dtype, then float32; the log-sum-exp
    runs over the padded vocabulary, as the reference's does."""
    B, S, d = hidden.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the loss chunk {c}")
    hidden = plan.tp_enter(hidden)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for i in range(S // c):
        h = hidden[:, i * c : (i + 1) * c]
        y = labels[:, i * c : (i + 1) * c]
        logits = (h @ w_unembed).to(torch.float32)
        mask = (y >= 0) & (y < cfg.vocab)
        if plan.tp == 1:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, torch.where(mask, y, 0).long()[..., None])[..., 0]
        else:
            lse, gold = _vocab_parallel_lse_gold(logits, y, mask, plan)
        nll = torch.where(mask, lse - gold, 0.0)
        tot = tot + nll.sum()
        cnt = cnt + mask.sum(dtype=torch.int32)
    return tot / torch.clamp_min(cnt, 1)


def _vocab_parallel_lse_gold(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, plan: ParallelPlan):
    """Log-sum-exp and gold logit over the vocabulary when each rank of the
    model axis holds its columns of the logits: the max over the ranks
    (no gradient), the sum of exponentials and the gold column summed over
    them."""
    g = plan.tp_groups
    v_loc = logits.shape[-1]
    top = comm.all_reduce(logits.detach().amax(dim=-1), g, op=dist.ReduceOp.MAX)
    sumexp = comm.reduce_from(torch.exp(logits - top[..., None]).sum(-1), g)
    lse = top + torch.log(sumexp)
    col = y.long() - plan.tp_rank * v_loc
    mine = mask & (col >= 0) & (col < v_loc)
    gold = torch.gather(logits, -1, torch.where(mine, col, 0)[..., None])[..., 0]
    gold = comm.reduce_from(torch.where(mine, gold, 0.0), g)
    return lse, gold


def full_logits(h: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan, features=None) -> torch.Tensor:
    """``h @ w`` in float32 over the real vocabulary: under tensor
    parallelism each rank's columns gathered over the model axis.
    ``features``: ``h`` and ``w``'s rows hold this rank's features (the
    weight-stationary decode), whose partial products are summed first."""
    logits = comm.all_gather(feature_product(h, w, features).to(torch.float32), -1 % h.ndim, plan.tp_groups)
    return logits[..., : cfg.vocab]


def lm_loss(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    plan: ParallelPlan,
    attn_mode: str = "blocked",
    aux_coeff: float = 0.01,
) -> torch.Tensor:
    """The training loss: embed (or take the VLM's ``embeds``), run the
    stack, :func:`chunked_xent` against ``labels``, plus ``aux_coeff``
    times the blocks' auxiliary loss."""
    params = param_tree(params)
    if "embeds" in batch:  # vlm / stubbed-frontend path
        x = plan.act_btd(plan.to_stream(batch["embeds"].to(cfg.param_dtype)))
    else:
        x = embed_tokens(params, batch["tokens"], cfg, plan)
    hidden, aux = lm_backbone(params, x, cfg, plan, attn_mode)
    loss = chunked_xent(hidden, unembed_matrix(params, cfg), batch["labels"], cfg, plan)
    return loss + aux_coeff * aux


# ---------------------------------------------------------------------------
# the model as an nn.Module
# ---------------------------------------------------------------------------

class _ParamTree(nn.Module):
    """A nested dict of tensors registered as parameters under its keys;
    :meth:`tree` gives the dict back (the parameters themselves)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = tuple(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, _ParamTree(value))
            else:
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out = {}
        for key in self._keys:
            value = getattr(self, key)
            out[key] = value.tree() if isinstance(value, _ParamTree) else value
        return out


class DecoderLM(_ParamTree):
    """The decoder of the dense, VLM, MoE, SSM and hybrid families with its
    parameters registered under the reference's paths (``blocks.attn.wq`` is the (L, d, n_q·hd) stack of
    ``blocks/attn/wq``).  Parameters do not require grad; a trainer turns
    that on with ``requires_grad_()``.  ``forward`` is
    :func:`repro_torch.models.prefill_logits`."""

    def __init__(self, cfg: ModelConfig, plan: ParallelPlan, tree: Dict[str, Any]):
        _check_family(cfg)
        super().__init__(tree)
        self.cfg = cfg
        self.plan = plan

    def forward(self, batch: Dict[str, torch.Tensor], attn_mode: str = "blocked") -> torch.Tensor:
        from . import prefill_logits

        return prefill_logits(self, batch, self.cfg, self.plan, attn_mode)


def param_tree(params) -> Dict[str, Any]:
    """The parameter dict of a :class:`DecoderLM` or of a dict."""
    return params.tree() if isinstance(params, _ParamTree) else params


# ---------------------------------------------------------------------------
# serving: KV cache + decode step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeCache:
    """Per-layer-stacked decode state.

    Attention layers: k/v (L, B, W, KV, hd) (+ per-token scales if int8),
    pos (B, W) absolute position per ring slot (-1: empty).  SSM layers:
    (ssm, conv) states.  ``length`` counts tokens already absorbed.  The
    fields are in the reference's order, which is the order of
    :meth:`leaves`."""

    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    ssm: Optional[Any] = None
    conv: Optional[Any] = None
    length: Optional[torch.Tensor] = None

    def leaves(self) -> List[torch.Tensor]:
        """The leaves in the reference's flattening order (``jax.tree.leaves``
        of its registered dataclass): k, v, k_scale, v_scale, pos, ssm, conv,
        length, with ``None`` fields left out."""
        out: List[torch.Tensor] = []
        for f in dataclasses.fields(self):
            out.extend(tree_util.flatten(getattr(self, f.name))[0])
        return out


def _n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.family in ("dense", "vlm", "moe"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // (cfg.hybrid_attn_every or 6)
    return 0


def _n_ssm_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


def cache_window(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_decode_cache(cfg: ModelConfig, plan: ParallelPlan, batch: int, max_len: int, device=None) -> DecodeCache:
    """An empty cache: ring K/V (and int8 scales) for the attention layers,
    zero float32 (ssm, conv) states for the SSM layers, ``length`` 0."""
    _check_family(cfg)
    La, Ls = _n_attn_layers(cfg), _n_ssm_layers(cfg)
    W = cache_window(cfg, max_len)
    dims = attn_dims(cfg, plan)
    int8 = plan.kv_cache_dtype == "int8"
    kv_dtype = torch.int8 if int8 else cfg.param_dtype
    c = DecodeCache(length=torch.zeros((), dtype=torch.int32, device=device))
    if La:
        shp = (La, batch, W, dims.n_kv, dims.hd)
        c.k = torch.zeros(shp, dtype=kv_dtype, device=device)
        c.v = torch.zeros(shp, dtype=kv_dtype, device=device)
        if int8:
            c.k_scale = torch.zeros(shp[:-1], dtype=torch.float32, device=device)
            c.v_scale = torch.zeros(shp[:-1], dtype=torch.float32, device=device)
        c.pos = torch.full((batch, W), -1, dtype=torch.int32, device=device)
    if Ls:
        ssm0, conv0 = init_ssm_state(cfg, batch, device=device)
        c.ssm = torch.zeros((Ls,) + tuple(ssm0.shape), dtype=ssm0.dtype, device=device)
        c.conv = torch.zeros((Ls,) + tuple(conv0.shape), dtype=conv0.dtype, device=device)
    return c


def decode_plan(plan: ParallelPlan) -> ParallelPlan:
    """The plan a decode step runs under: one token a sequence leaves no
    sequence to shard."""
    return dataclasses.replace(plan, seq_axes=()) if plan.seq_axes else plan


def _quantize_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head int8 (the paper's linear-scaling quantizer, radius
    127): x (..., hd) -> (codes int8 (..., hd), scale float32 (...)).

    ``kv_quantize`` on the transposed view (hd, tokens·heads): its per-column
    absmax is the per-token-and-head absmax, ``scale = max(absmax / 127,
    1e-8)`` and ``q = clip(rint(x / scale), ±127)``.  On a CUDA tensor that
    launches ``absmax`` and ``quantize_with_scale`` once each."""
    hd = x.shape[-1]
    cols = x.reshape(-1, hd).to(torch.float32).T.contiguous()
    q, scale = kv_quantize(cols)
    return q.T.reshape(x.shape), scale.reshape(x.shape[:-1])


def _decode_attn(p, x, layer_cache, length, pos_slot, cfg: ModelConfig, plan: ParallelPlan, features=None):
    """Single-token attention against the (possibly int8) ring cache.

    ``layer_cache`` is (k, v, k_scale, v_scale, pos) of one layer; the new
    token is written into its k/v (and scale) tensors in place at ring slot
    ``pos_slot`` (a 1-element int64 tensor), at int8 quantized per token
    and head by ``kv_quantize_append`` (what two :func:`_quantize_token`
    calls and four ``index_copy_`` would write).  Returns the output and
    (k, v, k_scale, v_scale, new_pos).

    ``features`` (the weight-stationary decode): ``x`` is the whole batch
    with this rank's features, split over these groups.  q, k and v are
    ``feature_products`` (one all-reduce), cut to this rank's batch rows
    (the cache's); the attention output is gathered over the batch axes
    before ``wo``, which writes this rank's features."""
    from ..parallel.specs import heads_shardable

    B = x.shape[0]
    dims = attn_dims(cfg, plan)
    hd = dims.hd
    shardable = heads_shardable(cfg, plan)
    if shardable:  # this rank's heads, as its cache holds them
        x = plan.tp_enter(x)
    k_c, v_c, ks_c, vs_c, pos_c = layer_cache
    q, k, v = (t.reshape(B, 1, -1, hd) for t in feature_products(x, [p["wq"], p["wk"], p["wv"]], features))
    if "bq" in p:
        q = q + p["bq"].reshape(1, 1, -1, hd)
        k = k + p["bk"].reshape(1, 1, -1, hd)
        v = v + p["bv"].reshape(1, 1, -1, hd)
    if features is not None:
        q, k, v = (comm.local_slice(t, 0, plan.dp_groups()) for t in (q, k, v))
        B = q.shape[0]
    posv = length.reshape(1, 1)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    if plan.kv_cache_dtype == "int8":
        kv_quantize_append(k, v, k_c, v_c, ks_c, vs_c, pos_slot)
        # dequantize to bf16 (one rounding of the product), accumulate the
        # attention products in float32 below
        kf = k_c.to(torch.bfloat16) * ks_c[..., None].to(torch.bfloat16)
        vf = v_c.to(torch.bfloat16) * vs_c[..., None].to(torch.bfloat16)
    else:
        k_c.index_copy_(1, pos_slot, k.to(k_c.dtype))
        v_c.index_copy_(1, pos_slot, v.to(v_c.dtype))
        kf, vf = k_c, v_c
    # mask: valid slots only (pos >= 0 and within the window of the new pos)
    new_pos = pos_c.index_copy(1, pos_slot, length.reshape(1, 1).expand(B, 1).to(torch.int32))
    valid = new_pos >= 0
    if cfg.sliding_window:
        valid &= (length - new_pos) < cfg.sliding_window
    G = dims.group
    qg = (q.reshape(B, -1, G, hd).to(torch.float32) / math.sqrt(hd)).to(kf.dtype)
    s = torch.einsum("bkgh,bwkh->bkgw", qg.to(torch.float32), kf.to(torch.float32))
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkh->bkgh", w.to(kf.dtype).to(torch.float32), vf.to(torch.float32))
    o = o.reshape(B, 1, -1).to(x.dtype)
    if features is not None:
        o = comm.all_gather(o, 0, plan.dp_groups())
    return plan.tp_project(o, p["wo"], shardable), (k_c, v_c, ks_c, vs_c, new_pos)


def lm_decode_step(
    params,
    cache: DecodeCache,
    tokens: torch.Tensor,  # (B, 1) int
    cfg: ModelConfig,
    plan: ParallelPlan,
) -> Tuple[torch.Tensor, DecodeCache]:
    """One serve step: consume one token per sequence, emit next-token
    logits (B, vocab) float32.  The cache is donated, as the reference's
    launcher donates it: its tensors are updated in place and the same
    object comes back with ``pos`` and ``length`` advanced.  The hybrid
    family's shared block reads and writes attention cache ``g`` at its
    ``g``-th application.

    Under ``plan.weight_stationary`` the parameters are
    ``parallel.specs.stationary_local``'s shards and ``tokens`` the whole
    batch: the stream holds every row and this rank's features, attention
    and the SSM recurrence run on the cache's rows (this rank's), and the
    logits come back whole."""
    params = param_tree(params)
    plan = decode_plan(plan)
    fs = plan.feature_groups() if plan.weight_stationary else None
    h = embed_tokens(params, tokens, cfg, plan)
    length = cache.length
    int8 = cache.k_scale is not None
    if cache.k is not None:
        slot = torch.remainder(length, cache.k.shape[2]).reshape(1).to(torch.int64)

    def attn_layer(h, lp, i):
        lc = (cache.k[i], cache.v[i], cache.k_scale[i] if int8 else None,
              cache.v_scale[i] if int8 else None, cache.pos)
        o, (_, _, _, _, new_pos) = _decode_attn(lp["attn"], apply_norm(lp["ln1"], h, features=fs), lc, length, slot,
                                                cfg, plan, fs)
        h = h + o
        hn = apply_norm(lp["ln2"], h, features=fs)
        if "moe" in lp:
            y, _ = apply_moe(lp["moe"], hn, cfg, plan, fs)
            return h + y, new_pos
        return h + apply_mlp(lp["mlp"], hn, cfg, plan, fs), new_pos

    def ssm_layer(h, i):
        lp = _layer(params["blocks"], i)
        o, (ssm, conv) = mamba2_decode_step(lp["ssm"], apply_norm(lp["ln"], h, features=fs),
                                            (cache.ssm[i], cache.conv[i]), cfg, plan, fs)
        cache.ssm[i].copy_(ssm)
        cache.conv[i].copy_(conv)
        return h + o

    new_pos = cache.pos
    if cfg.family in ("dense", "vlm", "moe"):
        pre = cfg.dense_prefix_layers if cfg.family == "moe" else 0
        for i in range(cfg.n_layers):
            lp = _layer(params["dense_blocks"], i) if i < pre else _layer(params["blocks"], i - pre)
            h, new_pos = attn_layer(h, lp, i)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = ssm_layer(h, i)
    elif cfg.family == "hybrid":
        k = cfg.hybrid_attn_every or 6
        n_groups = cfg.n_layers // k
        for g in range(n_groups):
            for i in range(g * k, (g + 1) * k):
                h = ssm_layer(h, i)
            h, new_pos = attn_layer(h, params["shared_attn"], g)
        for i in range(n_groups * k, cfg.n_layers):
            h = ssm_layer(h, i)
    else:
        raise ValueError(cfg.family)
    cache.pos = new_pos
    cache.length = length + 1
    h = apply_norm(params["final_norm"], h, features=fs)
    return full_logits(h, unembed_matrix(params, cfg), cfg, plan, fs)[:, 0], cache
