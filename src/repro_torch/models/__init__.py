"""Model zoo facade: family dispatch for init / loss / prefill / decode.

All six families of the JAX package (``repro/models``) run here: the dense,
VLM, MoE, SSM and hybrid decoders (``models/lm.py``, a
:class:`DecoderLM`) and the encoder-decoder (``models/encdec.py``, an
:class:`EncoderDecoder`).  Entry points run on the card unless given
``device="cpu"`` (``device="meta"`` draws the tree's shapes only).
Parameters are made under ``torch.no_grad()`` and do not require grad; the
trainer (``repro_torch.train.step``) turns gradients on for what it trains.

On a plan with a mesh the entry points take the parameters whole on every
rank or as DTensors in ``param_specs`` placements, and run on this rank's
view of them (``parallel.specs.model_local``); ``local=True`` says the
tree is that view already (the train step's ``parallel.specs.fsdp_view``,
whose stacked layer leaves the layer loop gathers).  The batch is this
rank's rows, except in the weight-stationary decode
(``ParallelPlan.weight_stationary``), which keeps every weight at its
shard and takes the whole batch (:func:`decode_step`).
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from ..parallel.plan import ParallelPlan
from . import encdec as _encdec
from . import lm as _lm
from .carry import cache_from_numpy, params_from_numpy, train_state_from_numpy, train_state_to_numpy
from .common import ModelConfig
from .encdec import EncDecCache, EncoderDecoder
from .lm import DecodeCache, DecoderLM

Key = Union[int, torch.Generator]
Model = Union[DecoderLM, EncoderDecoder]


def init_params(key: Key, cfg: ModelConfig, plan: ParallelPlan, device=None) -> Model:
    """The model drawn from ``key``: a ``torch.Generator`` (its device
    holds the model) or an int seed for a generator on ``device`` (default
    ``"cuda"``)."""
    from ..core.pipeline import resolve_device

    if isinstance(key, torch.Generator):
        gen = key
    elif device is not None and torch.device(device).type == "meta":
        from .layers import MetaGenerator

        gen = MetaGenerator()
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(key))
    with torch.no_grad():
        if cfg.family == "encdec":
            return EncoderDecoder(cfg, plan, _encdec.init_encdec(gen, cfg, plan))
        return DecoderLM(cfg, plan, _lm.init_lm(gen, cfg, plan))


def _view(params, cfg: ModelConfig, plan: ParallelPlan, local: bool):
    if local or plan.mesh is None:
        return params
    from ..parallel.specs import model_local

    return model_local(params, cfg, plan)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, plan: ParallelPlan,
            attn_mode: str = "blocked", local: bool = False) -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch`` (``tokens`` or
    ``embeds``, ``enc_frames`` for the encoder-decoder, and ``labels``).
    On a mesh: the loss of this rank's rows, equal over the model axis."""
    params = _view(params, cfg, plan, local)
    if cfg.family == "encdec":
        return _encdec.encdec_loss(params, batch, cfg, plan, attn_mode)
    _lm._check_family(cfg)
    return _lm.lm_loss(params, batch, cfg, plan, attn_mode)


def prefill_logits(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, plan: ParallelPlan,
                   attn_mode: str = "blocked", local: bool = False) -> torch.Tensor:
    """Inference prefill: forward to the final hidden state, then the
    last position's logits (B, vocab) float32."""
    params = _view(_lm.param_tree(params), cfg, plan, local)
    if cfg.family == "encdec":
        enc_out = _encdec.encode(params, batch["enc_frames"], cfg, plan)
        hidden = _encdec.decode_train(params, batch["tokens"], enc_out, cfg, plan, attn_mode)
    else:
        if "embeds" in batch:
            x = plan.act_btd(plan.to_stream(batch["embeds"].to(cfg.param_dtype)))
        else:
            x = _lm.embed_tokens(params, batch["tokens"], cfg, plan)
        hidden, _ = _lm.lm_backbone(params, x, cfg, plan, attn_mode)
    return _lm.full_logits(hidden[:, -1:, :], _lm.unembed_matrix(params, cfg), cfg, plan)[:, 0]


def init_cache(params, cfg: ModelConfig, plan: ParallelPlan, batch: int, max_len: int,
               enc_frames=None) -> Union[DecodeCache, EncDecCache]:
    """An empty decode cache on the model's device, whole (every rank of a
    mesh holds all of it; ``serve.step.jit_serve_step`` places it); the
    encoder-decoder's runs the encoder over ``enc_frames`` (B, enc_seq, d)
    for the cross K/V."""
    if cfg.family == "encdec":
        with torch.no_grad():
            cache = _encdec.init_encdec_cache(_view(params, cfg, plan, False), enc_frames, cfg, plan, batch,
                                              max_len)
        if plan.tp > 1:
            from ..parallel import comm
            from ..parallel.specs import heads_shardable

            if heads_shardable(cfg, plan):  # this rank's heads, gathered
                cache.cross_k = comm.all_gather(cache.cross_k, 3, plan.tp_groups)
                cache.cross_v = comm.all_gather(cache.cross_v, 3, plan.tp_groups)
        return cache
    embed = _lm.param_tree(params)["embed"]
    device = (embed.to_local() if hasattr(embed, "to_local") else embed).device
    return _lm.init_decode_cache(cfg, plan, batch, max_len, device=device)


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan, local: bool = False):
    """One decode step (``lm_decode_step`` or ``encdec_decode_step``): the
    cache's tensors are this rank's view, as ``serve.step.jit_serve_step``
    gives them.  Under ``plan.weight_stationary`` the step runs on
    ``parallel.specs.stationary_local``'s view (every weight at its shard;
    ``local=True``: the tree is that view already) and ``tokens`` is the
    whole batch."""
    if plan.weight_stationary and not local:
        from ..parallel.specs import stationary_local

        params = stationary_local(params, cfg, plan)
    else:
        params = _view(params, cfg, plan, local)
    if cfg.family == "encdec":
        return _encdec.encdec_decode_step(params, cache, tokens, cfg, plan)
    return _lm.lm_decode_step(params, cache, tokens, cfg, plan)


__all__ = [
    "ModelConfig",
    "DecoderLM",
    "EncoderDecoder",
    "DecodeCache",
    "EncDecCache",
    "init_params",
    "loss_fn",
    "prefill_logits",
    "init_cache",
    "decode_step",
    "params_from_numpy",
    "cache_from_numpy",
    "train_state_from_numpy",
    "train_state_to_numpy",
]
