"""Model zoo facade: family dispatch for init / loss / prefill / decode.

All six families of the JAX package (``repro/models``) run here: the dense,
VLM, MoE, SSM and hybrid decoders (``models/lm.py``, a
:class:`DecoderLM`) and the encoder-decoder (``models/encdec.py``, an
:class:`EncoderDecoder`).  Entry points run on the card unless given
``device="cpu"``.  Parameters are made under ``torch.no_grad()`` and do not
require grad; the trainer (``repro_torch.train.step``) turns gradients on
for what it trains.
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
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(key))
    with torch.no_grad():
        if cfg.family == "encdec":
            return EncoderDecoder(cfg, plan, _encdec.init_encdec(gen, cfg, plan))
        return DecoderLM(cfg, plan, _lm.init_lm(gen, cfg, plan))


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, plan: ParallelPlan,
            attn_mode: str = "blocked") -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch`` (``tokens`` or
    ``embeds``, ``enc_frames`` for the encoder-decoder, and ``labels``)."""
    if cfg.family == "encdec":
        return _encdec.encdec_loss(params, batch, cfg, plan, attn_mode)
    _lm._check_family(cfg)
    return _lm.lm_loss(params, batch, cfg, plan, attn_mode)


def prefill_logits(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, plan: ParallelPlan,
                   attn_mode: str = "blocked") -> torch.Tensor:
    """Inference prefill: forward to the final hidden state, then the
    last position's logits (B, vocab) float32."""
    params = _lm.param_tree(params)
    if cfg.family == "encdec":
        enc_out = _encdec.encode(params, batch["enc_frames"], cfg, plan)
        hidden = _encdec.decode_train(params, batch["tokens"], enc_out, cfg, plan, attn_mode)
    else:
        if "embeds" in batch:
            x = plan.act_btd(batch["embeds"].to(cfg.param_dtype))
        else:
            x = _lm.embed_tokens(params, batch["tokens"], cfg, plan)
        hidden, _ = _lm.lm_backbone(params, x, cfg, plan, attn_mode)
    w = _lm.unembed_matrix(params, cfg)
    logits = (hidden[:, -1:, :] @ w).to(torch.float32)
    return logits[:, 0, : cfg.vocab]


def init_cache(params, cfg: ModelConfig, plan: ParallelPlan, batch: int, max_len: int,
               enc_frames=None) -> Union[DecodeCache, EncDecCache]:
    """An empty decode cache on the model's device; the encoder-decoder's
    runs the encoder over ``enc_frames`` (B, enc_seq, d) for the cross
    K/V."""
    if cfg.family == "encdec":
        with torch.no_grad():
            return _encdec.init_encdec_cache(params, enc_frames, cfg, plan, batch, max_len)
    device = _lm.param_tree(params)["embed"].device
    return _lm.init_decode_cache(cfg, plan, batch, max_len, device=device)


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan):
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
