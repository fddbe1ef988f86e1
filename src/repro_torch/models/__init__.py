"""Model zoo facade: family dispatch for init / loss / prefill / decode.

The dense and VLM families (``repro/models``) run here; the ``moe``,
``ssm``, ``hybrid`` and ``encdec`` families are slice 11c of the port
(``ROADMAP.md``): they raise ``NotImplementedError``.  Entry points run on
the card unless given ``device="cpu"``.  Parameters are made under
``torch.no_grad()`` and do not require grad; the trainer
(``repro_torch.train.step``) turns gradients on for what it trains.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from ..parallel.plan import ParallelPlan
from . import lm as _lm
from .carry import cache_from_numpy, params_from_numpy, train_state_from_numpy, train_state_to_numpy
from .common import ModelConfig
from .lm import DecodeCache, DecoderLM

Key = Union[int, torch.Generator]


def init_params(key: Key, cfg: ModelConfig, plan: ParallelPlan, device=None) -> DecoderLM:
    """A :class:`DecoderLM` drawn from ``key``: a ``torch.Generator`` (its
    device holds the model) or an int seed for a generator on ``device``
    (default ``"cuda"``)."""
    from ..core.pipeline import resolve_device

    _lm._check_family(cfg)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(int(key))
    with torch.no_grad():
        return DecoderLM(cfg, plan, _lm.init_lm(gen, cfg, plan))


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, plan: ParallelPlan,
            attn_mode: str = "blocked") -> torch.Tensor:
    """The training loss (float32 scalar) of ``batch`` (``tokens`` or
    ``embeds``, and ``labels``)."""
    _lm._check_family(cfg)
    return _lm.lm_loss(params, batch, cfg, plan, attn_mode)


def prefill_logits(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, plan: ParallelPlan,
                   attn_mode: str = "blocked") -> torch.Tensor:
    """Inference prefill: forward to the final hidden state, then the
    last position's logits (B, vocab) float32."""
    params = _lm.param_tree(params)
    if "embeds" in batch:
        x = plan.act_btd(batch["embeds"].to(cfg.param_dtype))
    else:
        x = _lm.embed_tokens(params, batch["tokens"], cfg, plan)
    hidden, _ = _lm.lm_backbone(params, x, cfg, plan, attn_mode)
    w = _lm.unembed_matrix(params, cfg)
    logits = (hidden[:, -1:, :] @ w).to(torch.float32)
    return logits[:, 0, : cfg.vocab]


def init_cache(params, cfg: ModelConfig, plan: ParallelPlan, batch: int, max_len: int,
               enc_frames=None) -> DecodeCache:
    """An empty decode cache on the model's device."""
    device = _lm.param_tree(params)["embed"].device
    return _lm.init_decode_cache(cfg, plan, batch, max_len, device=device)


def decode_step(params, cache: DecodeCache, tokens: torch.Tensor, cfg: ModelConfig, plan: ParallelPlan):
    return _lm.lm_decode_step(params, cache, tokens, cfg, plan)


__all__ = [
    "ModelConfig",
    "DecoderLM",
    "DecodeCache",
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
