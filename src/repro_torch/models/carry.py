"""Carry the JAX package's parameters and decode caches into the port.

JAX and torch draw different numbers from the same seed, so parity between
the packages goes through the reference's own arrays: a parameter tree from
``jax.device_get`` (nested dicts of numpy arrays, bf16 leaves as
``ml_dtypes.bfloat16``) becomes a :class:`DecoderLM`, a reference
``DecodeCache`` a :class:`DecodeCache`.  bf16 crosses through the
checkpoint manager's :func:`repro_torch.ft.checkpoint.as_tensor`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .. import tree as tree_util
from ..ft.checkpoint import as_tensor
from ..parallel.plan import single_device_plan
from .common import ModelConfig
from .lm import DecodeCache, DecoderLM


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig, device=None) -> DecoderLM:
    """The reference's parameter tree as a :class:`DecoderLM` on ``device``
    (default ``"cuda"``); every leaf must already have ``cfg``'s dtype."""
    from ..core.pipeline import resolve_device

    dev = resolve_device(device)
    leaves, treedef = tree_util.flatten(dict(tree))
    tensors = [_leaf(leaf, dev) for leaf in leaves]
    for t in tensors:
        if t.dtype != cfg.param_dtype:
            raise ValueError(f"a parameter leaf is {t.dtype}, the config's dtype is {cfg.param_dtype}")
    return DecoderLM(cfg, single_device_plan(), tree_util.unflatten(treedef, tensors))


def cache_from_numpy(cache: Any, device=None) -> DecodeCache:
    """A reference ``DecodeCache`` (or a mapping of its field names) with
    numpy or JAX leaves, as the port's :class:`DecodeCache` on ``device``
    (default ``"cuda"``)."""
    from ..core.pipeline import resolve_device

    dev = resolve_device(device)

    def field(name):
        value = cache.get(name) if isinstance(cache, Mapping) else getattr(cache, name, None)
        return None if value is None else tree_util.tree_map(lambda a: _leaf(a, dev), value)

    return DecodeCache(**{f.name: field(f.name) for f in dataclasses.fields(DecodeCache)})


def _leaf(a, dev: torch.device) -> torch.Tensor:
    """A leaf on ``dev``, copied (JAX hands out read-only host arrays)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(dev)
    return as_tensor(np.array(a)).to(dev)
