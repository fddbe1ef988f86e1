"""Carry the JAX package's parameters, decode caches and train states into
the port, and train states back.

JAX and torch draw different numbers from the same seed, so parity between
the packages goes through the reference's own arrays: a parameter tree from
``jax.device_get`` (nested dicts of numpy arrays, bf16 leaves as
``ml_dtypes.bfloat16``) becomes a :class:`DecoderLM` or an
:class:`EncoderDecoder`, a reference ``DecodeCache`` or ``EncDecCache`` the
port's, and a reference train state
(``init_train_state``'s ``{params, opt{m, v, step}, feedback?}``, moments
plain or compressed) the port's (:func:`train_state_from_numpy`).  bf16
crosses through the checkpoint manager's
:func:`repro_torch.ft.checkpoint.as_tensor`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .. import tree as tree_util
from ..ft.checkpoint import as_tensor
from ..parallel.plan import single_device_plan
from .common import ModelConfig
from .encdec import EncDecCache, EncoderDecoder
from .lm import DecodeCache, DecoderLM


#: the leaves the reference keeps in float32 whatever the model's dtype:
#: the MoE router and the Mamba2 decay, skip and step-bias vectors
FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias")


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig, device=None):
    """The reference's parameter tree as a :class:`DecoderLM` (an
    :class:`EncoderDecoder` for the ``encdec`` family) on ``device``
    (default ``"cuda"``); every leaf must already have ``cfg``'s dtype, or
    float32 where the reference keeps it so (:data:`FLOAT32_LEAVES`)."""
    from ..core.pipeline import resolve_device

    dev = resolve_device(device)
    pairs, treedef = tree_util.flatten_with_path(dict(tree))
    tensors = []
    for path, leaf in pairs:
        t = _leaf(leaf, dev)
        want = torch.float32 if path.rsplit("/", 1)[-1] in FLOAT32_LEAVES else cfg.param_dtype
        if t.dtype != want:
            raise ValueError(f"parameter {path} is {t.dtype}, expected {want}")
        tensors.append(t)
    cls = EncoderDecoder if cfg.family == "encdec" else DecoderLM
    return cls(cfg, single_device_plan(), tree_util.unflatten(treedef, tensors))


def cache_from_numpy(cache: Any, device=None):
    """A reference ``DecodeCache`` or ``EncDecCache`` (or a mapping of its
    field names) with numpy or JAX leaves, as the port's
    :class:`DecodeCache` or :class:`EncDecCache` on ``device`` (default
    ``"cuda"``)."""
    from ..core.pipeline import resolve_device

    dev = resolve_device(device)

    def field(name):
        value = cache.get(name) if isinstance(cache, Mapping) else getattr(cache, name, None)
        return None if value is None else tree_util.tree_map(lambda a: _leaf(a, dev), value)

    sc = cache.get("self_cache") if isinstance(cache, Mapping) else getattr(cache, "self_cache", None)
    if sc is not None:
        return EncDecCache(self_cache=cache_from_numpy(sc, device=dev), cross_k=field("cross_k"),
                           cross_v=field("cross_v"))
    return DecodeCache(**{f.name: field(f.name) for f in dataclasses.fields(DecodeCache)})


def _moment_dict(leaf):
    """A moment leaf as ``adamw.state_from_numpy`` takes it: an array, or
    the dict of a compressed moment's fields (the reference's
    ``Compressed`` dataclass, or a dict of its fields)."""
    if isinstance(leaf, Mapping) or not hasattr(leaf, "orig_last"):
        return leaf
    return {f: getattr(leaf, f) for f in ("codes", "scale", "tags", "base", "orig_last", "bits", "domain")}


def train_state_from_numpy(state: Mapping[str, Any], cfg: ModelConfig, device=None, dp_rank: int = 0,
                           dp: int = 1) -> Dict[str, Any]:
    """A reference train state (numpy or JAX leaves) as the port's train
    state on ``device`` (default ``"cuda"``): ``params`` (tensors not
    requiring grad), ``opt`` (``m`` and ``v`` plain or compressed, and
    ``step``) and, when present, ``feedback``, of which this rank takes its
    shard: the reference's feedback is the whole padded vector, which its
    ``shard_map`` splits over the ``dp`` devices."""
    from ..optim import adamw

    params = tree_util.tree_map(lambda t: t.detach(), params_from_numpy(state["params"], cfg, device=device).tree())
    dev = tree_util.flatten(params)[0][0].device
    opt = state["opt"]
    _, treedef = tree_util.flatten(params)

    def moments(t):
        return tree_util.unflatten(treedef, [_moment_dict(leaf) for leaf in tree_util.flatten_up_to(treedef, t)])

    out = {"params": params,
           "opt": adamw.state_from_numpy({"m": moments(opt["m"]), "v": moments(opt["v"]), "step": opt["step"]},
                                         params, device=dev)}
    if state.get("feedback") is not None:
        fb = _leaf(state["feedback"], dev)
        out["feedback"] = fb.reshape(dp, -1)[dp_rank].clone()
    return out


def train_state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's train state as numpy: ``params`` as arrays (bf16 as
    ``ml_dtypes.bfloat16`` where that package imports, else the 2-byte
    void dtype the checkpoints record), ``opt`` as
    ``adamw.state_to_numpy`` gives it (a compressed moment as the dict of
    its fields) and ``feedback``."""
    from ..optim import adamw

    out = {"params": tree_util.tree_map(_to_numpy, state["params"]), "opt": adamw.state_to_numpy(state["opt"])}
    if state.get("feedback") is not None:
        out["feedback"] = _to_numpy(state["feedback"])
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    raw = t.view(torch.int16).numpy()
    try:
        import ml_dtypes
    except ImportError:  # pragma: no cover - numpy alone has no bfloat16
        return raw.view(np.dtype("V2"))
    return raw.view(ml_dtypes.bfloat16)


def _leaf(a, dev: torch.device) -> torch.Tensor:
    """A leaf on ``dev``, copied (JAX hands out read-only host arrays)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(dev)
    return as_tensor(np.array(a)).to(dev)
