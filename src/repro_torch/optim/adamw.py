"""AdamW with optional error-bounded 8-bit moment compression.

Pure-functional (init/update) over parameter trees (nested dicts, lists and
tuples of tensors, walked in the JAX package's leaf order); moments are
stored either in f32 or as jit-codec blocks (``compression/opt_state.py``):
``m`` linear, ``v`` in the log2 domain.

Against the JAX package the update agrees within rounding, not bits:
``_global_norm`` sums each leaf in torch's order and the bias corrections
``b ** step`` are float32 ``pow`` calls of each library.  Every divide by a
scalar is an IEEE divide on every device.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple

import numpy as np
import torch

from .. import tree as tree_util
from ..compression import opt_state as oc


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_moments: bool = False  # blockwise jit-codec moments
    moment_policy: str = ""  # jitmode policy spec, e.g. "int8:bs=256";
    # empty = opt_state.DEFAULT_POLICY


def _moment_policy(cfg: AdamWConfig):
    if cfg.moment_policy:
        return oc.JitPolicy.parse(cfg.moment_policy)
    return None


def init_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments for ``params``, on each parameter's device."""
    pol = _moment_policy(cfg)

    def zeros(domain):
        def init(p):
            if cfg.compress_moments:
                return oc.init_compressed(p, pol, domain=domain)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return init

    leaves, _ = tree_util.flatten(params)
    return {
        # m linear (signed, block-REL bound); v in log2 domain — a block-REL
        # bound on v lets small entries collapse to 0 and m/sqrt(v) diverge
        "m": tree_util.tree_map(zeros("linear"), params),
        "v": tree_util.tree_map(zeros("log2"), params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def _global_norm(tree, reduce=None) -> torch.Tensor:
    """The L2 norm over every leaf.  ``reduce`` maps the leaves' sums of
    squares (this rank's, in leaf order) to the whole tree's, for a tree of
    shards (``train/step.py``)."""
    leaves, _ = tree_util.flatten(tree)
    sums = [torch.sum(g.to(torch.float32) ** 2) for g in leaves]
    if reduce is not None:
        sums = reduce(sums)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for s in sums:  # (0 + s_0) + s_1 + ..., the reference's reduce order
        total = total + s
    return torch.sqrt(total)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def leaf_update(grads, state, cfg: AdamWConfig, lr_scale, reduce=None):
    """The step's shared scalars and the per-leaf update
    ``upd(p, g, m, v) -> (p_new, m_new, v_new)``; ``reduce`` as for
    :func:`_global_norm`."""
    step = state["step"] + 1
    gnorm = _global_norm(grads, reduce)
    # tensor / tensor: torch computes ``float / tensor`` as a reciprocal
    # times the float
    clip = torch.clamp_max(_scalar(cfg.grad_clip, gnorm) / torch.clamp_min(gnorm, 1e-12), 1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    lr = cfg.lr * lr_scale
    pol = _moment_policy(cfg)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m_f = oc.decompress(m) if cfg.compress_moments else m
        v_f = oc.decompress(v) if cfg.compress_moments else v
        # v is a variance: block quantization error within the bound can
        # push small entries below zero, which sqrt would turn into NaN
        v_f = torch.clamp_min(v_f, 0.0)
        m_new = b1 * m_f + (1 - b1) * g
        v_new = b2 * v_f + (1 - b2) * (g * g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if cfg.compress_moments:
            m_new = oc.compress(m_new, pol)
            v_new = oc.compress_nonneg(v_new, pol)
        return p_new, m_new, v_new

    return step, gnorm, upd


def _flat(params, grads, state):
    flat_p, treedef = tree_util.flatten(params)
    rest = [tree_util.flatten_up_to(treedef, t) for t in (grads, state["m"], state["v"])]
    return flat_p, treedef, rest


def update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics)."""
    step, gnorm, upd = leaf_update(grads, state, cfg, lr_scale)
    flat_p, treedef, (flat_g, flat_m, flat_v) = _flat(params, grads, state)
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_params = tree_util.unflatten(treedef, [o[0] for o in out])
    new_m = tree_util.unflatten(treedef, [o[1] for o in out])
    new_v = tree_util.unflatten(treedef, [o[2] for o in out])
    return new_params, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm}


def write_(dst, src) -> None:
    if isinstance(dst, oc.Compressed):
        for name in dst.ARRAYS:
            getattr(dst, name).copy_(getattr(src, name))
    else:
        dst.copy_(src)


# ---------------------------------------------------------------------------
# state carried across packages
# ---------------------------------------------------------------------------

def state_to_numpy(state) -> Dict[str, Any]:
    """The state with every tensor as a numpy array and every compressed
    moment as the dict of :meth:`Compressed.to_numpy`."""
    def conv(leaf):
        if isinstance(leaf, oc.Compressed):
            return leaf.to_numpy()
        return leaf.detach().cpu().numpy()

    return {
        "m": tree_util.tree_map(conv, state["m"]),
        "v": tree_util.tree_map(conv, state["v"]),
        "step": state["step"].detach().cpu().numpy(),
    }


def state_from_numpy(state: Mapping[str, Any], params, device=None) -> Dict[str, Any]:
    """Build the port's state from numpy arrays, as the JAX package's
    ``init_state``/``update`` lay it out: ``m`` and ``v`` in ``params``'
    structure, each moment an array or a dict of a ``Compressed``'s fields,
    and ``step``.  Lands on ``device`` (default ``"cuda"``)."""
    from ..core.pipeline import resolve_device

    dev = resolve_device(device)
    _, treedef = tree_util.flatten(params)

    def conv(leaf):
        if isinstance(leaf, Mapping):
            return oc.Compressed.from_numpy(leaf, dev)
        return torch.from_numpy(np.array(leaf, np.float32)).to(dev)

    def moments(t):
        return tree_util.unflatten(treedef, [conv(leaf) for leaf in tree_util.flatten_up_to(treedef, t)])

    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=dev)
    return {"m": moments(state["m"]), "v": moments(state["v"]), "step": step}
