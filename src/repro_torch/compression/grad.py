"""Error-bounded gradient compression for the data-parallel reduction.

Schedule (per train step, on every rank of a ``torch.distributed`` process
group the caller passes):

  1. flatten the grad tree to one f32 vector (leaves in the JAX package's
     order, :mod:`repro_torch.tree`), cast bf16;
  2. reduce-scatter over the group (``reduce_scatter_tensor``, bf16 sum);
  3. divide by the group size (an IEEE divide), add the persistent
     error-feedback residual, encode the local shard with the jit codec
     facade (``core/jitmode``); the new residual is the shard minus its own
     decode, which carries the quantization error to the next step;
  4. all-gather the codes and side channels (``all_gather_into_tensor`` of
     one byte buffer per rank: scale, base, codes, tags), decode,
     crop each shard's tail padding, unflatten to the recorded per-leaf
     dtypes.

Collective bytes per rank: ~2N (RS bf16) + N*bits/8 + side channels (AG),
vs ~4N for a bf16 all-reduce (:func:`collective_bytes`).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Tuple, Union

import torch
import torch.distributed as dist

from .. import tree as tree_util
from ..core import jitmode
from ..core.jitmode import JitPolicy
from ..core.quantizers import true_div

BLOCK = 512
SCALE_FLOOR = jitmode.SCALE_FLOOR

PolicyLike = Union[int, str, JitPolicy]


def as_policy(policy: PolicyLike) -> JitPolicy:
    """Accept legacy bit counts (8/4), spec strings, or JitPolicy."""
    if isinstance(policy, JitPolicy):
        return policy
    if isinstance(policy, str):
        return JitPolicy.parse(policy)
    if policy in (8, 4):
        return JitPolicy(tier=f"int{policy}", bs=BLOCK)
    raise ValueError(f"bad gradient compression policy {policy!r}")


def _flatten_tree(tree) -> Tuple[torch.Tensor, Any]:
    leaves, treedef = tree_util.flatten(tree)
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    meta = (treedef, [(tuple(leaf.shape), leaf.dtype) for leaf in leaves])
    return flat, meta


def _unflatten_tree(flat: torch.Tensor, meta):
    treedef, shapes = meta
    out, pos = [], 0
    for shp, dt in shapes:
        n = 1
        for s in shp:
            n *= s
        # restore the RECORDED leaf dtype (a bf16 parameter keeps a bf16
        # gradient)
        out.append(flat[pos : pos + n].reshape(shp).to(dt))
        pos += n
    return tree_util.unflatten(treedef, out)


def _zero_policy(bits: int) -> JitPolicy:
    return JitPolicy(tier=f"int{bits}", bs=BLOCK, predictors=("zero",))


def quantize_shard(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric quantization; returns (codes int8, scales f32):
    the zero-predictor fixed tier of the jit facade."""
    c = jitmode.encode(x, _zero_policy(bits))
    return c.codes.reshape(-1), c.scale


def dequantize_shard(codes, scale, n: int, bits: int) -> torch.Tensor:
    nb = scale.shape[0]
    per = BLOCK // 2 if bits == 4 else BLOCK
    zeros = torch.zeros((nb,), dtype=torch.uint8, device=codes.device)
    xb = jitmode.decode_blocks(codes.reshape(nb, per), scale, zeros, zeros.to(torch.float32), bits)
    return xb.reshape(-1)[:n]


def _collective(fn, out, inp, group, **kw) -> None:
    # these names exist from torch 2.0 on; newer versions warn that they
    # are deprecated for ``*_single`` ones, which older versions lack
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(out, inp, group=group, **kw)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def compressed_reduce_flat(
    flat: torch.Tensor,  # this rank's partial grad vector
    feedback: torch.Tensor,  # this rank's error-feedback shard, (ceil(N/dp),)
    group,
    policy: PolicyLike,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (reduced flat vector, new feedback) on every rank of
    ``group`` (``None``: the default group)."""
    pol = as_policy(policy)
    dp = dist.get_world_size(group)
    n = flat.shape[0]
    pad = (-n) % dp
    fp = torch.nn.functional.pad(flat.to(torch.float32), (0, pad)).to(torch.bfloat16)
    shard_bf16 = torch.empty(fp.shape[0] // dp, dtype=torch.bfloat16, device=fp.device)
    _collective(dist.reduce_scatter_tensor, shard_bf16, fp, group, op=dist.ReduceOp.SUM)
    shard = true_div(shard_bf16.to(torch.float32), float(dp)) + feedback
    m = shard.shape[0]
    c = jitmode.encode(shard, pol)
    new_feedback = shard - jitmode.decode(c)
    # one byte buffer per rank (every rank's shard has the same length, so
    # every field has the same size on every rank); the float32 fields go
    # first, so that each stays 4-byte aligned inside the buffer
    fields = {"scale": c.scale, "base": c.base, "codes": c.codes, "tags": c.tags}
    mine = torch.cat([_as_bytes(a) for a in fields.values()])
    gathered = torch.empty(dp * mine.numel(), dtype=torch.uint8, device=mine.device)
    _collective(dist.all_gather_into_tensor, gathered, mine, group)
    rows = gathered.view(dp, -1)
    parts, pos = {}, 0
    for name, a in fields.items():
        size = a.numel() * a.element_size()
        part = rows[:, pos : pos + size].reshape(-1).view(a.dtype)
        parts[name] = part.reshape(dp * a.shape[0], *a.shape[1:])
        pos += size
    # each shard's blocks carry their own tail padding (m need not divide
    # the block size), so crop per shard before re-flattening
    xb = jitmode.decode_blocks(parts["codes"], parts["scale"], parts["tags"], parts["base"], pol.bits)
    out = xb.reshape(dp, -1)[:, :m].reshape(-1)[:n]
    return out, new_feedback


def init_feedback(params, dp: int) -> torch.Tensor:
    """This rank's zero feedback shard, ``ceil(N/dp)`` long: the JAX
    package's ``init_feedback`` is the whole padded vector, which its
    ``shard_map`` splits over the ``dp`` devices."""
    leaves, _ = tree_util.flatten(params)
    n = sum(leaf.numel() for leaf in leaves)
    return torch.zeros(((n + (-n) % dp) // dp,), dtype=torch.float32, device=leaves[0].device)


def compressed_reduce_tree(grads, feedback, group, policy: PolicyLike):
    flat, meta = _flatten_tree(grads)
    out, fb = compressed_reduce_flat(flat, feedback, group, policy)
    return _unflatten_tree(out, meta), fb


def collective_bytes(n: int, dp: int, policy: PolicyLike) -> Dict[str, float]:
    """Per-rank DP-collective byte model for one reduction of n floats.

    Baseline: bf16 all-reduce ~= reduce-scatter + all-gather at 2 B/elem
    => 4n.  Compressed: bf16 reduce-scatter (2n) + code all-gather
    (n*bits/8 plus scale/tag/base side channels per block).
    """
    pol = as_policy(policy)
    n_pad = n + ((-n) % max(dp, 1))
    m = n_pad // max(dp, 1)
    nb = -(-m // pol.bs)
    code_bytes_shard = nb * pol.bs * pol.bits // 8 + nb * (4 + 1 + 4)
    rs = 2.0 * n_pad
    ag = float(dp * code_bytes_shard)
    baseline = 4.0 * n_pad
    return {
        "baseline_bf16_allreduce": baseline,
        "rs_bytes": rs,
        "ag_bytes": ag,
        "compressed_total": rs + ag,
        "cut_vs_bf16_allreduce": baseline / (rs + ag),
    }
