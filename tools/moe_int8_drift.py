"""The int8 KV cache's log-probability drift of a MoE model at full width,
read on the CPU from the JAX package (``repro``) and from the port
(``repro_torch``) at the same weights and tokens.

The weights are the port's ``models.init_params(seed, cfg, device="cpu")``
with the depth cut to ``--layers``; they cross into the reference's tree
leaf by leaf.  The tokens are ``np.random.default_rng(seed)``'s, (4, 16).
Each side runs 16 teacher-forced decode steps with the KV cache in bf16
and again in int8; the drift is the largest |log-softmax difference| of the
last step's logits (``tests/test_models_smoke.py``'s measure).  Readings:

* ``drift``: the routing free, as a user's run;
* ``drift_routing_pinned``: the int8 run takes the bf16 run's top-k ids in
  every MoE call, which leaves the int8 noise alone;
* ``topk_set_changed``: (call, token) pairs whose top-k set the int8 run
  changed, of ``assignments``.

The reference's line also holds its top-k ids (``routing_bf16``,
``routing_int8``); the port is read again with those ids pinned
(``with_reference_routing``), which takes the reference's routing flips
and leaves the numerics the port's own.  ``chip_smoke.py`` rebuilds the
same weights on the card (it checks ``weights_sha256``) and holds the
card's readings against the reference's through :func:`port_readings`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_int8_drift.py \\
        --arch deepseek-moe-16b --layers 3 --seeds 0 1 2 --out readings.json

One line of JSON per seed (``--out`` also writes them as a list, routing
included).  deepseek-moe-16b at 8 layers holds 9.2 GB of bf16 weights: the
port's tensors are freed as they cross, and the port's model is drawn
again once the reference's is gone, so the peak stays near one copy.
Only the reference's runs import JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import time

import numpy as np
import torch

B, T = 4, 16


def fingerprint(tree) -> str:
    """sha256 over every leaf's path, dtype, shape and a strided sample of
    its bits (about 4096 elements a leaf)."""
    h = hashlib.sha256()

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
            return
        flat = node.detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
        h.update(f"{prefix}:{flat.dtype}:{tuple(node.shape)}".encode())
        h.update(bits[:: max(1, flat.numel() // 4096)].cpu().numpy().tobytes())

    walk("", tree)
    return h.hexdigest()


def drift(logits: np.ndarray, ref_logits: np.ndarray) -> float:
    """The largest |log-softmax difference| (float64)."""
    def log_softmax(x):
        x = x.astype(np.float64)
        m = x.max(-1, keepdims=True)
        return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))

    return float(np.abs(log_softmax(logits) - log_softmax(ref_logits)).max())


def set_changes(routing, other) -> int:
    """(call, token) pairs whose top-k set differs between two runs."""
    return sum(int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum()) for a, b in zip(routing, other))


def readings(bf, i8, pinned, routing_bf, routing_i8) -> dict:
    return {"drift": drift(i8, bf), "drift_routing_pinned": drift(pinned, bf),
            "topk_set_changed": set_changes(routing_bf, routing_i8),
            "assignments": sum(a.shape[0] for a in routing_bf), "logit_scale": float(np.abs(bf).max())}


@contextlib.contextmanager
def port_routing(pin=None):
    """The port's MoE routing for the block: each call's top-k ids recorded
    into the yielded list and, with ``pin`` (one (T, k) array a call, in
    call order), replaced by the pinned ids (the gates are the call's own
    probabilities at those ids, renormalized, as ``_route`` makes them)."""
    from repro_torch.models import moe

    real = moe._route
    calls, pins = [], list(pin or [])

    def route(x, router, top_k, *rest):
        probs, gates, idx = real(x, router, top_k, *rest)
        if pin is not None:
            idx = torch.as_tensor(np.asarray(pins.pop(0)), device=idx.device, dtype=idx.dtype)
            gates = torch.gather(probs, -1, idx)
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        calls.append(idx)
        return probs, gates, idx

    moe._route = route
    try:
        yield calls
    finally:
        moe._route = real


def port_decode(model, cfg, tokens: np.ndarray, kv: str, pin=None):
    """16 teacher-forced steps of ``models.decode_step`` on the model's
    device: the last step's logits (float32, numpy) and each MoE call's
    top-k ids."""
    from repro_torch import models
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import ParallelPlan

    plan = ParallelPlan(kv_cache_dtype=kv)
    dev = next(iter(model.parameters())).device
    toks = torch.from_numpy(tokens).to(dev)
    cache = models.init_cache(model, cfg, plan, toks.shape[0], toks.shape[1] + 8)
    with port_routing(pin) as calls, float32_bf16_reductions(), torch.no_grad():
        for t in range(toks.shape[1]):
            logits, cache = models.decode_step(model, cache, toks[:, t : t + 1], cfg, plan)
    return logits.float().cpu().numpy(), [c.cpu().numpy() for c in calls]


def port_readings(model, cfg, tokens: np.ndarray, reference: dict = None) -> dict:
    """The port's readings on the model's device; with ``reference`` (a
    line of this tool's), also with the reference's top-k ids pinned."""
    bf, rbf = port_decode(model, cfg, tokens, "bf16")
    i8, ri8 = port_decode(model, cfg, tokens, "int8")
    pinned, _ = port_decode(model, cfg, tokens, "int8", rbf)
    out = readings(bf, i8, pinned, rbf, ri8)
    if reference is not None:
        ref_bf, ref_i8 = reference["routing_bf16"], reference["routing_int8"]
        bf, _ = port_decode(model, cfg, tokens, "bf16", ref_bf)
        i8, _ = port_decode(model, cfg, tokens, "int8", ref_i8)
        pinned, _ = port_decode(model, cfg, tokens, "int8", ref_bf)
        out["with_reference_routing"] = {"drift": drift(i8, bf), "drift_routing_pinned": drift(pinned, bf)}
    return out


def reference_readings(params, rcfg, tokens: np.ndarray) -> dict:
    """The same three runs through the JAX package's jitted decode step;
    ``jax.lax.top_k`` is wrapped for them to record (and pin) the ids
    through ordered host callbacks."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import io_callback

    from repro import models
    from repro.parallel import ParallelPlan

    real_top_k = jax.lax.top_k
    calls, pins = [], []

    def top_k(probs, k):
        gates, idx = real_top_k(probs, k)
        if pins:
            idx = io_callback(lambda: pins.pop(0), jax.ShapeDtypeStruct(idx.shape, idx.dtype), ordered=True)
            gates = jnp.take_along_axis(probs, idx, -1)
        io_callback(lambda i: calls.append(np.asarray(i).copy()), None, idx, ordered=True)
        return gates, idx

    def run(kv, pin=None):
        calls.clear()
        pins[:] = list(pin or [])
        plan = ParallelPlan(kv_cache_dtype=kv)
        cache = models.init_cache(params, rcfg, plan, tokens.shape[0], tokens.shape[1] + 8)
        step = jax.jit(lambda p, c, t: models.decode_step(p, c, t, rcfg, plan))
        for t in range(tokens.shape[1]):
            logits, cache = step(params, cache, jnp.asarray(tokens[:, t : t + 1]))
        return np.asarray(logits.astype(jnp.float32)), list(calls)

    jax.lax.top_k = top_k
    try:
        bf, rbf = run("bf16")
        i8, ri8 = run("int8")
        pinned, _ = run("int8", rbf)
    finally:
        jax.lax.top_k = real_top_k
    out = readings(bf, i8, pinned, rbf, ri8)
    out.update(routing_bf16=[a.tolist() for a in rbf], routing_int8=[a.tolist() for a in ri8])
    return out


def to_reference(tree: dict) -> dict:
    """The port's tree as the reference's, each tensor freed once it has
    crossed."""
    import jax.numpy as jnp
    import ml_dtypes

    out = {}
    for k in list(tree):
        node = tree.pop(k)
        if isinstance(node, dict):
            out[k] = to_reference(node)
        elif node.dtype == torch.bfloat16:
            out[k] = jnp.asarray(node.detach().view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        else:
            out[k] = jnp.asarray(node.detach().numpy())
        del node
    return out


def configs_for(arch: str, layers: int, smoke: bool = False, dtype: str = None):
    """The port's and the reference's config: full (or smoke) width, depth
    ``layers``, and ``dtype`` where given."""
    import repro.configs as r_configs
    from repro_torch import configs

    cut = {"n_layers": layers, **({"dtype": dtype} if dtype else {})}
    get_t, get_r = (configs.get_smoke, r_configs.get_smoke) if smoke else (configs.get, r_configs.get)
    return dataclasses.replace(get_t(arch), **cut), dataclasses.replace(get_r(arch), **cut)


def draw(cfg, seed: int):
    """The port's model of ``cfg`` from ``seed`` on the CPU, and its
    tokens."""
    from repro_torch import models
    from repro_torch.parallel import ParallelPlan

    model = models.init_params(seed, cfg, ParallelPlan(), device="cpu")
    return model, np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


def read(arch: str, layers: int, seed: int, smoke: bool = False, dtype: str = None) -> dict:
    cfg, rcfg = configs_for(arch, layers, smoke, dtype)
    t0 = time.perf_counter()
    model, tokens = draw(cfg, seed)
    sha = fingerprint(model.tree())
    out = {"arch": arch, "layers": layers, "seed": seed, "smoke": smoke, "dtype": cfg.dtype, "batch": B,
           "tokens": T, "token_ids": tokens.tolist(), "weights_sha256": sha, "init_s": time.perf_counter() - t0}
    tree = model.tree()
    del model
    params = to_reference(tree)
    t0 = time.perf_counter()
    out["reference"] = reference_readings(params, rcfg, tokens)
    out["reference_s"] = time.perf_counter() - t0
    del params
    gc.collect()
    model, _ = draw(cfg, seed)
    if fingerprint(model.tree()) != sha:
        raise AssertionError("the port's second draw differs from its first")
    t0 = time.perf_counter()
    out["port"] = port_readings(model, cfg, tokens, out["reference"])
    out["port_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-moe-16b", choices=["deepseek-moe-16b", "qwen3-moe-30b-a3b"])
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", help="write the lines, routing included, to this JSON file")
    args = ap.parse_args(argv)
    lines = []
    for seed in args.seeds:
        line = read(args.arch, args.layers, seed)
        lines.append(line)
        ref = {k: v for k, v in line["reference"].items() if not k.startswith("routing")}
        print(json.dumps({**line, "token_ids": None, "reference": ref}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f)


if __name__ == "__main__":
    main()
