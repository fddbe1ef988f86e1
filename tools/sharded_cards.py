"""The sharded train step and decode across cards against one card's.

    torchrun --nproc-per-node 4 tools/sharded_cards.py [--device cuda] [--out PATH] [--full-steps 3]
        [--no-smoke] [--profile] [--decode] [--no-train]

Four ranks (one per card, NCCL; gloo with ``--device cpu``) on a (2, 2)
``data x model`` mesh.  Every rank also runs the one-process step on its
own device from the same seed, so each comparison is on one machine:

  * the smoke configs in float32, 3 steps each through ``jit_train_step``
    with FSDP over ``data`` and tensor parallelism over ``model``: qwen1.5
    (vocab-parallel loss, tied embedding), granite (GQA), nemotron with
    sequence parallelism, zamba2 (Mamba2 heads over ``model``) and
    whisper; deepseek-moe's expert parallelism with the batch replicated
    (the one-process capacity); and qwen1.5 with the compressed gradient
    reduction over ``data`` (the model axis duplicating work), whose first
    loss is the uncompressed one's;
  * Qwen1.5-0.5B at full size (bf16, seq 4096, global batch 8, 2
    microbatches, remat ``full``; ``make_cell_plan``'s train_4k plan on
    this mesh): ``--full-steps`` steps sharded against the same steps on
    one card, with the step times (host clock, each step ending in a
    sync) and peak memory of both; with ``--profile`` one more sharded
    step under ``torch.profiler``: device time by kernel kind (NCCL, GEMM,
    the rest) and the ten costliest kernels.

With ``--decode``, granite-3-8b at full size (bf16 weights, batch 4, 16
tokens, bf16 and int8 KV) decodes on a (4, 1) and a (2, 2) ``data x
model`` mesh, FSDP over ``data``, three ways: on one card (every rank
alone, greedy from the launcher's prompt tokens), then, on the one card's
tokens, the weight-stationary decode (``decode_feature_shard``) and the
gathering decode through ``jit_serve_step``.  Each reports its last and
worst logits against one card's, the greedy picks that agree, the step
seconds (host clock, each step ending in a sync), and the step's memory
beside the rank's shards and cache; with ``--profile`` one more step of
each sharded decode is profiled (NCCL device time).  ``--no-train`` skips
the train cases.

Rank 0 prints one JSON line per comparison and the whole result in
``--out``, the cards' names and power limits first.  Bounds on the smoke
comparisons (``SMOKE_*``) fail the run; the full-size numbers are reported.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: the sharded smoke step against one process's, float32, 3 steps: on gloo
#: ranks every arch reads within 5e-7 (tests/test_torch_sharded.py); a card
#: may pick other GEMM algorithms for the ranks' narrower products
SMOKE_LOSS_RTOL, SMOKE_PARAM_ATOL = 1e-5, 1e-5
SMOKE = (("qwen1.5-0.5b", {}), ("granite-3-8b", {}), ("nemotron-4-340b", {"seq_axes": ("model",)}),
         ("zamba2-7b", {}), ("whisper-small", {}), ("deepseek-moe-16b", {"batch_axes": ()}))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _profile(call, dev):
    """One more step under ``torch.profiler``: its wall seconds and the
    device time of its kernels by kind (NCCL collectives, GEMMs, the
    rest), and the ten kernels that took most.  Only the kernels' own rows
    count: an operator's row carries its kernels' time again.  An NCCL
    kernel's time includes its wait for the other ranks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        _sync(dev)
        wall = time.perf_counter() - t0
    kinds = {"nccl": 0.0, "gemm": 0.0, "other": 0.0}
    rows = []
    for e in prof.key_averages():
        us = float(e.self_device_time_total or 0.0)
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        name = e.key.lower()
        kind = ("nccl" if "nccl" in name else
                "gemm" if any(k in name for k in ("gemm", "cutlass", "sm90", "xmma", "cublas", "nvjet")) else "other")
        kinds[kind] += us / 1e6
        rows.append((us / 1e6, e.count, e.key[:120]))
    rows.sort(reverse=True)
    return {"wall_s": wall, "device_s_by_kind": kinds, "device_s_total": sum(kinds.values()),
            "top_kernels": [{"s": t, "calls": n, "name": k} for t, n, k in rows[:10]]}


def _run(cfg, plan, opt, steps, dev, seq, rows, profile: bool = False):
    """``steps`` steps from seed 0 on the pipeline's batches: losses, grad
    norms, step seconds, peak GB and the final parameters (whole); with
    ``profile`` one more step profiled (:func:`_profile`)."""
    from repro_torch import tree as tree_util
    from repro_torch.data import make_pipeline
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.train.step import init_train_state, jit_train_step, make_train_step

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    pipe = make_pipeline(cfg, seq=seq, global_batch=rows)
    batch = lambda k: {x: torch.from_numpy(v).to(dev) for x, v in pipe.batch_at(k).items()}  # noqa: E731
    state = init_train_state(0, cfg, plan, opt, device=dev)
    step = jit_train_step(make_train_step(cfg, plan, opt, total_steps=steps), state, cfg, plan, opt, batch(0))
    out = {"losses": [], "grad_norms": [], "seconds": []}
    with float32_bf16_reductions():
        for k in range(steps):
            b = batch(k)
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            out["seconds"].append(time.perf_counter() - t0)
    out["peak_GB"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    if profile:
        with float32_bf16_reductions():
            b = batch(steps)
            out["profile"] = _profile(lambda: step(state, b), dev)
    params = [_whole(t) for t in tree_util.flatten(state["params"])[0]]
    return out, params


def _compare(one, sh, p1, ps):
    return {
        "loss_max_rel": max(abs(a - b) / abs(a) for a, b in zip(one["losses"], sh["losses"])),
        "grad_norm_max_rel": max(abs(a - b) / abs(a) for a, b in zip(one["grad_norms"], sh["grad_norms"])),
        "param_max_abs": max(float((a.float() - b.float()).abs().max()) for a, b in zip(p1, ps)),
    }


DECODE_ARCH, DECODE_BATCH, DECODE_TOKENS = "granite-3-8b", 4, 16


def _owned_shards(params, cfg, plan):
    """The parameters as DTensors in ``param_specs`` placements, each
    rank's piece in storage of its own, so the whole tensors can be
    freed."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.lm import param_tree
    from repro_torch.parallel import specs as sp

    pspecs = sp.param_specs(params, cfg, plan)

    def one(path, t):
        spec = sp.spec_at(pspecs, "/".join(path))
        return DTensor.from_local(sp.shard_local(t, spec, plan).clone(), plan.mesh, plan.placements(spec),
                                  run_check=False, shape=t.shape, stride=t.stride())

    return sp.map_paths(one, param_tree(params))


def _decode_one_card(cfg, params, kv, dev):
    """Greedy decode on this card alone: the tokens fed (B, T + 1), each
    step's logits and seconds."""
    from repro_torch import models
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import ParallelPlan
    from repro_torch.serve.step import make_serve_step

    plan = ParallelPlan(kv_cache_dtype=kv)
    with float32_bf16_reductions():
        cache = models.init_cache(params, cfg, plan, DECODE_BATCH, DECODE_TOKENS + 8)
        step = make_serve_step(cfg, plan)
        gen = torch.Generator(device=dev).manual_seed(2)
        tok = torch.randint(0, cfg.vocab, (DECODE_BATCH, 1), generator=gen, device=dev, dtype=torch.int32)
        toks, logits, secs = [tok], [], []
        for _ in range(DECODE_TOKENS):
            _sync(dev)
            t0 = time.perf_counter()
            lg, cache = step(params, cache, tok)
            tok = torch.argmax(lg, -1, keepdim=True).to(torch.int32)
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            toks.append(tok)
            logits.append(lg)
    return torch.cat(toks, dim=1), logits, secs


def _decode_sharded(cfg, shards, plan, toks, ref_logits, dev, profile: bool):
    """The one card's tokens through ``jit_serve_step`` under ``plan``:
    logits against the one card's, step seconds and memory, and with
    ``profile`` one more step under the profiler (the last token again)."""
    from repro_torch import models
    from repro_torch import tree as tree_util
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import specs as sp
    from repro_torch.serve.step import jit_serve_step, make_serve_step

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    with float32_bf16_reductions():
        cache = models.init_cache(shards, cfg, plan, DECODE_BATCH, DECODE_TOKENS + 8)
        step = jit_serve_step(make_serve_step(cfg, plan), shards, cache, cfg, plan)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        worst, last, agree, secs = 0.0, 0.0, 0, []
        for t in range(DECODE_TOKENS):
            _sync(dev)
            t0 = time.perf_counter()
            lg, cache = step(shards, cache, toks[:, t:t + 1])
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            err = float((lg - ref_logits[t]).abs().max())
            worst, last = max(worst, err), err
            agree += int((lg.argmax(-1) == ref_logits[t].argmax(-1)).sum())
        scale = max(float(r.abs().max()) for r in ref_logits)
        out = {"logits_max_abs": worst, "logits_last_abs": last, "logits_max_rel_to_scale": worst / scale,
               "greedy_agree": agree / (DECODE_TOKENS * DECODE_BATCH), "step_seconds": secs,
               "step_p50_s": statistics.median(secs), "step_p99_s": _p99(secs)}
        if dev.type == "cuda":
            local_gb = sum(sp.local(t).numel() * sp.local(t).element_size()
                           for t in tree_util.flatten(shards)[0]) / 1e9
            out.update({"peak_GB": torch.cuda.max_memory_allocated() / 1e9, "before_steps_GB": start / 1e9,
                        "step_extra_GB": (torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()) / 1e9,
                        "param_shards_GB": local_gb})
        if profile:
            tok = toks[:, DECODE_TOKENS - 1:DECODE_TOKENS]
            out["profile"] = _profile(lambda: step(shards, cache, tok), dev)
    return out


def _p99(secs):
    import numpy as np

    return float(np.percentile(secs, 99))


def _decode(mesh_shape, args, dev, say) -> None:
    """granite-3-8b's three decodes on ``mesh_shape`` (see the module
    docstring)."""
    from repro_torch import configs, models
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import ParallelPlan

    mesh = make_debug_mesh(mesh_shape, ("data", "model"), device=args.device)
    cfg = configs.get(DECODE_ARCH) if args.decode_full else configs.get_smoke(DECODE_ARCH)
    base = dict(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
    for axis in ("data", "model"):  # each axis's communicator set up before any timed step
        dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(axis))
    params = models.init_params(0, cfg, ParallelPlan(**base), device=dev)
    ones = {kv: _decode_one_card(cfg, params, kv, dev) for kv in ("bf16", "int8")}
    shards = _owned_shards(params, cfg, ParallelPlan(**base))
    del params
    tag = "x".join(map(str, mesh_shape))
    for kv, (toks, ref_logits, secs) in ones.items():
        rec = {"one_card": {"step_seconds": secs, "step_p50_s": statistics.median(secs), "step_p99_s": _p99(secs)}}
        for name, flag in (("stationary", True), ("gathering", False)):
            plan = ParallelPlan(**base, kv_cache_dtype=kv, decode_feature_shard=flag)
            rec[name] = _decode_sharded(cfg, shards, plan, toks, ref_logits, dev, args.profile and kv == "bf16")
        say(f"decode {DECODE_ARCH} {tag} {kv}", rec)
    del shards


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sharded_cards.json"))
    ap.add_argument("--full-steps", type=int, default=3)
    ap.add_argument("--full-seq", type=int, default=4096)
    ap.add_argument("--no-smoke", action="store_true", help="skip the smoke configs")
    ap.add_argument("--profile", action="store_true", help="profile one more full-size sharded step")
    ap.add_argument("--decode", action="store_true", help="granite-3-8b's decode on (4, 1) and (2, 2)")
    ap.add_argument("--decode-smoke", dest="decode_full", action="store_false",
                    help="the decode at the smoke config (a rehearsal)")
    ap.add_argument("--no-train", action="store_true", help="skip the train cases")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.plans import make_cell_plan
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import ParallelPlan

    mesh = make_debug_mesh((2, 2), ("data", "model"), device=args.device)
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else torch.device("cpu")
    result = {"world": dist.get_world_size(), "backend": dist.get_backend()}
    if dev.type == "cuda":
        result["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        result["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()

    def say(name, rec):
        result[name] = rec
        if rank == 0:
            print(json.dumps({"case": name, **rec}), flush=True)

    base = dict(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
    opt = AdamWConfig(lr=1e-3)
    if args.no_train:
        args.no_smoke, args.full_steps = True, 0
    for arch, extra in () if args.no_smoke else SMOKE:
        cfg = configs.get_smoke(arch)
        one, p1 = _run(cfg, ParallelPlan(), opt, 3, dev, 16, 4)
        sh, ps = _run(cfg, ParallelPlan(**{**base, **extra}), opt, 3, dev, 16, 4)
        rec = _compare(one, sh, p1, ps)
        say(f"smoke {arch}", rec)
        if not (rec["loss_max_rel"] <= SMOKE_LOSS_RTOL and rec["param_max_abs"] <= SMOKE_PARAM_ATOL):
            raise AssertionError(f"{arch}: the sharded step differs from one process's: {rec}")
    if not args.no_smoke:
        cfg = configs.get_smoke("qwen1.5-0.5b")
        plain, _ = _run(cfg, ParallelPlan(mesh=mesh, batch_axes=("data",)), opt, 3, dev, 16, 4)
        comp, _ = _run(cfg, ParallelPlan(mesh=mesh, batch_axes=("data",), grad_policy="int8"), opt, 3, dev, 16, 4)
        say("smoke qwen1.5-0.5b compressed grads", {"losses": comp["losses"], "uncompressed": plain["losses"]})
        if not abs(comp["losses"][0] - plain["losses"][0]) <= SMOKE_LOSS_RTOL * plain["losses"][0]:
            raise AssertionError("the compressed run's first loss differs from the uncompressed one's")

    if args.full_steps:
        cfg = configs.get("qwen1.5-0.5b")
        plan, popt = make_cell_plan("qwen1.5-0.5b", cfg, configs.SHAPES["train_4k"], mesh)
        fopt = popt._replace(lr=3e-3)
        one, p1 = _run(cfg, ParallelPlan(microbatches=plan.microbatches, remat=plan.remat), fopt, args.full_steps, dev,
                       args.full_seq, 8)
        sh, ps = _run(cfg, plan, fopt, args.full_steps, dev, args.full_seq, 8, profile=args.profile)
        rec = {**_compare(one, sh, p1, ps), "one_card": one, "sharded": sh,
               "step_p50_s": {"one_card": statistics.median(one["seconds"]),
                              "sharded": statistics.median(sh["seconds"])}}
        del p1, ps
        say("full qwen1.5-0.5b", rec)
    if args.decode:
        for shape in ((4, 1), (2, 2)):
            _decode(shape, args, dev, say)
    if rank == 0:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result, indent=1))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
