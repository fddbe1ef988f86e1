"""The sharded train step across cards against the one-card step.

    torchrun --nproc-per-node 4 tools/sharded_cards.py [--device cuda] [--out PATH] [--full-steps 3]
        [--no-smoke] [--profile]

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


def _profile(step, state, b, dev):
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
        step(state, b)
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
            out["profile"] = _profile(step, state, batch(steps), dev)
    params = [_whole(t) for t in tree_util.flatten(state["params"])[0]]
    return out, params


def _compare(one, sh, p1, ps):
    return {
        "loss_max_rel": max(abs(a - b) / abs(a) for a, b in zip(one["losses"], sh["losses"])),
        "grad_norm_max_rel": max(abs(a - b) / abs(a) for a, b in zip(one["grad_norms"], sh["grad_norms"])),
        "param_max_abs": max(float((a.float() - b.float()).abs().max()) for a, b in zip(p1, ps)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sharded_cards.json"))
    ap.add_argument("--full-steps", type=int, default=3)
    ap.add_argument("--full-seq", type=int, default=4096)
    ap.add_argument("--no-smoke", action="store_true", help="skip the smoke configs")
    ap.add_argument("--profile", action="store_true", help="profile one more full-size sharded step")
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
