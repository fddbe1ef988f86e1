"""Multi-pod dry run of the port (``repro/launch/dryrun.py``): count every
(architecture x input-shape) cell on the production meshes, with no card,
and record memory, cost and roofline terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--isolate]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

The reference lowers and compiles each cell for 512 fake XLA devices.  The
port has nothing to compile: it opens a fake process group of 256 or 512
ranks (``torch.testing``'s ``FakeStore``, backend ``"fake"``: collectives
return at once), takes ``make_production_mesh(device="cpu")`` over it and
the cell's plan from ``launch/plans.py``, builds the state (or the
parameters and the cache) on the meta device, and runs one train step,
prefill or serve step of rank 0 under ``launch/cost.py``'s counter and a
live-storage tracker (``torch.distributed._tools.mem_tracker.MemTracker``)
that knows the arguments' storages: the peak is the arguments' bytes plus
the most the step held beside them, as XLA's memory analysis gives it.
The step sees its own rows of the global batch, as every rank does.  The
hand kernels have no meta form, so their plain versions run and are
counted; a cell's ``plain_kernels`` names them.

Results land in ``results/dryrun_torch/<mesh>/<arch>__<shape>[__tag].json``;
a cell that fails writes ``<name>.error.json`` with its traceback.  A
process holds one default process group, so a run that has a real one
(``torch.distributed`` on the card) calls this module in a subprocess
(``--isolate`` runs every cell in its own).

The roofline prices the NVIDIA H100 SXM from its data sheet: 989 TFLOP/s
dense bf16 and 3.35 TB/s of HBM a GPU.  The collective term uses 50 GB/s a
GPU, one 400 Gb/s network port each: every axis of the 16 x 16 mesh spans
more than one 8-GPU NVLink node, so the ring runs at the network's rate.
That is not the reference's 50 GB/s ICI link of a TPU v5e, whose other two
figures (197 TFLOP/s, 819 GB/s) are not used here.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List

import torch

from .. import configs
from .. import models
from ..configs.shapes import SHAPES, cell_skip_reason, input_specs
from ..parallel import specs as sp
from . import cost as cost_mod

PEAK_FLOPS = 989e12  # bf16 dense FLOP/s a GPU (H100 SXM)
HBM_BW = 3.35e12  # B/s a GPU (H100 SXM)
LINK_BW = 50e9  # B/s a GPU: one 400 Gb/s port


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0,
    for the life of the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is open in this process: run the dry run in a subprocess")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest of dicts, sequences and dataclasses."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x) for t in _leaves(getattr(x, f.name))]
    return []


def _local_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in (sp.local(t) for t in _leaves(x)))


@contextlib.contextmanager
def _plain_kernel_calls(names: set):
    """Record which hand kernels' plain versions run in the block (the
    kvquant wrappers are the only ones on a model's path)."""
    from ..kernels.kvquant import ref

    saved = {k: getattr(ref, k) for k in ("quantize", "quantize_append", "dequant_matmul")}
    kernels = {"quantize": ("absmax", "quantize_with_scale"), "quantize_append": ("quantize_append",),
               "dequant_matmul": ("dequant_matmul",)}

    def wrap(k):
        def call(*a, **kw):
            names.update(kernels[k])
            return saved[k](*a, **kw)
        return call

    for k in saved:
        setattr(ref, k, wrap(k))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ref, k, fn)


def lower_cell(arch: str, shape: str, mesh, multi_pod: bool, overrides=None, batch=None):
    """The cell's step and its arguments on the meta device: ``(fn, args,
    argument_bytes, cfg, cell, plan)``; ``batch`` overrides the cell's
    global batch."""
    from ..launch.plans import make_cell_plan
    from ..serve.step import _walk, cache_specs, jit_serve_step, make_serve_step
    from ..train.step import init_train_state, jit_train_step, local_rows, make_train_step

    cfg = configs.get(arch)
    cell = SHAPES[shape] if batch is None else dataclasses.replace(SHAPES[shape], batch=int(batch))
    plan, opt_cfg = make_cell_plan(arch, cfg, cell, mesh, multi_pod, overrides)
    specs = input_specs(cfg, cell)

    if cell.kind == "train":
        state = init_train_state(0, cfg, plan, opt_cfg, device="meta")
        step = jit_train_step(make_train_step(cfg, plan, opt_cfg), state, cfg, plan, opt_cfg, specs)
        return step, (state, specs), _local_bytes(state) + _local_bytes(local_rows(specs, plan)), cfg, cell, plan

    params = models.init_params(0, cfg, plan, device="meta").tree()
    pspecs = sp.param_specs(params, cfg, plan)
    placed = sp.map_paths(lambda path, t: sp.place(t, sp.spec_at(pspecs, "/".join(path)), plan), params)
    if cell.kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return models.prefill_logits(params, local_rows(batch, plan), cfg, plan)

        return prefill, (placed, specs), _local_bytes(placed) + _local_bytes(local_rows(specs, plan)), cfg, cell, plan

    frames = None
    if cfg.family == "encdec":
        frames = torch.empty((cell.batch, cfg.enc_seq, cfg.d_model), dtype=cfg.param_dtype, device="meta")
    cache = models.init_cache(params, cfg, plan, cell.batch, cell.seq, enc_frames=frames)
    cache = _walk(lambda _, s, t: sp.place(t, s, plan), cache_specs(cache, cfg, plan), cache)
    step = jit_serve_step(make_serve_step(cfg, plan), placed, cache, cfg, plan)
    tokens = specs["tokens"]
    rows = tokens if plan.weight_stationary else local_rows({"t": tokens}, plan)  # the whole batch on every rank
    args_bytes = _local_bytes(placed) + _local_bytes(cache) + _local_bytes(rows)
    return step, (placed, cache, tokens), args_bytes, cfg, cell, plan


def arguments_tracker(args):
    """A live-storage tracker that knows the storages of ``args`` (the
    local tensors of a nest of them): a view of an argument taken in the
    tracked block is not counted as a new storage (it is the tracker's
    "Other", which :func:`temp_bytes` leaves out)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    tracker.track_external(*(sp.local(t) for t in _leaves(args)))
    return tracker


def temp_bytes(tracker) -> int:
    """The most bytes the tracked block held beside its arguments."""
    from torch.distributed._tools.mem_tracker import _MemRefType

    return sum(d.get("Total", 0) - d.get(_MemRefType.OTH, 0) for d in tracker.get_tracker_snapshot("peak").values())


def analyze_cell(arch, shape, mesh, multi_pod, overrides=None, batch=None) -> Dict[str, Any]:
    """Count one cell's step on ``mesh`` (a ``DeviceMesh`` over a fake
    group) and price it on the H100."""

    t0 = time.time()
    fn, args, arg_bytes, cfg, cell, plan = lower_cell(arch, shape, mesh, multi_pod, overrides, batch)
    t_lower = time.time() - t0
    plain: set = set()
    tracker = arguments_tracker(args)
    t0 = time.time()
    with _plain_kernel_calls(plain), tracker:
        _, cost = cost_mod.count(fn, *args)
    t_count = time.time() - t0
    temp_peak = temp_bytes(tracker)

    chips = mesh.size()
    compute_s = cost.flops / PEAK_FLOPS
    dot_compute_s = cost.dot_flops / PEAK_FLOPS
    memory_s = cost.hbm_bytes / HBM_BW
    collective_s = cost.collective_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)

    # MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), D = global tokens
    n_params = cfg.n_flop_params()
    tokens = cell.batch * (cell.seq if cell.kind != "decode" else 1)
    model_flops = (6 if cell.kind == "train" else 2) * n_params * tokens
    dot_global = cost.dot_flops * chips
    return {
        "arch": arch,
        "shape": shape,
        "mesh": "multi" if multi_pod else "single",
        "mesh_shape": list(mesh.shape),
        "chips": chips,
        "kind": cell.kind,
        "batch": cell.batch,
        "seq": cell.seq,
        "overrides": overrides or {},
        "plan": {
            "batch_axes": list(plan.batch_axes),
            "fsdp_axes": list(plan.fsdp_axes),
            "seq_axes": list(plan.seq_axes),
            "microbatches": plan.microbatches,
            "kv_cache_dtype": plan.kv_cache_dtype,
            "remat": plan.remat,
            "decode_feature_shard": plan.decode_feature_shard,
        },
        "timing": {"lower_s": t_lower, "count_s": t_count},
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "temp_size_in_bytes": temp_peak,
            "peak_memory_in_bytes": arg_bytes + temp_peak,
        },
        "counted": {
            "flops_per_chip": cost.flops,
            "dot_flops_per_chip": cost.dot_flops,
            "hbm_bytes_per_chip": cost.hbm_bytes,
            "collective_bytes_per_chip": cost.collective_bytes,
            "per_collective": dict(cost.per_collective),
            "collectives": dict(cost.collectives),
            "dtensor_ops_skipped": cost.dtensor_ops,
        },
        "plain_kernels": sorted(plain),
        "roofline": {
            "device": "NVIDIA H100 SXM (data sheet)",
            "peak_flops": PEAK_FLOPS,
            "hbm_bw": HBM_BW,
            "link_bw": LINK_BW,
            "compute_s": compute_s,
            "dot_compute_s": dot_compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "bottleneck": bottleneck,
            "model_flops": model_flops,
            "counted_dot_flops_global": dot_global,
            "useful_flops_ratio": model_flops / max(1.0, dot_global),
        },
    }


def cell_list():
    out = []
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        for shape, cell in SHAPES.items():
            out.append((arch, shape, cell_skip_reason(cfg, cell)))
    return out


def _cell_path(out: str, mesh_kind: str, arch: str, shape: str, tag) -> Path:
    return Path(out) / mesh_kind / f"{arch}__{shape}{f'__{tag}' if tag else ''}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--variant", default=None, help="json overrides for the plan")
    ap.add_argument("--tag", default=None, help="suffix for variant result files")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--isolate", action="store_true",
                    help="run each cell in a subprocess (a crash cannot kill the sweep)")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.isolate and (args.all or (args.arch and args.shape)):
        import subprocess
        import sys

        for mesh_kind in meshes:
            for arch, shape, _ in cell_list() if args.all else [(args.arch, args.shape, None)]:
                path = _cell_path(args.out, mesh_kind, arch, shape, args.tag)
                if path.exists() and not args.force:
                    print(f"[skip-existing] {path}", flush=True)
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                       "--mesh", mesh_kind, "--out", args.out]
                for flag, value in (("--variant", args.variant), ("--tag", args.tag)):
                    if value:
                        cmd += [flag, value]
                if args.force:
                    cmd += ["--force"]
                r = subprocess.run(cmd, timeout=3600)
                if r.returncode != 0:
                    err = path.with_suffix(".error.json")
                    if not err.exists():
                        path.parent.mkdir(parents=True, exist_ok=True)
                        err.write_text(json.dumps({"arch": arch, "shape": shape, "mesh": mesh_kind,
                                                   "error": f"subprocess exited {r.returncode} (fatal crash)"},
                                                  indent=2))
                    print(f"  FATAL (rc={r.returncode}) {arch} {shape}", flush=True)
        return

    if args.list:
        for arch, shape, skip in cell_list():
            print(f"{arch:20s} {shape:12s} {'SKIP: ' + skip if skip else 'run'}")
        return

    if not (args.all or (args.arch and args.shape)):
        ap.error("give --arch and --shape, --all or --list")
    overrides = json.loads(args.variant) if args.variant else None
    cells = cell_list() if args.all else [
        (args.arch, args.shape, cell_skip_reason(configs.get(args.arch), SHAPES[args.shape]))]

    from .mesh import make_production_mesh

    for mesh_kind in meshes:
        multi = mesh_kind == "multi"
        out_dir = Path(args.out) / mesh_kind
        out_dir.mkdir(parents=True, exist_ok=True)
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            for arch, shape, skip in cells:
                path = _cell_path(args.out, mesh_kind, arch, shape, args.tag)
                if path.exists() and not args.force:
                    print(f"[skip-existing] {path}")
                    continue
                if skip:
                    path.write_text(json.dumps({"arch": arch, "shape": shape, "mesh": mesh_kind, "skipped": skip},
                                               indent=2))
                    print(f"[SKIP] {arch} {shape}: {skip}")
                    continue
                print(f"[dryrun] {arch} {shape} mesh={mesh_kind} ...", flush=True)
                try:
                    res = analyze_cell(arch, shape, mesh, multi, overrides)
                    path.write_text(json.dumps(res, indent=2))
                    r = res["roofline"]
                    print(f"  ok: count={res['timing']['count_s']:.1f}s compute={r['compute_s']:.4f}s "
                          f"memory={r['memory_s']:.4f}s collective={r['collective_s']:.4f}s -> {r['bottleneck']}",
                          flush=True)
                except Exception as e:  # a sweep records the failure and goes on to the next cell
                    err = {"arch": arch, "shape": shape, "mesh": mesh_kind, "error": str(e),
                           "traceback": traceback.format_exc()}
                    path.with_suffix(".error.json").write_text(json.dumps(err, indent=2))
                    print(f"  FAILED: {e}", flush=True)


if __name__ == "__main__":
    main()
