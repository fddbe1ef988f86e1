"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The JAX package's launcher (``python -m repro.launch.train``) with its
flags, plus ``--device`` (default ``cuda``; ``--device cpu`` runs on the
CPU): the train step with microbatching and remat, the optional
data-parallel mesh (``--mesh data=N``, one process per device under
``torchrun``) with plain or compressed gradient reduction, plain or
compressed AdamW moments, SZ3-compressed checkpoints every ``--ckpt-every``
steps (two kept) with resume from the newest, the deterministic data
pipeline and heartbeat monitoring.  ``--mesh data=N,model=M`` (the
reference's flag) trains sharded: tensor and expert parallelism over
``model`` on a ``DeviceMesh`` of N x M processes, the state's leaves
DTensors (``train/step.py``).  As in the reference, ``--smoke`` is
on whatever the command line says, so :func:`main` always trains the
reduced config; :func:`train` is the body for a caller that brings its own
config (a full one) or state.

Every step ends in a device sync; its host seconds go to the
``sz3_train_step_seconds`` histogram.  On the card, bf16 products
accumulate in float32 for the run (``models.common.float32_bf16_reductions``).
With a mesh, rank 0 prints and writes the checkpoints: the state's
DTensors are gathered whole leaf by leaf onto it (the feedback shards into
the reference's one vector), so the checkpoint is the one the same state
without a mesh would write; a resume decodes it on every rank and keeps
each rank's pieces.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import configs
from .. import tree as tree_util
from ..core import telemetry
from ..data import make_pipeline
from ..ft import CheckpointManager, CheckpointPolicy, HeartbeatMonitor
from ..models.common import ModelConfig, float32_bf16_reductions
from ..optim import AdamWConfig
from ..parallel import ParallelPlan
from ..parallel import specs as sp
from ..train.step import init_train_state, make_train_step, state_specs

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_launch_train")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (full configs need a pod)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress-moments", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="mesh shape as data=N[,model=M]; needs N*M processes, one per device "
                         "(torchrun --nproc-per-node N*M)")
    ap.add_argument("--compress-grads", default="", metavar="POLICY",
                    help="error-bounded DP gradient reduction: a jitmode "
                         "policy spec ('int8', 'int4:bs=256', "
                         "'int8:eb=1e-6:pred=zero+lorenzo1+mean') or plain "
                         "8/4; needs --mesh")
    ap.add_argument("--compress-opt", default="", metavar="POLICY",
                    help="compressed optimizer moments with this jitmode "
                         "policy spec (implies --compress-moments)")
    ap.add_argument("--device", default="cuda", help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    mesh = None
    if args.mesh:
        from .mesh import make_debug_mesh

        pairs = [kv.split("=") for kv in args.mesh.split(",")]
        mesh = make_debug_mesh(tuple(int(v) for _, v in pairs), tuple(k for k, _ in pairs), device=args.device)
    grad_policy = args.compress_grads
    if grad_policy in ("8", "4"):  # bare bit width -> default policy
        grad_policy = f"int{grad_policy}"
    plan = ParallelPlan(mesh=mesh, microbatches=args.microbatches, grad_policy=grad_policy)
    opt = AdamWConfig(
        lr=args.lr,
        compress_moments=args.compress_moments or bool(args.compress_opt),
        moment_policy=args.compress_opt,
    )
    train(cfg, plan, opt, steps=args.steps, seq=args.seq, batch=args.batch, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, device=args.device)


@dataclasses.dataclass
class TrainResult:
    """What one :func:`train` run leaves: the final state, the step it
    started from (after a resume), and per step run the loss, grad norm and
    host seconds (each step ends in a device sync), the tokens a step
    consumes (all ranks), and the checkpoints on disk."""

    state: Dict[str, Any]
    start: int
    losses: List[float]
    grad_norms: List[float]
    step_seconds: List[float]
    tokens_per_step: int
    checkpoints: List[int]


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _say(*a) -> None:
    if _is_rank0():
        print(*a, flush=True)


def _world() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _saved_view(state):
    """The state as the reference lays it out on disk, whole: on a mesh
    each DTensor leaf is gathered in turn (a collective every rank joins;
    the feedback shards into one vector), and only rank 0, which writes
    the checkpoint, keeps the gathered leaves (None elsewhere)."""
    keep = _is_rank0()
    flat, treedef = tree_util.flatten_with_path(state)
    out = []
    for _, t in flat:
        if sp.is_dtensor(t):
            whole = t.full_tensor()  # every rank joins the gather
            t = whole if keep else None
        out.append(t)
    return tree_util.unflatten(treedef, out)


def _newest_step(mgr: CheckpointManager, plan: ParallelPlan) -> Optional[int]:
    """The newest checkpoint's step, as rank 0 sees it (every rank resumes
    from the same one), or None."""
    steps = mgr.list_steps()
    newest = [steps[-1] if steps else None]
    if plan.mesh is not None and _world():
        dist.broadcast_object_list(newest, src=0)
    return newest[0]


def _resume(mgr: CheckpointManager, step: int, state, plan: ParallelPlan, specs):
    """Checkpoint ``step`` written into ``state``'s tensors in place (on a
    mesh each rank's pieces, cut by ``specs``); returns its ``next_step``."""
    flat, treedef = tree_util.flatten_with_path(state)
    shapes = tree_util.unflatten(treedef, [torch.empty(t.shape, dtype=t.dtype, device="meta") for _, t in flat])
    host, extra = mgr.restore(shapes, step)
    whole = dict(tree_util.flatten_with_path(host)[0])
    with torch.no_grad():
        for path, dst, spec in sp.spec_leaves(state, specs):
            sp.local(dst).copy_(sp.shard_local(whole[path], spec, plan))
    return int(extra.get("next_step", 0))


def train(
    cfg: ModelConfig,
    plan: ParallelPlan,
    opt: AdamWConfig = AdamWConfig(),
    *,
    steps: int = 30,
    seq: int = 64,
    batch: int = 4,
    ckpt_dir: str = DEFAULT_CKPT_DIR,
    ckpt_every: int = 10,
    ckpt_policy: CheckpointPolicy = CheckpointPolicy(),
    device=None,
    seed: int = 0,
    state: Optional[Dict[str, Any]] = None,
) -> TrainResult:
    """Train ``steps`` steps (resuming from the newest checkpoint under
    ``ckpt_dir``) of a global ``batch`` of ``seq`` tokens; each rank of a
    mesh takes its rows.  The state is drawn from ``seed`` on ``device``
    (default ``"cuda"``) unless ``state`` brings one, which is then trained
    in place."""
    from ..core.pipeline import resolve_device

    dev = resolve_device(device)
    if batch % plan.dp:
        raise ValueError(f"a global batch of {batch} does not split over {plan.dp} ranks")
    rows = batch // plan.dp
    lo = plan.dp_rank * rows
    _say(f"arch={cfg.name} family={cfg.family} ~{cfg.n_flop_params()/1e6:.0f}M params")

    pipe = make_pipeline(cfg, seq=seq, global_batch=batch)
    mgr = CheckpointManager(ckpt_dir, policy=ckpt_policy, keep=2, device=dev)
    mon = HeartbeatMonitor(["host0"], timeout_s=600)

    if state is None:
        state = init_train_state(seed, cfg, plan, opt, device=dev)
    start = 0
    newest = _newest_step(mgr, plan)
    if newest is not None:
        start = _resume(mgr, newest, state, plan, state_specs(state, cfg, plan, opt))
        _say(f"resumed at step {start}")

    step_fn = make_train_step(cfg, plan, opt, total_steps=steps)
    losses, norms, seconds = [], [], []
    with float32_bf16_reductions():
        t0 = time.perf_counter()
        for k in range(start, steps):
            batch_k = {k2: torch.from_numpy(np.ascontiguousarray(v[lo : lo + rows])).to(dev)
                       for k2, v in pipe.batch_at(k).items()}
            state, m = step_fn(state, batch_k)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # waits for the step
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            telemetry.metric_observe("sz3_train_step_seconds", dt)
            losses.append(loss)
            norms.append(gnorm)
            seconds.append(dt)
            mon.beat("host0", dt)
            if k % 5 == 0 or k == steps - 1:
                _say(f"step {k:4d} loss={loss:.4f} ({batch * seq / dt:,.0f} tok/s)")
            if (k + 1) % ckpt_every == 0:
                view = _saved_view(state)
                if _is_rank0():
                    mgr.save(k + 1, view, extra={"next_step": k + 1})
    mgr.wait()
    if plan.mesh is not None and _world():  # rank 0's checkpoints are on disk for every rank
        dist.barrier()
    _say("done; checkpoints:", mgr.list_steps())
    return TrainResult(state, start, losses, norms, seconds, batch * seq, mgr.list_steps())


if __name__ == "__main__":
    main()
