"""Host seconds of the weight-stationary and the gathering decode step of
granite-3-8b across four cards, and of one NCCL all-reduce called from a
shallow and a deep Python stack.

    torchrun --nproc-per-node 4 tools/stationary_host_probe.py TAG
    TORCH_NCCL_TRACE_BUFFER_SIZE=0 torchrun --nproc-per-node 4 tools/stationary_host_probe.py TAG

On a (2, 2) and a (4, 1) ``data x model`` mesh (FSDP over ``data``, batch
4, a cache of 40 positions): 300 all-reduces of a (4, 1536) float32 tensor
over the data axis, host seconds each (no sync inside the loop); then 12
decode steps each way after 3 of warm-up, each ending in a sync.  The
weights are drawn once per mesh and placed as shards.  Run it once as torch
leaves NCCL's flight recorder and once with it off
(``TORCH_NCCL_TRACE_BUFFER_SIZE=0``), in one call.  Rank 0 writes
``chiprun_out/stationary_host_<TAG>.json``.
"""
import json
import os
import pathlib
import statistics
import sys
import time

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))


def main(tag: str) -> None:
    import sharded_cards as sc

    from repro_torch import configs, models
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import ParallelPlan
    from repro_torch.serve.step import jit_serve_step, make_serve_step

    out = {"trace_buffer": os.environ.get("TORCH_NCCL_TRACE_BUFFER_SIZE", "torch's default")}
    for shape in ((2, 2), (4, 1)):
        mesh = make_debug_mesh(shape, ("data", "model"), device="cuda")
        dev = torch.device("cuda", torch.cuda.current_device())
        base = dict(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
        group = mesh.get_group("data")
        x = torch.randn(4, 1536, device=dev)

        def deep(n, fn):
            return fn() if n == 0 else deep(n - 1, fn)

        for name, fn in (("shallow", lambda: dist.all_reduce(x, group=group)),
                         ("deep30", lambda: deep(30, lambda: dist.all_reduce(x, group=group)))):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(300):
                fn()
            out[f"{shape} all_reduce {name} host_us"] = (time.perf_counter() - t0) / 300 * 1e6
        cfg = configs.get("granite-3-8b")
        params = models.init_params(0, cfg, ParallelPlan(**base), device=dev)
        shards = sc._owned_shards(params, cfg, ParallelPlan(**base))
        del params
        torch.cuda.empty_cache()
        for name, flag in (("stationary", True), ("gathering", False)):
            plan = ParallelPlan(**base, decode_feature_shard=flag)
            with float32_bf16_reductions():
                cache = models.init_cache(shards, cfg, plan, 4, 40)
                step = jit_serve_step(make_serve_step(cfg, plan), shards, cache, cfg, plan)
                tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
                for _ in range(3):
                    step(shards, cache, tok)
                secs = []
                for _ in range(12):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(shards, cache, tok)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
            out[f"{shape} {name} step p50 ms"] = statistics.median(secs) * 1e3
            del cache, step
        del shards
        torch.cuda.empty_cache()
        dist.barrier()
    if dist.get_rank() == 0:
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / f"stationary_host_{tag}.json").write_text(json.dumps(out, indent=1))
        print(json.dumps(out, indent=1))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
