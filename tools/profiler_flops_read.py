"""The train phase's profiled step (Qwen1.5-0.5B at full size, seq 4096,
batch 8, 2 microbatches) read two ways on the card: ``chip_smoke._train_flops``
(the raw kineto events, a kernel linked to the call that launched it) and
``prof.events()`` (the event tree, a product counted where it has device
time): the executed dot FLOPs of each and the seconds each takes.

    python3 tools/profiler_flops_read.py    # from the repository root, with one H100
"""
import json, pathlib, sys, time
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs
import torch
smi = cs.phase_environment()
from repro_torch import configs
from repro_torch.data import make_pipeline
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import ParallelPlan
from repro_torch.train.step import init_train_state
cfg = configs.get(cs.TRAIN_ARCH)
plan, opt = ParallelPlan(microbatches=2, remat="full"), AdamWConfig(lr=cs.TRAIN_LR)
state = init_train_state(0, cfg, plan, opt, device="cuda")
batch = {k: torch.from_numpy(v).cuda() for k, v in make_pipeline(cfg, seq=cs.TRAIN_SEQ, global_batch=cs.TRAIN_BATCH).batch_at(0).items()}
res = {"raw": cs._train_flops(cfg, plan, opt, state, batch)}
# the same step read through prof.events(), timed
from torch.profiler import ProfilerActivity, profile
from repro_torch.models.common import float32_bf16_reductions
from repro_torch.train.step import make_train_step
step = make_train_step(cfg, plan, opt, total_steps=cs.TRAIN_STEPS)
t0 = time.perf_counter()
with float32_bf16_reductions():
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_flops=True) as prof:
        step(state, batch)
        torch.cuda.synchronize()
t1 = time.perf_counter()
done = sum(e.flops for e in prof.events() if e.name in cs._PROFILER_DOTS and e.flops and e.device_time_total > 0)
res["events"] = {"executed_dot_flops": done, "step_s": t1 - t0, "read_s": time.perf_counter() - t1}
print(json.dumps(res))
print(smi)
