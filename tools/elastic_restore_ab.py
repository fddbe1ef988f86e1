"""The checkpoint phase's state (Qwen1.5-0.5B at full width, 2 layers) saved
as ``chip_smoke.py``'s ``checkpoint`` phase saves it, then restored on the card
in turns from the sync checkpoint: ``elastic.restore_resharded`` on the (1, 1)
elastic mesh and ``CheckpointManager.restore``, resharded, plain, plain,
resharded.  Before them, the seconds to read every leaf file of the sync
checkpoint once (no cache is dropped: that read finds whatever the save left
in the page cache).  Prints the seconds of each restore.

    python3 tools/elastic_restore_ab.py     # from the repository root, with one H100
"""
import collections
import json
import pathlib
import shutil
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

import torch  # noqa: E402

smi = cs.phase_environment()
cs.phase_build()
ckpt = cs.phase_checkpoint(0, collections.defaultdict(int))
try:
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.ft import CheckpointManager
    from repro_torch.ft.elastic import make_elastic_mesh, replan, restore_resharded
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import ParallelPlan
    from repro_torch.train.step import state_specs

    step_dir = ckpt["dir"] / "step_1"
    t0 = time.perf_counter()
    n_bytes = sum(len(f.read_bytes()) for f in step_dir.iterdir())
    res = {"first_read_s": time.perf_counter() - t0, "bytes": n_bytes, "plain_restore_in_phase_s": ckpt["restore_s"]}
    cfg = dataclasses.replace(configs.get(cs.TRAIN_ARCH), n_layers=cs.CKPT_LAYERS)
    mesh = make_elastic_mesh(device="cuda")
    plan = replan(cfg, ParallelPlan(batch_axes=("data",)), mesh)
    specs = state_specs(ckpt["template"], cfg, plan, AdamWConfig())
    mgr = CheckpointManager(ckpt["dir"], use_async=False)
    ways = {"resharded": lambda: restore_resharded(mgr, ckpt["template"], specs, plan),
            "plain": lambda: mgr.restore(ckpt["template"])}
    for name in ("resharded", "plain", "plain", "resharded"):
        out, secs = cs._timed(ways[name])
        res.setdefault(name, []).append(secs)
        del out
        torch.cuda.empty_cache()
    dist.destroy_process_group()
finally:
    shutil.rmtree(ckpt["tmp"], ignore_errors=True)
print(json.dumps(res))
print(smi)
