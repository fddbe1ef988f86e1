"""Sharded training and serving in the port (``repro_torch.parallel``,
``train/step.py``'s ``state_specs`` and ``jit_train_step``,
``launch/plans.py``, ``launch/mesh.py``) against the reference's contracts.

Nothing here opens a process group in the pytest process.  Each group of
ranks is spawned once for the file, with the ``torchrun`` environment and
one thread a rank, and one worker script computes every result of its
group; the reference's side runs in subprocesses with
``--xla_force_host_platform_device_count``, as ``tests/test_distributed.py``
does.  All of them start together when the first test asks for one.

  (a) placements: ``param_specs``, ``batch_specs`` and ``state_specs``
      (plain and compressed moments) equal the reference's leaf by leaf,
      for the ten archs' smoke configs on a (2, 4) mesh with and without
      FSDP, and their full configs on the production meshes (16, 16) and
      (2, 16, 16), drawn on the meta device over a fake process group;
  (b) ``make_cell_plan`` for every arch, cell and production mesh;
  (c) eight gloo ranks on (2, 4): the reference's
      ``test_sharded_train_matches_single_device`` and
      ``test_moe_expert_parallel_parity`` through the port, the sharded
      step against the port's one-process step, and granite (``kv_repeat``
      2 at TP 4) on the reference's own TP-4 weights against its sharded
      loss;
  (d) four gloo ranks on (2, 2): sequence parallelism, ``manual_tp_psum``
      and ``bwd_cast_bf16``, compressed gradients with a model axis,
      compressed moments, a lossless checkpoint of a sharded state and its
      resume, the launcher's ``--mesh data=2,model=2`` and the sharded
      decode step;
  (e) the weight-stationary decode (``decode_feature_shard``): on the four
      ranks, every family against the port's one process and its gathering
      decode, no collective reading a parameter, and against the
      reference's own weight-stationary ``jit_serve_step`` on its weights
      (4 XLA devices); on the eight, TP 4 and a (pod, data) batch.
"""
from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as t_configs
from repro_torch.launch import train as t_train

try:  # the reference's side needs the JAX package
    import jax  # noqa: F401

    HAVE_JAX = True
except ImportError:  # pragma: no cover - a machine without JAX
    HAVE_JAX = False

needs_reference = pytest.mark.skipif(not HAVE_JAX, reason="the JAX package is not importable")

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = list(t_configs.ARCHS)
SPEC_CASES = [("smoke", "2x4", ""), ("smoke", "2x4", "data"), ("full", "16x16", "data"), ("full", "2x16x16", "data")]
CELLS = list(t_configs.SHAPES)

#: the port's sharded step against its one-process step (float32 smoke
#: configs, 2 or 3 steps, every arch at TP 2, zamba2 and granite at TP 4):
#: measured at most 1.4e-7 relative on the losses, 4.9e-7 on the grad
#: norms and 1.2e-7 absolute on the parameters (the reductions sum in
#: another order), so held at the data-parallel test's bounds
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_PARAM_ATOL = 2e-6, 2e-6, 1e-6
#: the reference's contracts (tests/test_distributed.py)
REF_LOSS_ATOL, REF_LEAF_ATOL = 5e-3, 3e-3
MOE_DEFAULT_ATOL, MOE_DROPFREE_ATOL = 0.5, 5e-3
#: the port's loss on the reference's TP-4 granite weights against the
#: reference's sharded loss (XLA's float32 against torch's; measured equal)
CARRY_LOSS_RTOL = 1e-5
#: bwd_cast_bf16 rounds cotangents to bf16, so a sum taken in another order
#: can round the other way: measured 3e-5 on the grad norm, 5e-6 on the
#: parameters after 3 steps
BF16_NORM_RTOL, BF16_PARAM_ATOL = 1e-4, 2e-5
#: compressed moments decode and re-encode whole rows: a gradient that
#: differs in its last bits can move a code, measured 8.2e-6 on the
#: parameters after 3 steps (one code step times the learning rate)
CMOM_PARAM_ATOL = 2e-4
#: the sharded decode step's logits against one process's, over 5 tokens
#: (measured at most 6.7e-6, deepseek-moe's)
DECODE_ATOL = 2e-5

#: the weight-stationary decode (``decode_feature_shard``, FSDP over data)
#: on (2, 2), "arch/kv": every arch's batch over data but the MoE's,
#: replicated unless "/data" says over data; against the port's one-process
#: decode within DECODE_ATOL (over data, the MoE's one process decodes each
#: data shard's rows on their own: capacity is per shard, as in the
#: reference)
STATIONARY_CASES = ["qwen1.5-0.5b/bf16", "qwen1.5-0.5b/int8", "granite-3-8b/bf16", "granite-3-8b/int8",
                    "deepseek-moe-16b/bf16", "deepseek-moe-16b/bf16/data", "mamba2-2.7b/bf16", "zamba2-7b/bf16",
                    "whisper-small/bf16"]
#: the same plans against the reference's own weight-stationary decode
#: (``jit_serve_step`` on 4 XLA devices) on its weights and tokens
STATIONARY_REF_CASES = ["qwen1.5-0.5b/bf16", "granite-3-8b/bf16", "granite-3-8b/int8", "deepseek-moe-16b/bf16",
                        "deepseek-moe-16b/bf16/data", "qwen3-moe-30b-a3b/bf16/data", "mamba2-2.7b/bf16",
                        "zamba2-7b/bf16", "whisper-small/bf16"]
#: on eight ranks, "mesh/arch/kv": TP 4 (granite's kv heads widened by
#: kv_repeat 2; whisper cut to 2 heads, which TP 4 leaves whole on every
#: rank) and a (pod, data) batch with FSDP over data only
STATIONARY_8_CASES = ["2x4/granite-3-8b/bf16", "2x4/whisper-small-2heads/bf16", "2x2x2/qwen1.5-0.5b/bf16",
                      "2x2x2/zamba2-7b/bf16"]
#: the port's weight-stationary logits against the reference's on the same
#: weights and tokens (measured at most 4.0e-6 for a bf16 cache, 1.3e-6 for
#: int8): the bounds the one-process decode holds against the reference
#: (an int8 code that rounds the other way moves a logit by about 1e-3)
STATIONARY_REF_ATOL = {"bf16": 1e-4, "int8": 1e-2}

_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are tiny: on one thread they run as fast as on
    many, and they do not fight the suite's parallel workers for cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    return {**env, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1", **extra}


def _spawn(script: Path, args, **env):
    return subprocess.Popen([sys.executable, str(script), *map(str, args)], env=_env(**env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _spawn_group(n: int, script: Path, args):
    port = _free_port()
    return [_spawn(script, args, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port) for r in range(n)]


def _wait(procs, what: str):
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=_TIMEOUT)
        assert p.returncode == 0, f"{what} failed:\n{out[-2000:]}\n{err[-4000:]}"
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------

_REF_SPECS = textwrap.dedent(r"""
    import functools, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    import repro.configs as configs
    from repro import models
    from repro.compression import opt_state as oc
    from repro.launch.plans import make_cell_plan
    from repro.optim import AdamWConfig
    from repro.parallel import ParallelPlan
    from repro.parallel.specs import batch_specs, param_specs
    from repro.train.step import state_specs

    def flat(tree):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]:
            out["/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)] = \
                [list(e) if isinstance(e, tuple) else e for e in tuple(leaf)]
        return out

    @functools.lru_cache(maxsize=None)
    def compressed(shape, domain):  # what adamw.init_state draws for one leaf
        return jax.eval_shape(lambda x: oc.init_compressed(x, None, domain=domain),
                              jax.ShapeDtypeStruct(shape, jnp.float32))

    devs = np.asarray(jax.devices())
    meshes = {"2x4": jax.sharding.Mesh(devs[:8].reshape(2, 4), ("data", "model")),
              "16x16": jax.sharding.Mesh(devs[:256].reshape(16, 16), ("data", "model")),
              "2x16x16": jax.sharding.Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"))}
    specs = {}
    for arch in configs.ARCHS:
        for size, mname, fsdp in %(cases)r:
            cfg = configs.get_smoke(arch) if size == "smoke" else configs.get(arch)
            mesh = meshes[mname]
            plan = ParallelPlan(mesh=mesh, batch_axes=("pod", "data") if "pod" in mesh.axis_names else ("data",),
                                fsdp_axes=(fsdp,) if fsdp else ())
            params = jax.eval_shape(lambda: models.init_params(jax.random.PRNGKey(0), cfg, plan))
            step = jax.ShapeDtypeStruct((), jnp.int32)
            res = {"params": flat(param_specs(params, cfg, plan)),
                   "batch": flat(batch_specs(configs.input_specs(cfg, configs.SHAPES["train_4k"]), plan))}
            for name, comp in (("state", False), ("state_compressed", True)):
                opt = AdamWConfig(compress_moments=comp)
                mom = {d: jax.tree.map(lambda p: compressed(p.shape, d) if comp else
                                       jax.ShapeDtypeStruct(p.shape, jnp.float32), params)
                       for d in ("linear", "log2")}
                state = {"params": params, "opt": {"m": mom["linear"], "v": mom["log2"], "step": step}}
                res[name] = flat(state_specs(state, cfg, plan, opt))
            specs[f"{arch}|{size}|{mname}|{fsdp}"] = res
    plans = {}
    for arch in configs.ARCHS:
        for mname in ("16x16", "2x16x16"):
            for cell in configs.SHAPES.values():
                plan, opt = make_cell_plan(arch, configs.get(arch), cell, meshes[mname], multi_pod=mname == "2x16x16")
                fields = {f: getattr(plan, f) for f in plan.__dataclass_fields__ if f != "mesh"}
                plans[f"{arch}|{mname}|{cell.name}"] = {
                    "plan": {k: list(v) if isinstance(v, tuple) else v for k, v in fields.items()},
                    "opt": dict(opt._asdict())}
    json.dump({"specs": specs, "plans": plans}, open(sys.argv[1], "w"))
""") % {"cases": SPEC_CASES}

_PORT_SPECS = textwrap.dedent(r"""
    import json, sys
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import configs, models
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.plans import make_cell_plan
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.parallel import ParallelPlan
    from repro_torch.parallel.specs import batch_specs, flat_specs, param_specs
    from repro_torch.train.step import state_specs

    def js(d):
        return {p: [list(e) if isinstance(e, tuple) else e for e in s] for p, s in d.items()}

    SHAPES = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
    specs, plans, refusals = {}, {}, {}
    for mname, (shape, names) in SHAPES.items():
        n = 1
        for s in shape:
            n *= s
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        for arch in configs.ARCHS:
            for size, mn, fsdp in %(cases)r:
                if mn != mname:
                    continue
                cfg = configs.get_smoke(arch) if size == "smoke" else configs.get(arch)
                plan = ParallelPlan(mesh=mesh, batch_axes=("pod", "data") if "pod" in names else ("data",),
                                    fsdp_axes=(fsdp,) if fsdp else ())
                params = models.init_params(0, cfg, plan, device="meta").tree()
                res = {"params": js(flat_specs(params, param_specs(params, cfg, plan))),
                       "batch": js(batch_specs(configs.input_specs(cfg, configs.SHAPES["train_4k"]), plan))}
                for name, comp in (("state", False), ("state_compressed", True)):
                    opt = AdamWConfig(compress_moments=comp)
                    state = {"params": params, "opt": adamw.init_state(params, opt)}
                    res[name] = js(flat_specs(state, state_specs(state, cfg, plan, opt)))
                specs[f"{arch}|{size}|{mname}|{fsdp}"] = res
        if mname != "2x4":
            for arch in configs.ARCHS:
                for cell in configs.SHAPES.values():
                    plan, opt = make_cell_plan(arch, configs.get(arch), cell, mesh)
                    fields = {f: getattr(plan, f) for f in plan.__dataclass_fields__ if f != "mesh"}
                    plans[f"{arch}|{mname}|{cell.name}"] = {
                        "plan": {k: list(v) if isinstance(v, tuple) else v for k, v in fields.items()},
                        "opt": dict(opt._asdict())}
        try:  # a production mesh over a run of another size
            make_production_mesh(multi_pod=mname != "2x4", device="cpu")
        except ValueError as e:
            refusals[mname] = str(e)
        dist.destroy_process_group()
    json.dump({"specs": specs, "plans": plans, "refusals": refusals}, open(sys.argv[1], "w"))
""") % {"cases": SPEC_CASES}

_REF_GRANITE = textwrap.dedent(r"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    import repro.configs as configs
    from repro import models
    from repro.data import make_pipeline
    from repro.parallel import ParallelPlan, compat
    mesh = compat.make_mesh((2, 4), ("data", "model"), auto_axis_types=True)
    cfg = configs.get_smoke("granite-3-8b")
    plan = ParallelPlan(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
    params = models.init_params(jax.random.PRNGKey(0), cfg, plan)
    batch = {k: jnp.asarray(v) for k, v in make_pipeline(cfg, seq=16, global_batch=4).batch_at(0).items()}
    loss = float(jax.jit(lambda p, b: models.loss_fn(p, b, cfg, plan))(params, batch))
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(sys.argv[1] + "/granite_tp4.npz", **flat)
    json.dump({"loss": loss}, open(sys.argv[1] + "/granite_tp4.json", "w"))
""")

_REF_STATIONARY = textwrap.dedent(r"""
    import os, sys, traceback
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.configs as configs
    from repro import models
    from repro.parallel import ParallelPlan, compat
    from repro.serve.step import cache_specs, jit_serve_step, make_serve_step
    out = sys.argv[1]
    try:
        mesh = compat.make_mesh((2, 2), ("data", "model"), auto_axis_types=True)
        for case in %(cases)r:
            arch, kv, *over = case.split("/")
            cfg = configs.get_smoke(arch)
            plan = ParallelPlan(mesh=mesh, batch_axes=("data",) if cfg.family != "moe" or over else (),
                                fsdp_axes=("data",), kv_cache_dtype=kv, decode_feature_shard=True)
            params = models.init_params(jax.random.PRNGKey(0), cfg, plan)
            rng = np.random.default_rng(1)
            frames = rng.standard_normal((4, cfg.enc_seq, cfg.d_model)).astype(np.float32) \
                if cfg.family == "encdec" else None
            tokens = rng.integers(0, cfg.vocab, (5, 4, 1)).astype(np.int32)
            cache = models.init_cache(params, cfg, plan, 4, 16, enc_frames=None if frames is None else jnp.asarray(frames))
            # the jitted step takes the cache in its placements (whisper's
            # cross K/V come out of init_cache placed otherwise)
            cache = jax.device_put(cache, jax.tree.map(lambda s: NamedSharding(mesh, s), cache_specs(cache, cfg, plan),
                                                       is_leaf=lambda s: isinstance(s, P)))
            step = jit_serve_step(make_serve_step(cfg, plan), params, cache, cfg, plan)
            logits = []
            for t in range(len(tokens)):
                l, cache = step(params, cache, jnp.asarray(tokens[t]))
                logits.append(np.asarray(l))
            flat = {"p/" + "/".join(str(k.key) for k in path): np.asarray(leaf)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
            extra = {} if frames is None else {"frames": frames}
            name = f"{out}/ws_{case.replace('/', '_')}"
            np.savez(name + ".part.npz", tokens=tokens, logits=np.stack(logits), **extra, **flat)
            os.replace(name + ".part.npz", name + ".npz")
    except Exception:
        open(f"{out}/ws_failed.txt", "w").write(traceback.format_exc())
        raise
""") % {"cases": STATIONARY_REF_CASES}

_COMMON = textwrap.dedent(r"""
    import dataclasses, json, os, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs, models, tree as tree_util
    from repro_torch.data import make_pipeline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.parallel import ParallelPlan
    from repro_torch.train.step import init_train_state, jit_train_step, make_train_step
    torch.set_num_threads(1)
    out = sys.argv[1]
    RES = {}

    def batch_at(cfg, k, rows=4):
        return {x: torch.from_numpy(v) for x, v in make_pipeline(cfg, seq=16, global_batch=rows).batch_at(k).items()}

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def one_process(cfg, plan, opt, steps, params=None):
        # the port's one-process step from the same draws (params: a tree
        # drawn under the sharded plan, whose kv heads may be widened)
        if params is None:
            state = init_train_state(0, cfg, plan, opt, device="cpu")
        else:
            params = tree_util.tree_map(lambda t: t.detach().clone(), params)
            state = {"params": params, "opt": adamw.init_state(params, opt)}
        step = make_train_step(cfg, plan, opt)
        mets = []
        for k in range(steps):
            state, m = step(state, batch_at(cfg, k))
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        return state, mets

    def sharded(cfg, plan, opt, steps, total=10000):
        state = init_train_state(0, cfg, plan, opt, device="cpu")
        step = jit_train_step(make_train_step(cfg, plan, opt, total_steps=total), state, cfg, plan, opt,
                              batch_at(cfg, 0))
        mets = []
        for k in range(steps):
            state, m = step(state, batch_at(cfg, k % 4))
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        return state, mets

    def compare(a, b, ma, mb):
        loss = max(abs(x[0] - y[0]) / abs(x[0]) for x, y in zip(ma, mb))
        norm = max(abs(x[1] - y[1]) / abs(x[1]) for x, y in zip(ma, mb))
        par = max(float((whole(x) - whole(y)).abs().max())
                  for x, y in zip(tree_util.flatten(a["params"])[0], tree_util.flatten(b["params"])[0]))
        return {"loss_rel": loss, "norm_rel": norm, "param_abs": par, "losses": [x[0] for x in mb]}

    def collectives_logged():
        # the input's storage of every collective of parallel.comm, in order
        from repro_torch.parallel import comm
        seen = []

        def logged(fn):
            def call(x, *a, **k):
                seen.append(x.untyped_storage().data_ptr())
                return fn(x, *a, **k)
            return call

        for name in ("all_reduce", "all_gather", "reduce_scatter"):
            setattr(comm, name, logged(getattr(comm, name)))
        return seen

    def placed(params, cfg, plan):
        # the parameters as DTensors in param_specs placements
        from repro_torch.models.lm import param_tree
        from repro_torch.parallel import specs as sp
        pspecs = sp.param_specs(params, cfg, plan)
        return sp.map_paths(lambda path, t: sp.place(t, sp.spec_at(pspecs, "/".join(path)), plan), param_tree(params))

    def stationary_decode(cfg, kv, mesh, batch_axes, cfg_one=None, steps=5, seen=None):
        # the weight-stationary decode and the gathering one on mesh, against
        # the port's one process (the MoE's batch over data: each data
        # shard's rows on their own, capacity being per shard); with seen,
        # how many collectives of each step took a parameter's storage
        from repro_torch.serve.step import jit_serve_step, make_serve_step
        kw = dict(mesh=mesh, fsdp_axes=("data",), kv_cache_dtype=kv, batch_axes=batch_axes)
        ws, gat, one = ParallelPlan(**kw, decode_feature_shard=True), ParallelPlan(**kw), ParallelPlan(kv_cache_dtype=kv)
        cfg_one = cfg_one or cfg
        params = models.init_params(0, cfg, ws, device="cpu")
        tree = placed(params, cfg, ws)
        stores = {t.to_local().untyped_storage().data_ptr() for t in tree_util.flatten(tree)[0]}
        g = torch.Generator().manual_seed(1)
        frames = torch.randn((4, cfg.enc_seq, cfg.d_model), generator=g) if cfg.family == "encdec" else None
        blocks = ws.dp if cfg.family == "moe" else 1
        rows = 4 // blocks
        c1 = [models.init_cache(params, cfg_one, one, rows, 16,
                                enc_frames=None if frames is None else frames[j * rows:(j + 1) * rows])
              for j in range(blocks)]
        cw = models.init_cache(params, cfg, ws, 4, 16, enc_frames=frames)
        cg = models.init_cache(params, cfg, gat, 4, 16, enc_frames=frames)
        s1 = make_serve_step(cfg_one, one)
        sw = jit_serve_step(make_serve_step(cfg, ws), tree, cw, cfg, ws)
        sg = jit_serve_step(make_serve_step(cfg, gat), tree, cg, cfg, gat)
        worst = worst_g = 0.0
        on_params = {"stationary": 0, "gathering": 0, "collectives": 0}
        for t in range(steps):
            tok = torch.randint(0, cfg.vocab, (4, 1), generator=g)
            l1 = []
            for j in range(blocks):
                l, c1[j] = s1(params, c1[j], tok[j * rows:(j + 1) * rows])
                l1.append(l)
            l1 = torch.cat(l1)
            if seen is not None:
                seen.clear()
            lw, cw = sw(tree, cw, tok)
            if seen is not None:
                on_params["stationary"] += sum(p in stores for p in seen)
                on_params["collectives"] += len(seen)
                seen.clear()
            lg, cg = sg(tree, cg, tok)
            if seen is not None:
                on_params["gathering"] += sum(p in stores for p in seen)
            worst = max(worst, float((l1 - lw).abs().max()))
            worst_g = max(worst_g, float((lg - lw).abs().max()))
        out = {"max_abs": worst, "against_gathering": worst_g, "shape": list(lw.shape), "vocab": cfg.vocab,
               "weight_stationary": ws.weight_stationary}
        if seen is not None:
            out["collective_inputs_on_params"] = on_params
        return out

    def finish():
        RES["rank"] = dist.get_rank()
        with open(f"{out}/result{dist.get_rank()}.json", "w") as f:
            json.dump(RES, f)
""")

_WORKER8 = _COMMON + textwrap.dedent(r"""
    mesh = make_debug_mesh((2, 4), ("data", "model"), device="cpu")
    rank = dist.get_rank()
    plain = ParallelPlan()

    # tests/test_distributed.py::test_sharded_train_matches_single_device
    cfg = configs.get_smoke("qwen1.5-0.5b")
    opt = AdamWConfig(lr=1e-3)
    plan8 = ParallelPlan(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
    s1, m1 = one_process(cfg, plain, opt, 1)
    s8, m8 = sharded(cfg, plan8, opt, 1)
    RES["contract_train"] = {"loss1": m1[0][0], "loss8": m8[0][0], "leaf": float(
        (tree_util.flatten(s1["params"])[0][0] - whole(tree_util.flatten(s8["params"])[0][0])).abs().max())}
    # and three steps, the sharded step against the one-process step
    s1, m1 = one_process(cfg, plain, opt, 3)
    s8, m8 = sharded(cfg, plan8, opt, 3)
    RES["qwen_steps"] = compare(s1, s8, m1, m8)
    RES["placements"] = sorted({str(list(t.placements)) for t in tree_util.flatten(s8["params"])[0]})

    # at TP 4: Mamba2's heads split 2 a rank (zamba2), kv_repeat 2 (granite)
    RES["archs"] = {}
    for arch in ("zamba2-7b", "granite-3-8b"):
        cfg = configs.get_smoke(arch)
        drawn = models.init_params(0, cfg, plan8, device="cpu").tree()
        s1, m1 = one_process(cfg, plain, opt, 2, params=drawn)
        s8, m8 = sharded(cfg, plan8, opt, 2)
        RES["archs"][arch] = compare(s1, s8, m1, m8)

    # a (2, 2, 2) pod x data x model mesh: make_cell_plan's multi-pod train
    # layout (batch over pod and data, FSDP over data) against one process,
    # and the compressed reduction over the two batch axes' flattened group
    cfg = configs.get_smoke("qwen1.5-0.5b")
    pods = make_debug_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    s1, m1 = one_process(cfg, plain, opt, 3)
    s3, m3 = sharded(cfg, ParallelPlan(mesh=pods, batch_axes=("pod", "data"), fsdp_axes=("data",)), opt, 3)
    RES["pods"] = compare(s1, s3, m1, m3)
    sc, mc = sharded(cfg, ParallelPlan(mesh=pods, batch_axes=("pod", "data"), grad_policy="int8"), opt, 3)
    RES["pods_compressed"] = {"losses": [x[0] for x in mc], "feedback": str(list(sc["feedback"].placements))}

    # tests/test_distributed.py::test_moe_expert_parallel_parity
    from repro_torch.models import moe
    cfg = configs.get_smoke("deepseek-moe-16b")
    ep = ParallelPlan(mesh=mesh, batch_axes=("data",))
    params = models.init_params(0, cfg, plain, device="cpu")
    batch = batch_at(cfg, 0)
    rows = {k: v[2 * ep.dp_rank: 2 * ep.dp_rank + 2] for k, v in batch.items()}

    def ep_loss():
        l = models.loss_fn(params, rows, cfg, ep).detach()
        dist.all_reduce(l, group=ep.dp_group())
        return float(l) / ep.dp

    RES["moe"] = {"default": [float(models.loss_fn(params, batch, cfg, plain)), ep_loss()]}
    moe.CAPACITY_FACTOR = 16.0
    RES["moe"]["dropfree"] = [float(models.loss_fn(params, batch, cfg, plain)), ep_loss()]

    # granite on the reference's TP-4 weights (kv_repeat 2)
    cfg = configs.get_smoke("granite-3-8b")
    plan8 = ParallelPlan(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
    npz = sys.argv[2] + "/granite_tp4.npz"
    while not os.path.exists(sys.argv[2] + "/granite_tp4.json"):
        time.sleep(0.2)
    tree = {}
    for path, a in np.load(npz).items():
        node = tree
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = a
    carried = models.params_from_numpy(tree, cfg, device="cpu")
    own = models.init_params(0, cfg, plan8, device="meta").tree()
    shapes = {p: list(t.shape) for p, t in tree_util.flatten_with_path(carried.tree())[0]}
    want = {p: list(t.shape) for p, t in tree_util.flatten_with_path(own)[0]}
    rows = {k: v[2 * plan8.dp_rank: 2 * plan8.dp_rank + 2] for k, v in batch_at(cfg, 0).items()}
    l = models.loss_fn(carried, rows, cfg, plan8).detach()
    dist.all_reduce(l, group=plan8.dp_group())
    RES["granite"] = {"shapes_equal": shapes == want, "wk": shapes["blocks/attn/wk"], "kv_repeat":
                      plan8.kv_repeat(cfg.n_kv_heads, cfg.n_heads), "loss": float(l) / plan8.dp}

    # the weight-stationary decode at TP 4 and over a (pod, data) batch
    from repro_torch.parallel.specs import heads_shardable
    RES["stationary"] = {}
    for case in %(cases)r:
        mname, arch, kv = case.split("/")
        on = mesh if mname == "2x4" else pods
        cfg = configs.get_smoke(arch.removesuffix("-2heads"))
        if arch.endswith("-2heads"):
            cfg = dataclasses.replace(cfg, n_heads=2, n_kv_heads=2)
        ws = ParallelPlan(mesh=on, fsdp_axes=("data",), decode_feature_shard=True)
        rep = ws.kv_repeat(cfg.n_kv_heads, cfg.n_heads)  # the one process holds the widened heads
        r = stationary_decode(cfg, kv, on, ("pod", "data") if mname == "2x2x2" else ("data",),
                              cfg_one=dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads * rep))
        RES["stationary"][case] = {**r, "kv_repeat": rep, "heads_shardable": heads_shardable(cfg, ws)}
    finish()
""" % {"cases": STATIONARY_8_CASES})

_WORKER4 = _COMMON + textwrap.dedent(r"""
    from repro_torch.ft import CheckpointManager, CheckpointPolicy, LeafPolicy
    from repro_torch.parallel import specs as sp
    from repro_torch.train.step import state_specs
    mesh = make_debug_mesh((2, 2), ("data", "model"), device="cpu")
    rank = dist.get_rank()
    plain = ParallelPlan()
    base = dict(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))

    # sequence parallelism and manual_tp_psum against the plain sharded step
    for name, arch, lever in (("seq_axes", "nemotron-4-340b", {"seq_axes": ("model",), "microbatches": 2}),
                              ("manual_tp_psum", "qwen1.5-0.5b", {"manual_tp_psum": True, "remat": "dots"})):
        cfg = configs.get_smoke(arch)
        opt = AdamWConfig(lr=1e-3)
        sa, ma = sharded(cfg, ParallelPlan(**base), opt, 3)
        sb, mb = sharded(cfg, ParallelPlan(**base, **lever), opt, 3)
        RES[name] = compare(sa, sb, ma, mb)
    # bwd_cast_bf16: against one process with the same barrier, and the plain
    # sharded step's forward (the first loss)
    cfg = configs.get_smoke("qwen1.5-0.5b")
    opt = AdamWConfig(lr=1e-3)
    s1, m1 = one_process(cfg, ParallelPlan(bwd_cast_bf16=True), opt, 3)
    sb, mb = sharded(cfg, ParallelPlan(**base, bwd_cast_bf16=True), opt, 3)
    _, mp = sharded(cfg, ParallelPlan(**base), opt, 1)
    RES["bwd_cast_bf16"] = {**compare(s1, sb, m1, mb), "first_loss": [mp[0][0], mb[0][0]]}

    # every arch: the sharded step (FSDP over data, TP 2) against one process
    RES["archs"] = {}
    for arch in configs.ARCHS:
        cfg = configs.get_smoke(arch)
        opt = AdamWConfig(lr=1e-3)
        # MoE capacity follows the local token count: the batch replicated
        # over data keeps it the one process's (and cuts gradients over FSDP)
        plan = ParallelPlan(**{**base, "batch_axes": () if cfg.family == "moe" else ("data",)})
        drawn = models.init_params(0, cfg, plan, device="cpu").tree()
        s1, m1 = one_process(cfg, plain, opt, 2, params=drawn)
        s2, m2 = sharded(cfg, plan, opt, 2)
        RES["archs"][arch] = compare(s1, s2, m1, m2)

    # compressed gradients on a mesh with a model axis: the reference's
    # trajectory contract against the uncompressed sharded run
    cfg = configs.get_smoke("qwen1.5-0.5b")
    opt = AdamWConfig(lr=1e-3, weight_decay=0.0)
    _, mu = sharded(cfg, ParallelPlan(mesh=mesh, batch_axes=("data",)), opt, 20, total=20)
    sc, mc = sharded(cfg, ParallelPlan(mesh=mesh, batch_axes=("data",), grad_policy="int8:bs=512"), opt, 20, total=20)
    RES["compressed_grads"] = {"base": [x[0] for x in mu], "comp": [x[0] for x in mc],
                               "feedback": [list(sc["feedback"].shape), str(list(sc["feedback"].placements))]}

    # compressed moments, sharded (codes over the parameter's spec)
    opt = AdamWConfig(lr=1e-3, compress_moments=True)
    s1, m1 = one_process(cfg, plain, opt, 3)
    s2, m2 = sharded(cfg, ParallelPlan(**base), opt, 3)
    RES["compressed_moments"] = {**compare(s1, s2, m1, m2), "codes": str(list(
        s2["opt"]["m"]["blocks"]["attn"]["wq"].codes.placements))}

    # a lossless checkpoint of a sharded state, and its resume
    opt = AdamWConfig(lr=1e-3)
    plan = ParallelPlan(**base)
    lossless = CheckpointPolicy(rules=(("", LeafPolicy("lossless")),))
    state = init_train_state(0, cfg, plan, opt, device="cpu")
    step = jit_train_step(make_train_step(cfg, plan, opt), state, cfg, plan, opt, batch_at(cfg, 0))
    for k in range(2):
        state, _ = step(state, batch_at(cfg, k))
    CheckpointManager(f"{out}/sharded{rank}", policy=lossless, use_async=False, device="cpu").save(2, state)
    gathered = tree_util.tree_map(whole, state)
    if rank == 0:
        CheckpointManager(f"{out}/whole", policy=lossless, use_async=False, device="cpu").save(2, gathered)
        torch.save(dict(tree_util.flatten_with_path(gathered)[0]), f"{out}/gathered.pt")
    state, _ = step(state, batch_at(cfg, 2))
    dist.barrier()  # rank 0's checkpoint is on disk
    template = tree_util.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), gathered)
    host, _ = CheckpointManager(f"{out}/sharded0", device="cpu").restore(template)
    fresh = init_train_state(1, cfg, plan, opt, device="cpu")
    specs = state_specs(fresh, cfg, plan, opt)
    flat_host = dict(tree_util.flatten_with_path(host)[0])
    with torch.no_grad():
        for path, leaf, spec in sp.spec_leaves(fresh, specs):
            leaf.to_local().copy_(sp.shard_local(flat_host[path], spec, plan))
    fresh, _ = step(fresh, batch_at(cfg, 2))
    RES["resume_bitwise"] = all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(
        tree_util.flatten(state)[0], tree_util.flatten(fresh)[0]))

    # the launcher: --mesh data=2,model=2 (rank 0 prints the losses)
    t_main = __import__("repro_torch.launch.train", fromlist=["main"]).main
    t_main(["--device", "cpu", "--mesh", "data=2,model=2", "--steps", "6", "--ckpt-every", "3",
            "--ckpt-dir", f"{out}/launch"])

    # the sharded decode step against one process
    from repro_torch.serve.step import jit_serve_step, make_serve_step
    RES["decode"] = {}
    for arch, kv in (("qwen1.5-0.5b", "bf16"), ("qwen1.5-0.5b", "int8"), ("granite-3-8b", "bf16"),
                     ("deepseek-moe-16b", "bf16"), ("mamba2-2.7b", "bf16"), ("zamba2-7b", "bf16"),
                     ("whisper-small", "bf16")):
        cfg = configs.get_smoke(arch)
        # MoE capacity follows the local token count: the batch replicated
        # over data keeps every rank's count the one process's
        plan = ParallelPlan(mesh=mesh, fsdp_axes=("data",), kv_cache_dtype=kv,
                            batch_axes=() if cfg.family == "moe" else ("data",))
        one = ParallelPlan(kv_cache_dtype=kv)
        params = models.init_params(0, cfg, plan, device="cpu")
        g = torch.Generator().manual_seed(1)
        frames = torch.randn((4, cfg.enc_seq, cfg.d_model), generator=g) if cfg.family == "encdec" else None
        c1 = models.init_cache(params, cfg, one, 4, 16, enc_frames=frames)
        cm = models.init_cache(params, cfg, plan, 4, 16, enc_frames=frames)
        s1, sm = make_serve_step(cfg, one), jit_serve_step(make_serve_step(cfg, plan), params, cm, cfg, plan)
        worst = 0.0
        for t in range(5):
            tok = torch.randint(0, cfg.vocab, (4, 1), generator=g)
            l1, c1 = s1(params, c1, tok)
            lm, cm = sm(params, cm, tok)
            worst = max(worst, float((l1 - lm).abs().max()))
        RES["decode"][f"{arch}/{kv}"] = {"max_abs": worst, "shape": list(lm.shape), "vocab": cfg.vocab}

    # the weight-stationary decode against one process and the gathering
    # decode, and the storage each of its collectives read
    seen = collectives_logged()
    RES["stationary"] = {}
    for case in %(cases)r:
        arch, kv, *over = case.split("/")
        cfg = configs.get_smoke(arch)
        RES["stationary"][case] = stationary_decode(
            cfg, kv, mesh, ("data",) if cfg.family != "moe" or over else (), seen=seen)

    # the reference's weight-stationary decode: its weights and tokens
    RES["stationary_ref"] = {}
    ref = sys.argv[2] if len(sys.argv) > 2 else ""
    from repro_torch.serve.step import jit_serve_step, make_serve_step
    for case in (%(ref_cases)r if ref else []):
        path = f"{ref}/ws_{case.replace('/', '_')}.npz"
        deadline = time.time() + 240
        while not os.path.exists(path) and not os.path.exists(f"{ref}/ws_failed.txt") and time.time() < deadline:
            time.sleep(0.2)
        if not os.path.exists(path):
            RES["stationary_ref"][case] = {"error": "the reference wrote no result"}
            continue
        arch, kv, *over = case.split("/")
        cfg = configs.get_smoke(arch)
        z = np.load(path)
        tree = {}
        for key in z.files:
            if key.startswith("p/"):
                node = tree
                *keys, last = key[2:].split("/")
                for k in keys:
                    node = node.setdefault(k, {})
                node[last] = z[key]
        params = models.params_from_numpy(tree, cfg, device="cpu")
        plan = ParallelPlan(mesh=mesh, batch_axes=("data",) if cfg.family != "moe" or over else (),
                            fsdp_axes=("data",), kv_cache_dtype=kv, decode_feature_shard=True)
        frames = torch.from_numpy(z["frames"]) if "frames" in z.files else None
        cache = models.init_cache(params, cfg, plan, 4, 16, enc_frames=frames)
        step = jit_serve_step(make_serve_step(cfg, plan), params, cache, cfg, plan)
        worst = 0.0
        for t in range(len(z["tokens"])):
            logits, cache = step(params, cache, torch.from_numpy(z["tokens"][t]))
            worst = max(worst, float(np.abs(logits.numpy() - z["logits"][t]).max()))
        RES["stationary_ref"][case] = {"max_abs": worst, "shape": list(logits.shape)}
    finish()
""" % {"cases": STATIONARY_CASES, "ref_cases": STATIONARY_REF_CASES})


# ---------------------------------------------------------------------------
# the runs, started together once for the file
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    scripts = {}
    for name, body in (("ref_specs", _REF_SPECS), ("port_specs", _PORT_SPECS), ("ref_granite", _REF_GRANITE),
                       ("ref_stationary", _REF_STATIONARY), ("w8", _WORKER8), ("w4", _WORKER4)):
        scripts[name] = tmp / f"{name}.py"
        scripts[name].write_text(body)
    for d in ("w8", "w4", "ref"):
        (tmp / d).mkdir()
    procs = {"port_specs": [_spawn(scripts["port_specs"], [tmp / "port_specs.json"])],
             "w4": _spawn_group(4, scripts["w4"], [tmp / "w4", tmp / "ref" if HAVE_JAX else ""])}
    if HAVE_JAX:
        procs["ref_stationary"] = [_spawn(scripts["ref_stationary"], [tmp / "ref"])]
        procs["ref_granite"] = [_spawn(scripts["ref_granite"], [tmp / "ref"])]
        procs["ref_specs"] = [_spawn(scripts["ref_specs"], [tmp / "ref_specs.json"])]
        procs["w8"] = _spawn_group(8, scripts["w8"], [tmp / "w8", tmp / "ref"])
    cache = {}

    def get(name):
        if name not in cache:
            try:
                cache[name] = _wait(procs[name], name)
            except Exception:
                for ps in procs.values():
                    for p in ps:
                        p.kill()
                raise
        return cache[name]

    yield tmp, get
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _group_results(runs, name: str):
    tmp, get = runs
    outs = get(name)
    res = [json.loads((tmp / name / f"result{r}.json").read_text()) for r in range(len(outs))]
    return res, outs


@pytest.fixture(scope="module")
def specs(runs):
    if not HAVE_JAX:
        pytest.skip("the JAX package is not importable")
    tmp, get = runs
    get("port_specs")
    get("ref_specs")
    return (json.loads((tmp / "port_specs.json").read_text()), json.loads((tmp / "ref_specs.json").read_text()))


@pytest.fixture(scope="module")
def w8(runs):
    if not HAVE_JAX:
        pytest.skip("the JAX package is not importable")
    runs[1]("ref_granite")
    return _group_results(runs, "w8")


@pytest.fixture(scope="module")
def w4(runs):
    return _group_results(runs, "w4")


# ---------------------------------------------------------------------------
# (a) and (b): placements and plans
# ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("case", ["|".join(c) for c in SPEC_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_references(specs, arch, case):
    port, ref = specs
    size, mesh, fsdp = case.split("|")
    key = f"{arch}|{size}|{mesh}|{fsdp}"
    for what in ("params", "batch", "state", "state_compressed"):
        assert port["specs"][key][what] == ref["specs"][key][what], (key, what)
    comp = port["specs"][key]["state_compressed"]
    assert any(p.endswith("/codes") for p in comp) and any(p.endswith("/tags") for p in comp)


@needs_reference
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_plans_equal_the_references(specs, arch, cell, mesh):
    port, ref = specs
    key = f"{arch}|{mesh}|{cell}"
    assert port["plans"][key] == ref["plans"][key], key


def test_production_mesh_refuses_another_world_size(runs):
    tmp, get = runs
    get("port_specs")
    refusals = json.loads((tmp / "port_specs.json").read_text())["refusals"]
    assert sorted(refusals) == ["16x16", "2x4"]  # the (2, 16, 16) world builds the mesh it asked for
    assert all("torchrun" in msg for msg in refusals.values()), refusals


# ---------------------------------------------------------------------------
# (c) eight gloo ranks on (2, 4)
# ---------------------------------------------------------------------------

@needs_reference
def test_sharded_train_matches_single_device(w8):
    res, _ = w8
    c = res[0]["contract_train"]
    assert abs(c["loss1"] - c["loss8"]) < REF_LOSS_ATOL and c["leaf"] <= REF_LEAF_ATOL, c
    assert all(r["contract_train"] == c for r in res)  # every rank sees the group's loss and state


@needs_reference
def test_sharded_steps_match_the_one_process_steps(w8):
    res, _ = w8
    q = res[0]["qwen_steps"]
    assert q["loss_rel"] <= STEP_LOSS_RTOL and q["norm_rel"] <= STEP_NORM_RTOL, q
    assert q["param_abs"] <= STEP_PARAM_ATOL, q
    # FSDP over data and TP over model both shard something
    assert any("Shard" in p and "Replicate" not in p for p in res[0]["placements"]), res[0]["placements"]


@needs_reference
@pytest.mark.parametrize("arch", ["zamba2-7b", "granite-3-8b"])
def test_tp4_steps_match_the_one_process_steps(w8, arch):
    res, _ = w8
    r = res[0]["archs"][arch]
    assert r["loss_rel"] <= STEP_LOSS_RTOL and r["norm_rel"] <= STEP_NORM_RTOL, r
    assert r["param_abs"] <= STEP_PARAM_ATOL, r


@needs_reference
def test_a_pod_data_model_mesh_matches_one_process(w8):
    res, _ = w8
    r = res[0]["pods"]
    assert r["loss_rel"] <= STEP_LOSS_RTOL and r["norm_rel"] <= STEP_NORM_RTOL, r
    assert r["param_abs"] <= STEP_PARAM_ATOL, r
    c = res[0]["pods_compressed"]
    assert abs(c["losses"][0] - r["losses"][0]) <= STEP_LOSS_RTOL * r["losses"][0], (c, r)
    assert c["feedback"] == "[Shard(dim=0), Shard(dim=0), Replicate()]", c  # over pod, then data


@needs_reference
def test_moe_expert_parallel_parity(w8):
    res, _ = w8
    one, ep = res[0]["moe"]["default"]
    assert abs(one - ep) < MOE_DEFAULT_ATOL, (one, ep)
    one, ep = res[0]["moe"]["dropfree"]
    assert abs(one - ep) < MOE_DROPFREE_ATOL, (one, ep)


@needs_reference
def test_granite_on_the_references_tp4_weights(w8, runs):
    tmp, _ = runs
    res, _ = w8
    g = res[0]["granite"]
    ref = json.loads((tmp / "ref" / "granite_tp4.json").read_text())
    assert g["kv_repeat"] == 2 and g["shapes_equal"], g
    assert g["wk"] == [2, 128, 2 * 2 * 16]  # (L, d, n_kv * rep * hd)
    assert abs(g["loss"] - ref["loss"]) <= CARRY_LOSS_RTOL * abs(ref["loss"]), (g["loss"], ref["loss"])


# ---------------------------------------------------------------------------
# (d) four gloo ranks on (2, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lever", ["seq_axes", "manual_tp_psum"])
def test_plan_levers_match_the_plain_sharded_step(w4, lever):
    res, _ = w4
    r = res[0][lever]
    assert r["loss_rel"] <= STEP_LOSS_RTOL and r["norm_rel"] <= STEP_NORM_RTOL, r
    assert r["param_abs"] <= STEP_PARAM_ATOL, r


def test_bwd_cast_bf16_matches_one_process(w4):
    res, _ = w4
    r = res[0]["bwd_cast_bf16"]
    assert r["first_loss"][0] == r["first_loss"][1]  # the barrier changes no forward value
    assert r["loss_rel"] <= STEP_LOSS_RTOL and r["norm_rel"] <= BF16_NORM_RTOL, r
    assert r["param_abs"] <= BF16_PARAM_ATOL, r


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_trains_sharded_as_one_process(w4, arch):
    res, _ = w4
    r = res[0]["archs"][arch]
    assert r["loss_rel"] <= STEP_LOSS_RTOL and r["norm_rel"] <= STEP_NORM_RTOL, r
    assert r["param_abs"] <= STEP_PARAM_ATOL, r
    assert all(x["archs"][arch] == r for x in res)


def test_compressed_grads_with_a_model_axis_keep_the_trajectory(w4):
    res, _ = w4
    c = res[0]["compressed_grads"]
    base, comp = c["base"], c["comp"]
    # the same state on the same first batch (the compressed run's model runs
    # whole on each rank, the plain one over TP 2: sums in another order)
    assert abs(base[0] - comp[0]) <= STEP_LOSS_RTOL * base[0]
    worst = max(abs(a - b) for a, b in zip(base, comp))
    assert len(base) == 20 and worst < 0.05, (base, comp)
    assert base[-1] < base[0] - 0.2 and comp[-1] < comp[0] - 0.2
    assert c["feedback"][1] == "[Shard(dim=0), Replicate()]", c["feedback"]


def test_compressed_moments_sharded(w4):
    res, _ = w4
    r = res[0]["compressed_moments"]
    assert r["loss_rel"] <= STEP_LOSS_RTOL and r["param_abs"] <= CMOM_PARAM_ATOL, r
    assert r["codes"] == "[Shard(dim=1), Shard(dim=2)]", r  # wq (L, d, n_q*hd): FSDP on d, TP on heads


def _manifest(path: Path):
    m = json.loads((path / "manifest.json").read_text())
    for leaf in m["leaves"].values():
        leaf.pop("seconds")
    return m


def test_a_sharded_checkpoint_is_the_whole_states_and_resumes_bitwise(w4, runs):
    tmp, _ = runs
    res, _ = w4
    assert res[0]["resume_bitwise"]
    sharded, whole = tmp / "w4" / "sharded0" / "step_2", tmp / "w4" / "whole" / "step_2"
    assert _manifest(sharded) == _manifest(whole)
    for f in sorted(whole.iterdir()):
        assert (sharded / f.name).read_bytes() == f.read_bytes() or f.name == "manifest.json", f.name
    # both packages restore it
    from repro_torch import tree as tree_util
    from repro_torch.ft import CheckpointManager

    want = torch.load(tmp / "w4" / "gathered.pt")
    template = {}
    for path, t in want.items():
        node = template
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = torch.empty(t.shape, dtype=t.dtype, device="meta")
    host, _ = CheckpointManager(sharded.parent, device="cpu").restore(template)
    for path, t in tree_util.flatten_with_path(host)[0]:
        assert torch.equal(t, want[path]), path
    if HAVE_JAX:
        from repro.ft import CheckpointManager as RManager

        ref_tpl = {}
        for path, t in want.items():
            node = ref_tpl
            *keys, last = path.split("/")
            for k in keys:
                node = node.setdefault(k, {})
            node[last] = np.zeros(t.shape, np.float32 if t.dtype == torch.float32 else np.int32)
        rhost, _ = RManager(str(sharded.parent)).restore(ref_tpl)
        flat = jax.tree_util.tree_flatten_with_path(rhost)[0]
        for kp, a in flat:
            path = "/".join(str(k.key) for k in kp)
            assert np.array_equal(np.asarray(a), want[path].numpy()), path


def test_the_launcher_trains_on_a_data_model_mesh(w4, runs, capsys):
    tmp, _ = runs
    _, outs = w4
    mesh_losses = {int(k): float(v) for k, v in re.findall(r"step +(\d+) loss=([0-9.]+)", outs[0])}
    t_train.main(["--device", "cpu", "--steps", "6", "--ckpt-every", "3", "--ckpt-dir", str(tmp / "one")])
    one = {int(k): float(v) for k, v in re.findall(r"step +(\d+) loss=([0-9.]+)", capsys.readouterr().out)}
    assert sorted(mesh_losses) == sorted(one) == [0, 5]
    assert all(abs(mesh_losses[k] - one[k]) <= 1e-4 for k in one), (mesh_losses, one)
    for r in (1, 2, 3):
        assert "loss=" not in outs[r]  # rank 0 prints
    a, b = _manifest(tmp / "w4" / "launch" / "step_6"), _manifest(tmp / "one" / "step_6")
    assert {p: (m["shape"], m["dtype"], m["codec"]) for p, m in a["leaves"].items()} == \
        {p: (m["shape"], m["dtype"], m["codec"]) for p, m in b["leaves"].items()}


@pytest.mark.parametrize("case", ["qwen1.5-0.5b/bf16", "qwen1.5-0.5b/int8", "granite-3-8b/bf16",
                                  "deepseek-moe-16b/bf16", "mamba2-2.7b/bf16", "zamba2-7b/bf16",
                                  "whisper-small/bf16"])
def test_the_sharded_decode_step_matches_one_process(w4, case):
    res, _ = w4
    r = res[0]["decode"][case]
    assert r["shape"] == [4, r["vocab"]] and r["max_abs"] <= DECODE_ATOL, r
    assert all(x["decode"][case] == r for x in res)  # the logits come back whole on every rank


@pytest.mark.parametrize("case", STATIONARY_CASES)
def test_the_weight_stationary_decode_matches_one_process(w4, case):
    res, _ = w4
    r = res[0]["stationary"][case]
    assert r["weight_stationary"] and r["shape"] == [4, r["vocab"]], r
    assert r["max_abs"] <= DECODE_ATOL and r["against_gathering"] <= DECODE_ATOL, r
    assert all(x["stationary"][case] == r for x in res)  # the logits come back whole on every rank


def test_no_collective_of_a_weight_stationary_step_reads_a_parameter(w4):
    """Every collective of ``parallel.comm`` in a weight-stationary step
    reads an activation: none takes a parameter's storage, over five
    steps of each case; the gathering step's FSDP gathers do, which shows
    the log sees a parameter where one is gathered."""
    res, _ = w4
    for case, r in res[0]["stationary"].items():
        c = r["collective_inputs_on_params"]
        assert c["stationary"] == 0 and c["collectives"] > 0, (case, c)
        assert c["gathering"] > 0, (case, c)


@needs_reference
@pytest.mark.parametrize("case", STATIONARY_REF_CASES)
def test_the_weight_stationary_decode_matches_the_references(w4, runs, case):
    runs[1]("ref_stationary")
    res, _ = w4
    r = res[0]["stationary_ref"][case]
    assert "error" not in r and r["shape"][0] == 4, r
    assert r["max_abs"] <= STATIONARY_REF_ATOL[case.split("/")[1]], r


@needs_reference
@pytest.mark.parametrize("case", STATIONARY_8_CASES)
def test_the_weight_stationary_decode_on_eight_ranks(w8, case):
    res, _ = w8
    r = res[0]["stationary"][case]
    assert r["weight_stationary"] and r["shape"] == [4, r["vocab"]], r
    assert r["max_abs"] <= DECODE_ATOL and r["against_gathering"] <= DECODE_ATOL, r
    if case.startswith("2x4/granite"):
        assert r["kv_repeat"] == 2 and r["heads_shardable"], r
    if "2heads" in case:
        assert not r["heads_shardable"], r
    assert all(x["stationary"][case] == r for x in res)


# ---------------------------------------------------------------------------
# a reference fault the port repairs
# ---------------------------------------------------------------------------

class _Mesh:
    """A stand-in for a ``DeviceMesh``: specs read only axis names and sizes."""

    mesh_dim_names = ("data", "model")

    def size(self, i):
        return (2, 4)[i]


@needs_reference
def test_batch_specs_of_a_replicated_batch():
    """``long_500k``'s plan replicates its batch of 1 (``batch_axes=()``):
    the reference's ``batch_specs`` indexes the empty tuple and raises; the
    port's leaves the batch dim unsharded, as the reference's ``plan.b``
    does everywhere else."""
    from repro.parallel import ParallelPlan as RPlan
    from repro.parallel.specs import batch_specs as r_batch_specs

    from repro_torch.parallel import ParallelPlan
    from repro_torch.parallel.specs import batch_specs

    shapes = {"tokens": torch.empty((1, 1), device="meta")}
    assert batch_specs(shapes, ParallelPlan(mesh=_Mesh(), batch_axes=())) == {"tokens": (None, None)}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with pytest.raises(IndexError):
        r_batch_specs({"tokens": jax.ShapeDtypeStruct((1, 1), "int32")}, RPlan(mesh=mesh, batch_axes=()))


class _GroupMesh(_Mesh):
    """A stand-in whose axes' groups are their names."""

    def get_group(self, name):
        return f"group:{name}"


def test_a_weight_stationary_plan_builds_and_reports_its_feature_groups():
    """``decode_feature_shard`` with FSDP axes builds a plan whose decode
    keeps the weights at their shards, its stream's features over the
    FSDP axes that the mesh has; without FSDP axes or a mesh the flag
    changes nothing."""
    from repro_torch.parallel import ParallelPlan

    plan = ParallelPlan(mesh=_GroupMesh(), fsdp_axes=("data",), decode_feature_shard=True)
    assert plan.weight_stationary and plan.feature_groups() == ["group:data"]
    pods = ParallelPlan(mesh=_GroupMesh(), batch_axes=("pod", "data"), fsdp_axes=("pod", "data"),
                        decode_feature_shard=True)
    assert pods.weight_stationary and pods.feature_groups() == ["group:data"]  # the axes the mesh has
    assert not ParallelPlan(mesh=_GroupMesh(), decode_feature_shard=True).weight_stationary
    assert not ParallelPlan(mesh=_GroupMesh(), fsdp_axes=("data",)).weight_stationary
    assert not ParallelPlan(fsdp_axes=("data",), decode_feature_shard=True).weight_stationary


@pytest.mark.parametrize("factor", [1.25, 16.0])
def test_a_dispatch_in_blocks_is_each_blocks_own_dispatch(monkeypatch, factor):
    """The weight-stationary decode routes every row on every rank in the
    reference's data-parallel blocks: two blocks give what each half of
    the tokens gives on its own (outputs bit for bit, the aux loss their
    mean, the share dropped theirs), at the default capacity and
    drop-free."""
    from repro_torch.models import moe

    monkeypatch.setattr(moe, "CAPACITY_FACTOR", factor)
    g = torch.Generator().manual_seed(2)
    T, d, E, f, k = 40, 16, 8, 12, 2
    x = torch.randn(T, d, generator=g) + 1.0
    router = torch.randn(d, E, generator=g)
    router[:, 0] = 1.0  # most tokens pick expert 0: past its capacity at the default
    w1, w3 = torch.randn(E, d, f, generator=g), torch.randn(E, d, f, generator=g)
    w2 = torch.randn(E, f, d, generator=g)
    y, aux, dropped = moe._moe_local(x, router, w1, w3, w2, top_k=k, n_experts=E, blocks=2)
    halves = [moe._moe_local(x[i:i + T // 2], router, w1, w3, w2, top_k=k, n_experts=E) for i in (0, T // 2)]
    assert torch.equal(y, torch.cat([h[0] for h in halves]))
    torch.testing.assert_close(aux, (halves[0][1] + halves[1][1]) / 2)
    torch.testing.assert_close(dropped, (halves[0][2] + halves[1][2]) / 2)
    if factor == 1.25:
        assert float(dropped) > 0  # the capacity of a block of 20 tokens drops some


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_parallel_partial_products_keep_their_float32_accumulator(dtype):
    """``tp_project``'s partial products without ``manual_tp_psum``: float32
    whatever the operands, and a bf16 product's value is the float32
    product of its operands (each bf16 product is exact in float32)."""
    from repro_torch.parallel.plan import _float32_product

    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 5, 24, generator=g).to(dtype)
    w = torch.randn(24, 7, generator=g).to(dtype)
    y = _float32_product(h, w)
    assert y.dtype == torch.float32 and y.shape == (2, 5, 7)
    torch.testing.assert_close(y, h.float() @ w.float(), rtol=0, atol=0)


class _OneRankModelAxis:
    """A plan on a mesh whose model axis has one rank, as far as the MoE
    dispatch reads it."""

    model_axis = "model"
    tp_rank = 0

    def present(self, axes):
        return tuple(a for a in axes if a == "model")

    def tp_enter(self, x):
        return x


@pytest.mark.parametrize("factor", [1.25, 16.0])
def test_expert_parallel_dispatch_on_one_rank_is_the_plain_dispatch(monkeypatch, factor):
    """On a model axis of one rank the expert-parallel dispatch runs (the
    discard bucket, the rank's expert offset) and gives the plain
    dispatch's output, aux loss and drops bit for bit, at the default
    capacity and drop-free."""
    from repro_torch.models import moe

    monkeypatch.setattr(moe, "CAPACITY_FACTOR", factor)
    g = torch.Generator().manual_seed(1)
    T, d, E, f, k = 48, 16, 8, 12, 2
    x = torch.randn(T, d, generator=g)
    router = torch.randn(d, E, generator=g)
    w1, w3 = torch.randn(E, d, f, generator=g), torch.randn(E, d, f, generator=g)
    w2 = torch.randn(E, f, d, generator=g)
    plain = moe._moe_local(x, router, w1, w3, w2, top_k=k, n_experts=E, plan=None)
    ep = moe._moe_local(x, router, w1, w3, w2, top_k=k, n_experts=E, plan=_OneRankModelAxis())
    for a, b in zip(plain, ep):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="the bf16 product with a float32 output runs on the card")
def test_bf16_row_parallel_product_on_the_card_matches_the_float32_product():
    """On the card ``tp_project``'s bf16 product keeps bf16 operands; its
    output and gradients (through the later cast to bf16) agree with the
    product of the operands cast to float32."""
    from repro_torch.parallel.plan import _float32_product

    g = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(2, 64, 96, device="cuda", generator=g).bfloat16().requires_grad_(True)
    w = torch.randn(96, 32, device="cuda", generator=g).bfloat16().requires_grad_(True)
    ct = torch.randn(2, 64, 32, device="cuda", generator=g).bfloat16()
    h2, w2 = (t.detach().clone().requires_grad_(True) for t in (h, w))
    y = _float32_product(h, w)
    y.to(torch.bfloat16).backward(ct)
    y2 = torch.matmul(h2.float(), w2.float())
    y2.to(torch.bfloat16).backward(ct)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, y2, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(h.grad, h2.grad, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-2, atol=1e-2)
