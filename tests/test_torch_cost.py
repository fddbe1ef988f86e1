"""The port's cost counter (``repro_torch.launch.cost``) and dry run
(``repro_torch.launch.dryrun``) against the reference's HLO cost parser
(``repro.launch.hlo_cost``) and dry run.

The analytic cases of ``tests/test_hlo_cost.py`` run here in torch, the
scans as Python loops, on meta tensors.  Everything that needs a process
group runs in subprocesses over a fake group (``FakeStore``); the
reference's readings come from its jitted steps on 4 XLA CPU devices in a
subprocess, as ``tests/test_distributed.py`` runs them.  One module
fixture starts them all at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.launch import cost

try:  # the reference's side needs the JAX package
    import jax
    import jax.numpy as jnp

    from repro.launch import hlo_cost

    HAVE_JAX = True
except ImportError:  # pragma: no cover - a machine without JAX
    HAVE_JAX = False

needs_reference = pytest.mark.skipif(not HAVE_JAX, reason="the JAX package is not importable")

SRC = Path(__file__).resolve().parents[1] / "src"
#: smoke train steps on a (2, 2) mesh, FSDP over data, batch 8 x 64: Qwen
#: (dense), granite (tensor parallel), deepseek-moe (expert parallel)
STEP_ARCHS = ("qwen1.5-0.5b", "granite-3-8b", "deepseek-moe-16b")
#: smoke decode steps on (2, 2), FSDP over data, gathering against
#: weight-stationary (``decode_feature_shard``): dense, TP with GQA, the
#: MoE's experts, Mamba2
DECODE_ARCHS = ("qwen1.5-0.5b", "granite-3-8b", "deepseek-moe-16b", "mamba2-2.7b")
#: the counts agree to the FLOP on these steps (measured); held at the
#: analytic cases' 1%
DOT_RTOL = 0.01
#: keys of a dry-run cell's JSON
CELL_KEYS = {"arch", "shape", "mesh", "mesh_shape", "chips", "kind", "batch", "seq", "overrides", "plan", "timing",
             "memory_analysis", "counted", "plain_kernels", "roofline"}
_TIMEOUT = 300


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                                                             "XLA_FLAGS")}
    return {**env, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}


def _spawn(args, cwd=None):
    return subprocess.Popen([sys.executable, *map(str, args)], env=_env(), cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(p, what: str, ok=(0,)) -> str:
    out, err = p.communicate(timeout=_TIMEOUT)
    assert p.returncode in ok, f"{what} exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}"
    return out


_REF_STEPS = textwrap.dedent(r"""
    import functools, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import repro.configs as configs
    from repro.launch import hlo_cost
    from repro.optim import AdamWConfig
    from repro.parallel import ParallelPlan, compat
    from repro.train.step import init_train_state, jit_train_step, make_train_step
    mesh = compat.make_mesh((2, 2), ("data", "model"), auto_axis_types=True)
    res = {}
    for arch in %(archs)r:
        cfg = configs.get_smoke(arch)
        plan = ParallelPlan(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
        opt = AdamWConfig()
        shapes = jax.eval_shape(functools.partial(init_train_state, jax.random.PRNGKey(0), cfg, plan, opt))
        specs = configs.input_specs(cfg, configs.ShapeCell("smoke", "train", 64, 8))
        j = jit_train_step(make_train_step(cfg, plan, opt), shapes, cfg, plan, opt, specs)
        c = hlo_cost.analyze(j.lower(shapes, specs).compile().as_text(), n_devices=4)
        res[arch] = {"dot_flops": c.dot_flops, "flops": c.flops}
    json.dump(res, open(sys.argv[1], "w"))
""") % {"archs": STEP_ARCHS}

_PORT_STEPS = textwrap.dedent(r"""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import cost, dryrun
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import ParallelPlan
    from repro_torch.train.step import init_train_state, jit_train_step, make_train_step
    res = {}
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        for arch in %(archs)r:
            cfg = configs.get_smoke(arch)
            plan = ParallelPlan(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
            opt = AdamWConfig()
            state = init_train_state(0, cfg, plan, opt, device="meta")
            specs = configs.input_specs(cfg, configs.ShapeCell("smoke", "train", 64, 8))
            step = jit_train_step(make_train_step(cfg, plan, opt), state, cfg, plan, opt, specs)
            _, c = cost.count(step, state, specs)
            res[arch] = {"dot_flops": c.dot_flops, "flops": c.flops, "collectives": dict(c.collectives),
                         "dtensor_ops": c.dtensor_ops}
        # each collective on 1000 float32 (4000 bytes), on the world and on
        # the mesh's model axis (2 ranks)
        t = torch.empty(1000, device="meta")

        def collectives(group):
            n = dist.get_world_size(group)
            dist.all_reduce(t, group=group)
            dist.all_gather_into_tensor(torch.empty(n * 1000, device="meta"), t, group=group)
            dist.reduce_scatter_tensor(torch.empty(1000 // n, device="meta"), t, group=group)
            dist.all_to_all_single(torch.empty(1000, device="meta"), t, group=group)

        for name, group in (("world", None), ("model", mesh.get_group("model"))):
            _, c = cost.count(collectives, group)
            res[f"wire|{name}"] = {"per_collective": dict(c.per_collective), "collectives": dict(c.collectives),
                                   "collective_bytes": c.collective_bytes, "hbm_bytes": c.hbm_bytes}

        # a smoke decode step (batch 8, FSDP over data), gathering and
        # weight-stationary: its all-gathers' input bytes and the bytes of
        # every FSDP shard of a weight (a stacked one's, and one layer's)
        from repro_torch import models
        from repro_torch import tree as tree_util
        from repro_torch.parallel import specs as sp
        from repro_torch.serve.step import _walk, cache_specs, jit_serve_step, make_serve_step
        for arch in %(decode_archs)r:
            cfg = configs.get_smoke(arch)
            for ws in (False, True):
                plan = ParallelPlan(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",), decode_feature_shard=ws)
                params = models.init_params(0, cfg, plan, device="meta").tree()
                pspecs = sp.param_specs(params, cfg, plan)
                placed = sp.map_paths(lambda path, t: sp.place(t, sp.spec_at(pspecs, "/".join(path)), plan), params)
                cache = models.init_cache(params, cfg, plan, 8, 64)
                cache = _walk(lambda _, sp_, t: sp.place(t, sp_, plan), cache_specs(cache, cfg, plan), cache)
                step = jit_serve_step(make_serve_step(cfg, plan), placed, cache, cfg, plan)
                tokens = torch.zeros((8, 1), dtype=torch.int32, device="meta")
                _, c = cost.count(step, placed, cache, tokens)
                shards = set()
                for path, t, spec in sp.spec_leaves(placed, pspecs):
                    if any("data" in axes for axes in sp.spec_entries(spec, t.ndim)):
                        local = t.to_local()
                        shards.add(local.numel() * local.element_size())
                        if path.split("/")[0].endswith("blocks"):  # a stacked leaf: one layer's too
                            shards.add(local[0].numel() * local.element_size())
                res[f"decode|{arch}|{ws}"] = {
                    "collective_bytes": c.collective_bytes, "collectives": dict(c.collectives),
                    "gather_inputs": [i for kind, i, o, g in c.log if kind == "all-gather"], "shards": sorted(shards)}
    json.dump(res, open(sys.argv[1], "w"))
""") % {"archs": STEP_ARCHS, "decode_archs": DECODE_ARCHS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cost")
    (out / "ref_steps.py").write_text(_REF_STEPS)
    (out / "port_steps.py").write_text(_PORT_STEPS)
    procs = {"port_steps": _spawn([out / "port_steps.py", out / "port_steps.json"]),
             "port_list": _spawn(["-m", "repro_torch.launch.dryrun", "--list"]),
             "cell": _spawn(["-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                             "--out", out / "dr"]),
             "skip": _spawn(["-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b", "--shape", "long_500k",
                             "--out", out / "dr"]),
             "fail": _spawn(["-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b", "--shape", "prefill_32k",
                             "--out", out / "dr", "--variant", '{"remat": "sometimes"}', "--tag", "bad"])}
    if HAVE_JAX:
        procs["ref_steps"] = _spawn([out / "ref_steps.py", out / "ref_steps.json"])
        procs["ref_list"] = _spawn(["-m", "repro.launch.dryrun", "--list"], cwd=out)
    outs = {name: _wait(p, name) for name, p in procs.items()}
    return out, outs


# ---------------------------------------------------------------------------
# the analytic cases of tests/test_hlo_cost.py
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _ref_cost(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_cost.analyze(jax.jit(f).lower(*args).compile().as_text())


def _loop_matmul(x, ws):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


def test_loop_trip_count():
    _, c = cost.count(_loop_matmul, _meta(128, 256), _meta(10, 256, 256))
    expect = 10 * 2 * 128 * 256 * 256
    assert abs(c.dot_flops - expect) / expect < DOT_RTOL
    assert not hasattr(c, "while_trips")
    if HAVE_JAX:
        def f(x, ws):
            y, _ = jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)
            return y

        ref = _ref_cost(f, (128, 256), (10, 256, 256))
        assert abs(c.dot_flops - ref.dot_flops) / ref.dot_flops < DOT_RTOL


def test_nested_loops():
    def outer(x, ws):
        for _ in range(3):
            for w in ws:
                x = x @ w
        return x

    _, c = cost.count(outer, _meta(64, 64), _meta(5, 64, 64))
    expect = 3 * 5 * 2 * 64 * 64 * 64
    assert abs(c.dot_flops - expect) / expect < DOT_RTOL
    if HAVE_JAX:
        def f(x, ws):
            def ob(x, _):
                y, _ = jax.lax.scan(lambda x, w: (x @ w, None), x, ws)
                return y, None

            y, _ = jax.lax.scan(ob, x, None, length=3)
            return y

        ref = _ref_cost(f, (64, 64), (5, 64, 64))
        assert abs(c.dot_flops - ref.dot_flops) / ref.dot_flops < DOT_RTOL


def test_dot_flops_batched():
    _, c = cost.count(lambda a, b: torch.einsum("bij,bjk->bik", a, b), _meta(4, 32, 64), _meta(4, 64, 16))
    expect = 2 * 4 * 32 * 16 * 64
    assert abs(c.dot_flops - expect) / expect < DOT_RTOL
    if HAVE_JAX:
        ref = _ref_cost(lambda a, b: jnp.einsum("bij,bjk->bik", a, b), (4, 32, 64), (4, 64, 16))
        assert abs(c.dot_flops - ref.dot_flops) / ref.dot_flops < DOT_RTOL


def test_memory_bytes_sane():
    _, c = cost.count(lambda a: a * 2.0 + 1.0, _meta(1 << 20))
    # two eager ops, each a read and a write of 4 MiB: inside the
    # reference's window for its one fused op
    assert 4e6 <= c.hbm_bytes <= 2e7
    assert c.hbm_bytes == 4 * 4 * (1 << 20)
    assert c.flops == 2 * (1 << 20) and c.dot_flops == 0


def test_real_tensors_count_as_meta_ones():
    g = torch.Generator().manual_seed(0)
    x, ws = torch.randn(16, 32, generator=g), torch.randn(3, 32, 32, generator=g)
    out, real = cost.count(_loop_matmul, x, ws)
    _, meta = cost.count(_loop_matmul, x.to("meta"), ws.to("meta"))
    assert torch.equal(out, _loop_matmul(x, ws))
    assert (real.flops, real.dot_flops, real.hbm_bytes) == (meta.flops, meta.dot_flops, meta.hbm_bytes)


def test_views_are_free_and_slice_updates_count_the_slice():
    buf = _meta(1 << 20)
    _, c = cost.count(lambda b: b.view(1024, 1024).t()[3:5].unsqueeze(0), buf)
    assert c.hbm_bytes == 0 and c.flops == 0
    upd = _meta(100)
    _, c = cost.count(lambda b, u: b[1000:1100].copy_(u), buf, upd)
    assert c.hbm_bytes == 2 * 400  # the update read, the slice written
    idx = torch.empty(100, dtype=torch.int64, device="meta")
    _, c = cost.count(lambda b, i, u: b.index_put_((i,), u), buf, idx, upd)
    assert c.hbm_bytes == 2 * 400 + 800  # the values twice, the indices once


def test_wire_bytes_ring_model():
    for r in (1, 2, 4, 8):
        assert cost._collective_wire_bytes("all-reduce", 4000, 4000, r) == 2 * 4000 * (max(2, r) - 1) / max(2, r)
    assert cost._collective_wire_bytes("all-gather", 1000, 4000, 4) == 3000
    assert cost._collective_wire_bytes("reduce-scatter", 4000, 1000, 4) == 3000
    assert cost._collective_wire_bytes("all-to-all", 4000, 4000, 4) == 3000
    assert cost._collective_wire_bytes("collective-permute", 4000, 4000, 4) == 4000


# ---------------------------------------------------------------------------
# collectives and whole steps over a fake process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group,r", [("world", 4), ("model", 2)])
def test_collective_wire_bytes_on_a_fake_group(runs, group, r):
    out, _ = runs
    res = json.loads((out / "port_steps.json").read_text())[f"wire|{group}"]
    b = 4000
    assert res["per_collective"] == {"all-reduce": 2 * b * (r - 1) / r, "all-gather": (r - 1) * b,
                                     "reduce-scatter": b - b // r, "all-to-all": b * (r - 1) / r}
    assert res["collectives"] == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1, "all-to-all": 1}
    assert res["collective_bytes"] == sum(res["per_collective"].values())
    assert res["hbm_bytes"] > 0


@needs_reference
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_dot_flops_equal_the_references_hlo_cost(runs, arch):
    out, _ = runs
    port = json.loads((out / "port_steps.json").read_text())[arch]
    ref = json.loads((out / "ref_steps.json").read_text())[arch]
    assert abs(port["dot_flops"] - ref["dot_flops"]) / ref["dot_flops"] < DOT_RTOL, (port, ref)
    assert port["dtensor_ops"] == 0  # the step runs on local tensors
    assert port["collectives"]["all-gather"] > 0 and port["collectives"]["reduce-scatter"] > 0
    assert port["flops"] > port["dot_flops"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_a_weight_stationary_decode_step_moves_fewer_collective_bytes(runs, arch):
    """The weight-stationary decode step sums activations where the
    gathering step gathers weights: fewer collective bytes, and no
    all-gather the size of a weight's FSDP shard (the gathering step's
    are)."""
    out, _ = runs
    res = json.loads((out / "port_steps.json").read_text())
    gathering, stationary = res[f"decode|{arch}|False"], res[f"decode|{arch}|True"]
    shards = set(gathering["shards"])
    assert stationary["shards"] == gathering["shards"]  # the same placements
    assert shards & set(gathering["gather_inputs"]), gathering
    assert not shards & set(stationary["gather_inputs"]), stationary
    assert stationary["collectives"]["all-reduce"] > 0
    assert 0 < stationary["collective_bytes"] < gathering["collective_bytes"], (stationary, gathering)


# ---------------------------------------------------------------------------
# the dry run's CLI
# ---------------------------------------------------------------------------

@needs_reference
def test_dryrun_list_equals_the_references(runs):
    _, outs = runs
    ours, theirs = outs["port_list"].splitlines(), outs["ref_list"].splitlines()
    assert ours == theirs and len(ours) == 40


def test_dryrun_list_matches_cell_list():
    from repro_torch.launch import dryrun

    cells = dryrun.cell_list()
    assert len(cells) == 40
    assert sum(1 for *_, skip in cells if skip) == 7  # long_500k of the pure full-attention archs


def test_dryrun_cell_json(runs):
    out, _ = runs
    res = json.loads((out / "dr" / "single" / "qwen1.5-0.5b__decode_32k.json").read_text())
    assert set(res) == CELL_KEYS
    assert (res["chips"], res["mesh_shape"], res["kind"], res["batch"]) == (256, [16, 16], "decode", 128)
    assert res["plan"]["fsdp_axes"] == ["data"] and res["plain_kernels"] == []
    c, m, r = res["counted"], res["memory_analysis"], res["roofline"]
    assert set(c) >= {"flops_per_chip", "dot_flops_per_chip", "hbm_bytes_per_chip", "collective_bytes_per_chip",
                      "per_collective"}
    assert c["dot_flops_per_chip"] > 0 and c["collective_bytes_per_chip"] > 0 and c["dtensor_ops_skipped"] == 0
    assert 0 < m["argument_size_in_bytes"] < m["peak_memory_in_bytes"]
    assert (r["peak_flops"], r["hbm_bw"], r["link_bw"]) == (989e12, 3.35e12, 50e9)
    assert r["compute_s"] == pytest.approx(c["flops_per_chip"] / 989e12)
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert "cost_analysis_raw" not in res and "hlo_corrected" not in res


def test_dryrun_skipped_and_failed_cells_are_recorded(runs):
    out, _ = runs
    skipped = json.loads((out / "dr" / "single" / "qwen1.5-0.5b__long_500k.json").read_text())
    assert skipped["skipped"].startswith("pure full-attention arch")
    err = json.loads((out / "dr" / "single" / "qwen1.5-0.5b__prefill_32k__bad.error.json").read_text())
    assert "remat" in err["error"] and "Traceback" in err["traceback"]
    assert not (out / "dr" / "single" / "qwen1.5-0.5b__prefill_32k__bad.json").exists()


def test_the_dry_runs_peak_counts_a_viewed_argument_once():
    """A step that views its arguments (a cache's layer, a parameter's
    shard) holds no new storage for them: the temporaries are what the
    step makes.  Without the arguments registered, a view's storage was
    counted as new, once more beside the argument bytes."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch import dryrun

    cache = {"k": torch.empty(4, 1000, device="meta"), "v": torch.empty(4, 1000, device="meta")}

    def step(c):
        return c["k"][1] * 2.0 + c["v"][2]  # two views, two temporaries of 1,000 floats

    tracker = dryrun.arguments_tracker((cache,))
    with tracker:
        step(cache)
    assert dryrun.temp_bytes(tracker) == 2 * 4000
    unregistered = MemTracker()
    with unregistered:
        step(cache)
    assert dryrun.temp_bytes(unregistered) == 2 * 16000 + 2 * 4000  # what the peak double-counted


def test_a_checkpointed_block_counts_the_products_that_run():
    """Under remat, the backward recomputes the block only up to the last
    tensor it saved: the last product's inputs are saved before it runs, so
    checkpoint's early stop aborts it before its kernel.  The count holds
    the products that ran: 2 forward, 1 recomputed, 4 backward."""
    from torch.utils.checkpoint import checkpoint

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=g, requires_grad=True)
    w1 = torch.randn(16, 32, generator=g, requires_grad=True)
    w2 = torch.randn(32, 16, generator=g, requires_grad=True)

    def step():
        y = checkpoint(lambda t: torch.relu(t @ w1) @ w2, x, use_reentrant=False).sum()
        return torch.autograd.grad(y, [x, w1, w2])

    _, c = cost.count(step)
    mm = 2 * 8 * 16 * 32
    assert c.dot_flops == 7 * mm
