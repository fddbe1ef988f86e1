"""Elastic resharded restore in the port (``repro_torch.ft.elastic``)
against the JAX package's ``repro.ft.elastic``.

Nothing here opens a process group in the pytest process.  The ranks are
spawned with the ``torchrun`` environment, one thread each, and the
reference runs in subprocesses with ``--xla_force_host_platform_device_count``,
as ``tests/test_distributed.py`` does.  One module fixture starts them:

  (a) plans: ``validate_divisibility`` and ``replan`` (onto the (15, 16)
      mesh of 240 survivors) for every arch and cell under the cell plans
      of the production meshes, the port's over a fake process group;
  (b) eight gloo ranks on (2, 4) train one step of the smoke Qwen state
      under FSDP and save it, whole, with a 16 MiB smooth moment that the
      checkpoint writes as a 4-chunk container; the reference saves the
      same arrays, and restores both checkpoints resharded onto 4 XLA
      devices on (2, 2) and (4, 1);
  (c) four gloo ranks, the elastic restart: ``make_elastic_mesh``,
      ``replan`` and ``restore_resharded`` of both checkpoints on (2, 2)
      and on (4, 1), each rank's shards against ``mgr.restore`` plus
      ``shard_local`` and against ``reshard_state``;
  (d) six gloo ranks: ``make_elastic_mesh`` over all six and over the
      first four.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.ft import checkpoint as tck
from repro_torch.ft import elastic as te
from repro_torch.parallel import ParallelPlan

try:  # the reference's side needs the JAX package
    from repro.ft import checkpoint as rck
    from repro.ft import elastic as re_

    HAVE_JAX = True
except ImportError:  # pragma: no cover - a machine without JAX
    HAVE_JAX = False

needs_reference = pytest.mark.skipif(not HAVE_JAX, reason="the JAX package is not importable")

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = ("2x2", "4x1")
WRITERS = ("port", "ref")
#: the big moment: 8192 x 512 float32 (16 MiB), a random walk down the rows;
#: the checkpoint chunks it into 4 containers of 2048 rows
BIG_SHAPE = (4 * 2048, 512)
#: a leaf sharded over 4 ranks along dim 0 reads its quarter: 1 chunk of 4
#: plus the header
QUARTER_READ_MAX = 0.35
_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
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
    for p in procs:
        out, err = p.communicate(timeout=_TIMEOUT)
        assert p.returncode == 0, f"{what} failed:\n{out[-2000:]}\n{err[-4000:]}"


def big_moment() -> np.ndarray:
    rng = np.random.default_rng(7)
    return (np.cumsum(rng.normal(size=BIG_SHAPE).astype(np.float32), 0) * 1e-3).astype(np.float32)


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------

_REF_PLANS = textwrap.dedent(r"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, numpy as np
    import repro.configs as configs
    from repro.ft.elastic import make_elastic_mesh, replan, validate_divisibility
    from repro.launch.plans import make_cell_plan

    devs = np.asarray(jax.devices())
    meshes = {"16x16": jax.sharding.Mesh(devs[:256].reshape(16, 16), ("data", "model")),
              "2x16x16": jax.sharding.Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"))}
    survivors = make_elastic_mesh(list(devs[:240]))
    res = {"survivors": list(survivors.devices.shape)}
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        for mname, mesh in meshes.items():
            for cell in configs.SHAPES.values():
                plan, _ = make_cell_plan(arch, cfg, cell, mesh, multi_pod=mname == "2x16x16")
                new = replan(cfg, plan, survivors)
                fields = {f: getattr(new, f) for f in new.__dataclass_fields__ if f != "mesh"}
                res[f"{arch}|{mname}|{cell.name}"] = {
                    "checks": validate_divisibility(cfg, plan), "checks_after": validate_divisibility(cfg, new),
                    "replan": {k: list(v) if isinstance(v, tuple) else v for k, v in fields.items()}}
    json.dump(res, open(sys.argv[1], "w"))
""")

_PORT_PLANS = textwrap.dedent(r"""
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import configs
    from repro_torch.ft.elastic import make_elastic_mesh, replan, validate_divisibility
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.plans import make_cell_plan

    res = {}
    for mname, n in (("16x16", 256), ("2x16x16", 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
        mesh = make_production_mesh(multi_pod=mname == "2x16x16", device="cpu")
        survivors = make_elastic_mesh(240, device="cpu")
        res["survivors"] = list(survivors.shape)
        for arch in configs.ARCHS:
            cfg = configs.get(arch)
            for cell in configs.SHAPES.values():
                plan, _ = make_cell_plan(arch, cfg, cell, mesh)
                new = replan(cfg, plan, survivors)
                fields = {f: getattr(new, f) for f in new.__dataclass_fields__ if f != "mesh"}
                res[f"{arch}|{mname}|{cell.name}"] = {
                    "checks": validate_divisibility(cfg, plan), "checks_after": validate_divisibility(cfg, new),
                    "replan": {k: list(v) if isinstance(v, tuple) else v for k, v in fields.items()}}
        dist.destroy_process_group()
    json.dump(res, open(sys.argv[1], "w"))
""")

_COMMON = textwrap.dedent(r"""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs, models, tree as tree_util
    from repro_torch.ft import CheckpointManager
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.parallel import ParallelPlan
    torch.set_num_threads(1)
    out = sys.argv[1]
    rank = int(os.environ["RANK"])
    cfg = configs.get_smoke("qwen1.5-0.5b")
    opt = AdamWConfig(lr=1e-3)
    BIG = (4 * 2048, 512)
    BIG_SPEC = (("data", "model"), None)
""")

_SAVE = _COMMON + textwrap.dedent(r"""
    from repro_torch.data import make_pipeline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.step import init_train_state, jit_train_step, make_train_step
    mesh = make_debug_mesh((2, 4), ("data", "model"), device="cpu")
    plan = ParallelPlan(mesh=mesh, batch_axes=("data",), fsdp_axes=("data",))
    state = init_train_state(0, cfg, plan, opt, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_pipeline(cfg, seq=16, global_batch=4).batch_at(0).items()}
    step = jit_train_step(make_train_step(cfg, plan, opt), state, cfg, plan, opt, batch)
    state, _ = step(state, batch)
    whole = tree_util.tree_map(lambda t: t.full_tensor(), state)  # every rank joins the gathers
    if rank == 0:
        rng = np.random.default_rng(7)
        big = (np.cumsum(rng.normal(size=BIG).astype(np.float32), 0) * 1e-3).astype(np.float32)
        tree = {"state": whole, "opt": {"m": {"w": torch.from_numpy(big)}}}
        CheckpointManager(f"{out}/port", use_async=False, device="cpu").save(3, tree, extra={"mesh": "2x4"})
        np.savez(f"{out}/state.npz", **{p: t.numpy() for p, t in tree_util.flatten_with_path(tree)[0]})
    dist.barrier()
    dist.destroy_process_group()
""")

_REF_RESTORE = textwrap.dedent(r"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P
    import repro.configs as configs
    from repro.ft import CheckpointManager
    from repro.ft import elastic
    from repro.optim import AdamWConfig
    from repro.parallel import ParallelPlan
    from repro.train.step import state_specs
    out = sys.argv[1]

    def nest(flat):
        tree = {}
        for path, v in flat.items():
            node = tree
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = v
        return tree

    data = np.load(f"{out}/state.npz")
    flat = {k: data[k] for k in data.files}
    CheckpointManager(f"{out}/ref", use_async=False).save(3, nest(flat), extra={"mesh": "2x4"})
    cfg = configs.get_smoke("qwen1.5-0.5b")
    tpl = nest({k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in flat.items()})
    res = {}
    for mname, shape in (("2x2", (2, 2)), ("4x1", (4, 1))):
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("data", "model"))
        plan = elastic.replan(cfg, ParallelPlan(batch_axes=("data",), fsdp_axes=("data",)), mesh)
        specs = {"state": state_specs(tpl["state"], cfg, plan, AdamWConfig()),
                 "opt": {"m": {"w": P(("data", "model"), None)}}}
        for writer in ("port", "ref"):
            _, extra, rep = elastic.restore_resharded(CheckpointManager(f"{out}/{writer}"), tpl, specs, mesh, 3)
            res[f"{mname}|{writer}"] = {"modes": {p: f.mode for p, f in rep.leaves.items()}, "extra": extra}
    json.dump(res, open(f"{out}/ref_modes.json", "w"))
""")

_RESTORE = _COMMON + textwrap.dedent(r"""
    from repro_torch.ft.elastic import make_elastic_mesh, replan, reshard_state, restore_resharded
    from repro_torch.parallel import specs as sp
    from repro_torch.train.step import state_specs
    params = models.init_params(0, cfg, ParallelPlan(), device="meta").tree()
    template = {"state": {"params": params, "opt": adamw.init_state(params, opt)},
                "opt": {"m": {"w": torch.empty(BIG, dtype=torch.float32, device="meta")}}}

    def bits(t):
        return t.detach().reshape(-1).contiguous().view(torch.uint8)

    res = {}
    for mname, prefer in (("2x2", 2), ("4x1", 1)):
        mesh = make_elastic_mesh(prefer_model=prefer, device="cpu")
        plan = replan(cfg, ParallelPlan(batch_axes=("data",), fsdp_axes=("data",)), mesh)
        specs = {"state": state_specs(template["state"], cfg, plan, opt), "opt": {"m": {"w": BIG_SPEC}}}
        for writer in ("port", "ref"):
            mgr = CheckpointManager(f"{out}/{writer}", device="cpu")
            got, extra, rep = restore_resharded(mgr, template, specs, plan)
            host, _ = mgr.restore(template)
            placed = reshard_state(host, specs, plan)
            leaves = {}
            for (path, g), (_, h), (_, r) in zip(tree_util.flatten_with_path(got)[0],
                                                 tree_util.flatten_with_path(host)[0],
                                                 tree_util.flatten_with_path(placed)[0]):
                spec = sp.spec_at(specs, path)
                want = sp.shard_local(h, spec, plan)
                f = rep.leaves[path]
                leaves[path] = {
                    "mode": f.mode, "bytes_read": f.bytes_read, "bytes_full": f.bytes_full,
                    "equal": bool(g.to_local().dtype == want.dtype and g.to_local().shape == want.shape
                                  and torch.equal(bits(g.to_local()), bits(want))),
                    "placed": bool(list(g.placements) == plan.placements(spec) and tuple(g.shape) == tuple(h.shape)),
                    "reshard_state_equal": bool(torch.equal(bits(r.to_local()), bits(want))),
                }
            res[f"{mname}|{writer}"] = {"mesh": list(mesh.shape), "coord": mesh.get_coordinate(), "leaves": leaves,
                                        "extra": extra, "summary": rep.summary()}
    json.dump(res, open(f"{out}/restore{rank}.json", "w"))
    dist.barrier()
    dist.destroy_process_group()
""")

_MESH = textwrap.dedent(r"""
    import json, os, sys
    import torch
    import torch.distributed as dist
    from repro_torch.ft.elastic import make_elastic_mesh
    torch.set_num_threads(1)
    out, rank = sys.argv[1], int(os.environ["RANK"])
    res = {}
    full = make_elastic_mesh(prefer_model=2, device="cpu")
    x = torch.ones(1)
    dist.all_reduce(x, group=full.get_group("data"))  # the mesh's groups work
    res["full"] = {"shape": list(full.shape), "coord": full.get_coordinate(), "data_sum": float(x)}
    part = make_elastic_mesh(4, prefer_model=2, device="cpu")
    res["four"] = None if part is None else {"shape": list(part.shape), "coord": part.get_coordinate()}
    json.dump(res, open(f"{out}/mesh{rank}.json", "w"))
    dist.barrier()
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group and reference subprocess of the file, started as early
    as their inputs allow; the results' directory."""
    out = tmp_path_factory.mktemp("elastic")
    scripts = {}
    for name, src in (("ref_plans", _REF_PLANS), ("port_plans", _PORT_PLANS), ("save", _SAVE),
                      ("ref_restore", _REF_RESTORE), ("restore", _RESTORE), ("mesh", _MESH)):
        scripts[name] = out / f"{name}.py"
        scripts[name].write_text(src)
    plans = [_spawn(scripts["port_plans"], [out / "port_plans.json"])]
    if HAVE_JAX:
        plans.append(_spawn(scripts["ref_plans"], [out / "ref_plans.json"]))
    mesh = _spawn_group(6, scripts["mesh"], [out])
    _wait(_spawn_group(8, scripts["save"], [out]), "the 8-rank save")
    _wait([_spawn(scripts["ref_restore"], [out])] if HAVE_JAX else [], "the reference's save and restore")
    _wait(_spawn_group(4, scripts["restore"], [out]), "the 4-rank restore")
    _wait(mesh, "the 6-rank mesh")
    _wait(plans, "the plans")
    return out


def _restored(runs, rank: int, key: str) -> dict:
    return json.loads((runs / f"restore{rank}.json").read_text())[key]


# ---------------------------------------------------------------------------
# mesh shapes and plans
# ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("prefer", [1, 2, 4, 8, 16])
def test_best_mesh_shape_equals_the_reference(prefer):
    for n in range(1, 601):
        assert te.best_mesh_shape(n, prefer) == re_.best_mesh_shape(n, prefer), n


def test_best_mesh_shape_cases():
    # tests/test_ft.py::test_elastic_replan_and_divisibility
    assert te.best_mesh_shape(512, 16) == (32, 16)
    assert te.best_mesh_shape(256, 16) == (16, 16)
    assert te.best_mesh_shape(240, 16) == (15, 16)
    d, m = te.best_mesh_shape(12, 16)
    assert d * m <= 12
    assert te.best_mesh_shape(6, 2) == (3, 2)


def test_validate_divisibility_on_one_device():
    checks = te.validate_divisibility(t_configs.get("granite-3-8b"), ParallelPlan())
    assert checks == {"d_ff % tp": True, "padded_vocab % tp": True, "d_model % fsdp": True}


def test_ft_exports_the_references_names():
    import repro_torch.ft as ft

    for name in ("make_elastic_mesh", "replan", "reshard_state", "validate_divisibility"):
        assert getattr(ft, name) is getattr(te, name)
    assert "not ported" not in (ft.__doc__ or "")


@needs_reference
@pytest.mark.parametrize("arch", list(t_configs.ARCHS))
def test_validate_divisibility_and_replan_equal_the_reference(runs, arch):
    port = json.loads((runs / "port_plans.json").read_text())
    ref = json.loads((runs / "ref_plans.json").read_text())
    assert port["survivors"] == ref["survivors"] == [15, 16]
    keys = [k for k in ref if k.startswith(f"{arch}|")]
    assert len(keys) == 2 * len(t_configs.SHAPES)
    for key in keys:
        assert port[key] == ref[key], key


# ---------------------------------------------------------------------------
# ChunkRangeReader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blobs():
    """The big moment's container as each package's ``encode_leaf`` writes it."""
    big = big_moment()
    out = {"port": tck.encode_leaf(torch.from_numpy(big.copy()), tck.LeafPolicy("lossy", 1e-4), workers=1)}
    if HAVE_JAX:
        out["ref"] = rck.encode_leaf(big, rck.LeafPolicy("lossy", 1e-4))
    return out


def _row_ranges(starts):
    n = starts[-1]
    edge = starts[1]
    fixed = [(0, 0), (5, 5), (n, n), (0, 1), (n - 1, n), (edge - 1, edge), (edge, edge + 1), (edge - 1, edge + 1),
             (starts[1], starts[2]), (starts[1], starts[3]), (0, n)]
    rng = np.random.default_rng(11)
    rand = [tuple(sorted(int(v) for v in rng.integers(0, n + 1, 2))) for _ in range(6)]
    return fixed + rand


@needs_reference
@pytest.mark.parametrize("writer", WRITERS)
def test_chunk_range_reader_rows_equal_the_reference(blobs, writer):
    blob, meta = blobs[writer]
    assert meta["codec"] == "sz3_auto_rel"
    ours = te.ChunkRangeReader(blob, device="cpu")
    theirs = re_.ChunkRangeReader(blob)
    assert ours.row_starts == theirs.row_starts and len(ours.row_starts) == 5
    for r0, r1 in _row_ranges(ours.row_starts):
        got, want = ours.rows(r0, r1), theirs.rows(r0, r1)
        assert tuple(got.shape) == want.shape, (r0, r1)
        if want.size:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want.astype(np.float32).view(np.uint32))
        assert ours.bytes_read == theirs.bytes_read, (r0, r1)


def test_chunk_range_reader_memo_bounds_and_accounting(blobs):
    blob, _ = blobs["port"]
    r = te.ChunkRangeReader(blob, device="cpu")
    assert r.bytes_read == r.index.body_off
    first = r.rows(0, 10)
    after = r.bytes_read
    assert after == r.index.body_off + r.index.bounds[0][1]
    assert torch.equal(r.rows(3, 7), first[3:7]) and r.bytes_read == after  # memoized: no second decode
    with pytest.raises(IndexError):
        r.rows(5, 4)
    with pytest.raises(IndexError):
        r.rows(0, r.n_rows + 1)


def test_restore_leaf_resharded_without_a_mesh(blobs):
    blob, meta = blobs["port"]
    whole = tck.decode_leaf(blob, meta, device="cpu")
    got, fetch = te.restore_leaf_resharded(blob, meta, ParallelPlan(), (), device="cpu")
    index = te.ChunkRangeReader(blob, device="cpu").index
    assert fetch.mode == "chunk-range" and fetch.bytes_full == len(blob)
    assert fetch.bytes_read == index.body_off + sum(ln for _, ln in index.bounds)  # all but the trailer
    assert torch.equal(got, whole)


def test_restore_leaf_resharded_takes_the_full_path_off_a_chunked_container():
    x = torch.from_numpy(big_moment()[:64])
    blob, meta = tck.encode_leaf(x, tck.LeafPolicy("lossy", 1e-4))
    assert meta["codec"] == "sz3_lorenzo_rel"
    # a manifest that claims a chunked codec for a one-shot container
    got, fetch = te.restore_leaf_resharded(blob, {**meta, "codec": "sz3_auto_rel"}, ParallelPlan(), (), device="cpu")
    assert fetch.mode == "full" and torch.equal(got, tck.decode_leaf(blob, meta, device="cpu"))


def test_a_damaged_chunk_fails_the_resharded_restore(blobs):
    from repro_torch.core import faults
    from repro_torch.core.integrity import IntegrityError

    blob, meta = blobs["port"]
    bad = faults.corrupt_chunk(blob, 2)
    reader = te.ChunkRangeReader(bad, device="cpu")
    reader.rows(0, reader.row_starts[1])  # an undamaged chunk decodes
    with pytest.raises(IntegrityError):
        te.restore_leaf_resharded(bad, meta, ParallelPlan(), (), device="cpu")


# ---------------------------------------------------------------------------
# the elastic restart across gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("writer", WRITERS)
def test_restore_resharded_equals_restore_plus_shard_local(runs, mesh, writer):
    if writer == "ref" and not HAVE_JAX:
        pytest.skip("the reference's checkpoint needs the JAX package")
    coords = set()
    for rank in range(4):
        res = _restored(runs, rank, f"{mesh}|{writer}")
        assert res["mesh"] == ([2, 2] if mesh == "2x2" else [4, 1])
        coords.add(tuple(res["coord"]))
        assert res["extra"] == {"mesh": "2x4"}
        assert "opt/m/w" in res["leaves"] and len(res["leaves"]) > 20
        for path, leaf in res["leaves"].items():
            assert leaf["equal"] and leaf["placed"] and leaf["reshard_state_equal"], (rank, path, leaf)
    assert len(coords) == 4


@needs_reference
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("writer", WRITERS)
def test_leaf_modes_equal_the_reference(runs, mesh, writer):
    ref = json.loads((runs / "ref_modes.json").read_text())[f"{mesh}|{writer}"]
    assert ref["extra"] == {"mesh": "2x4"}
    for rank in range(4):
        ours = {p: f["mode"] for p, f in _restored(runs, rank, f"{mesh}|{writer}")["leaves"].items()}
        assert ours == ref["modes"]
    assert ref["modes"]["opt/m/w"] == "chunk-range"
    assert "full" in ref["modes"].values()


@pytest.mark.parametrize("mesh", MESHES)
def test_a_dim0_sharded_chunked_leaf_reads_its_quarter(runs, mesh):
    for rank in range(4):
        f = _restored(runs, rank, f"{mesh}|port")["leaves"]["opt/m/w"]
        assert f["mode"] == "chunk-range"
        assert f["bytes_read"] < QUARTER_READ_MAX * f["bytes_full"], (rank, f)


def test_make_elastic_mesh_on_six_ranks(runs):
    for rank in range(6):
        res = json.loads((runs / f"mesh{rank}.json").read_text())
        assert res["full"] == {"shape": [3, 2], "coord": [rank // 2, rank % 2], "data_sum": 3.0}
        if rank < 4:
            assert res["four"] == {"shape": [2, 2], "coord": [rank // 2, rank % 2]}
        else:
            assert res["four"] is None  # a rank beyond the mesh sits out


def test_restore_resharded_holds_each_leaf_to_its_checksum(tmp_path):
    from repro_torch.core.integrity import IntegrityError
    from repro_torch.ft import CheckpointManager

    state = {"params": {"w": torch.arange(4096, dtype=torch.float32)},
             "opt": {"m": {"w": torch.from_numpy(big_moment())}}}
    mgr = CheckpointManager(str(tmp_path), use_async=False, device="cpu")
    mgr.save(1, state)
    template = {"params": {"w": torch.empty(4096, device="meta")},
                "opt": {"m": {"w": torch.empty(BIG_SHAPE, device="meta")}}}
    got, extra, rep = te.restore_resharded(mgr, template, {}, ParallelPlan())
    assert rep.leaves["opt/m/w"].mode == "chunk-range" and rep.leaves["params/w"].mode == "full"
    assert torch.equal(got["params"]["w"], state["params"]["w"]) and extra == {}
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    leaf = tmp_path / "step_1" / manifest["leaves"]["params/w"]["file"]
    raw = bytearray(leaf.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IntegrityError):
        te.restore_resharded(mgr, template, {}, ParallelPlan())
