"""The port's train launcher (``repro_torch.launch.train``), its mesh
(``repro_torch.launch.mesh``) and the train state's checkpoints, held
against the JAX package's on the CPU.

* ``main()`` prints the reference's lines, and each launcher resumes from
  the other's checkpoint directory: the step after the resume has the
  loss the other package printed for it (params are lossless, and the loss
  is taken before the update), within the printed 1e-4;
* checkpoints of a train state cross both ways: each package restores the
  other's checkpoint to the bits its own restore gives; with compressed
  moments (``codes``, ``scale``, ``tags`` and ``base`` under the moment's
  path) the reference restores the port's, and cannot save its own (its
  fault, ROADMAP.md queue 3);
* resume through the launcher is bit for bit under a lossless policy, and
  within each lossy leaf's bound under the default one;
  ``tests/test_ft.py::test_train_resume_deterministic`` through the port;
* two ``gloo`` ranks (``--mesh data=2``, spawned with the ``torchrun``
  environment): the uncompressed step equals the one-process step on the
  whole batch (losses within 2e-6 relative, parameters within 1e-6: the
  mean of the two ranks' gradients rounds differently from one gradient of
  the whole batch), a resumed compressed run (the ranks' feedback shards
  gathered into the checkpoint and split again) equals the uninterrupted
  one bit for bit, and the int8-compressed 20-step loss trajectory stays
  within 0.05 of the uncompressed one
  (``tests/test_distributed.py::test_compressed_trajectory_matches_uncompressed``).

The launcher's path on the card is ``chip_smoke.py``'s ``train`` phase.
"""
import json
import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as t_configs
from repro_torch import tree as tree_util
from repro_torch.data import make_pipeline
from repro_torch.ft import CheckpointManager, CheckpointPolicy, LeafPolicy
from repro_torch.launch import train as t_train
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.parallel import ParallelPlan as TPlan
from repro_torch.train.step import init_train_state as t_init_train_state
from repro_torch.train.step import make_train_step as t_make_train_step

try:  # the differential tests need the JAX package
    import jax
    import jax.numpy as jnp

    import repro.configs as r_configs
    from repro.ft import CheckpointManager as RManager
    from repro.launch import train as r_train
    from repro.optim import AdamWConfig as RAdamW
    from repro.parallel import ParallelPlan as RPlan
    from repro.train.step import init_train_state as r_init_train_state
    from repro.train.step import make_train_step as r_make_train_step
except ImportError:  # pragma: no cover - a machine without JAX
    jax = None

needs_reference = pytest.mark.skipif(jax is None, reason="the JAX package is not importable")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are tiny: on one thread they run as fast as on
    many, and they do not fight the suite's parallel workers for cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
SRC = Path(__file__).resolve().parents[1] / "src"
CPU = "cpu"
LOSSLESS = CheckpointPolicy(rules=(("", LeafPolicy("lossless")),))
PRINTED = 1e-4  # the launchers print losses to 4 decimals


def _losses(out):
    return {int(k): float(v) for k, v in re.findall(r"step +(\d+) loss=([0-9.]+)", out)}


def _shape(out):
    """The printed lines with every number replaced."""
    return [re.sub(r"[0-9][0-9,.]*", "#", line) for line in out.strip().splitlines()]


def _ref_main(argv, capsys):
    saved = sys.argv
    sys.argv = ["train"] + argv
    try:
        r_train.main()
    finally:
        sys.argv = saved
    return capsys.readouterr().out


def _port_main(argv, capsys):
    t_train.main(argv + ["--device", CPU])
    return capsys.readouterr().out


@needs_reference
def test_main_prints_the_reference_lines_and_resumes_its_checkpoints(tmp_path, capsys):
    flags = ["--steps", "3", "--ckpt-every", "2"]
    ref = _ref_main(flags + ["--ckpt-dir", str(tmp_path / "r")], capsys)
    port = _port_main(flags + ["--ckpt-dir", str(tmp_path / "p")], capsys)
    assert _shape(port) == _shape(ref)
    assert port.splitlines()[0] == ref.splitlines()[0] == "arch=qwen1.5-smoke family=dense ~0M params"
    assert port.strip().endswith("done; checkpoints: [2]")
    # each resumes the other's step-2 checkpoint: step 2's loss is the other's
    port_on_ref = _port_main(flags + ["--ckpt-dir", str(tmp_path / "r")], capsys)
    ref_on_port = _ref_main(flags + ["--ckpt-dir", str(tmp_path / "p")], capsys)
    for out, other in ((port_on_ref, ref), (ref_on_port, port)):
        assert "resumed at step 2" in out
        assert abs(_losses(out)[2] - _losses(other)[2]) <= PRINTED, (out, other)


@needs_reference
@pytest.mark.parametrize("moments", ["plain", "compressed"])
def test_train_state_checkpoints_cross_both_ways(tmp_path, moments):
    opt_kw = {"compress_moments": True, "moment_policy": "int8:bs=256"} if moments == "compressed" else {}
    arch = "qwen1.5-0.5b"
    rcfg, tcfg = r_configs.get_smoke(arch), t_configs.get_smoke(arch)
    ropt, topt = RAdamW(lr=3e-2, **opt_kw), TAdamW(lr=3e-2, **opt_kw)
    plan = RPlan()
    rstate = jax.jit(lambda key: r_init_train_state(key, rcfg, plan, ropt))(jax.random.PRNGKey(0))
    # the reference cannot save compressed moments (below), so there its
    # state is only the template it restores into, and takes no step
    rstep = jax.jit(r_make_train_step(rcfg, plan, ropt, total_steps=20)) if moments == "plain" else None
    tstate = t_init_train_state(1, tcfg, TPlan(), topt, device=CPU)
    tstep = t_make_train_step(tcfg, TPlan(), topt, total_steps=20)
    pipe = make_pipeline(tcfg, seq=32, global_batch=4)
    for k in range(2):  # moments away from zero
        b = pipe.batch_at(k)
        if rstep is not None:
            rstate, _ = rstep(rstate, {x: jnp.asarray(v) for x, v in b.items()})
        tstate, _ = tstep(tstate, {x: torch.from_numpy(v) for x, v in b.items()})
    r_host = jax.tree.map(np.asarray, jax.device_get(rstate))
    CheckpointManager(tmp_path / "p", use_async=False, device=CPU).save(2, tstate)
    dirs = [tmp_path / "p"]
    if moments == "compressed":
        # the reference's fault (ROADMAP.md queue 3): its manifest's treedef
        # proto cannot hold the registered Compressed dataclass, so it cannot
        # save a state with compressed moments; the port writes ``null`` there
        with pytest.raises(ValueError, match="User-defined nodes"):
            RManager(tmp_path / "r", use_async=False).save(2, r_host)
    else:
        RManager(tmp_path / "r", use_async=False).save(2, r_host)
        names = lambda d: sorted(p.name for p in (d / "step_2").iterdir())
        assert names(tmp_path / "r") == names(tmp_path / "p")  # same leaf files, by path
        dirs.append(tmp_path / "r")
    for d in dirs:
        r_got, _ = RManager(d, use_async=False).restore(r_host)
        t_got, _ = CheckpointManager(d, use_async=False, device=CPU).restore(tstate)
        r_leaves = jax.tree_util.tree_flatten_with_path(r_got)[0]
        t_leaves = tree_util.flatten_with_path(t_got)[0]
        assert [p for p, _ in t_leaves] == [r_train_path(p) for p, _ in r_leaves]
        for (_, a), (path, t) in zip(r_leaves, t_leaves):
            a = np.asarray(a)
            assert t.dtype == torch.from_numpy(np.empty(0, a.dtype)).dtype, path
            assert np.array_equal(t.numpy(), a), path  # both decode the same bits
    restored, _ = CheckpointManager(tmp_path / "p", use_async=False, device=CPU).restore(tstate)
    if moments == "compressed":
        m = tree_util.flatten(restored["opt"]["m"])[0][0]
        assert type(m).__name__ == "Compressed" and m.orig_last == tree_util.flatten(tstate["opt"]["m"])[0][0].orig_last


def r_train_path(path):
    from repro.ft.checkpoint import _path_str

    return _path_str(path)


def _train(tmp, steps, policy=LOSSLESS, seq=32, **kw):
    cfg = t_configs.get_smoke("qwen1.5-0.5b")
    return t_train.train(cfg, TPlan(), TAdamW(lr=3e-3), steps=steps, seq=seq, batch=4, ckpt_dir=str(tmp),
                         ckpt_every=2, ckpt_policy=policy, device=CPU, **kw)


def test_resume_through_the_launcher_is_bit_exact(tmp_path):
    whole = _train(tmp_path / "a", 4)
    first = _train(tmp_path / "b", 2)
    resumed = _train(tmp_path / "b", 4)
    assert (whole.start, first.start, resumed.start) == (0, 0, 2)
    assert resumed.losses == whole.losses[2:] and resumed.checkpoints == [2, 4]
    for a, b in zip(tree_util.flatten_with_path(whole.state)[0], tree_util.flatten_with_path(resumed.state)[0]):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    assert len(whole.step_seconds) == 4 and whole.tokens_per_step == 4 * 32


def test_resume_under_the_default_policy_keeps_each_bound(tmp_path):
    import repro_torch.core as tc

    first = _train(tmp_path, 2, policy=CheckpointPolicy())
    saved = tree_util.tree_map(lambda t: t.clone(), first.state)
    resumed = _train(tmp_path, 2, policy=CheckpointPolicy(), state=first.state)  # nothing left to run
    assert resumed.start == 2 and resumed.losses == []
    manifest = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    for (path, want), (_, got) in zip(tree_util.flatten_with_path(saved)[0],
                                      tree_util.flatten_with_path(resumed.state)[0]):
        meta = manifest["leaves"][path]
        if meta["codec"].startswith("sz3_"):
            blob = (tmp_path / "step_2" / meta["file"]).read_bytes()
            bound = tc.parse_header(blob)[0]["abs_eb"]
            assert float((got.double() - want.double()).abs().max()) <= bound, path
        else:
            assert torch.equal(got, want), path


def test_train_resume_deterministic(tmp_path):
    """save at step k, restore, and the (k+1)th step matches bit-for-bit
    (lossless params + deterministic data pipeline)."""
    cfg = t_configs.get_smoke("qwen1.5-0.5b")
    opt = TAdamW(lr=1e-3)
    plan = TPlan()
    state = t_init_train_state(0, cfg, plan, opt, device=CPU)
    step = t_make_train_step(cfg, plan, opt)
    pipe = make_pipeline(cfg, seq=16, global_batch=2)
    mgr = CheckpointManager(tmp_path, policy=LOSSLESS, use_async=False, device=CPU)

    def batch(k):
        return {k2: torch.from_numpy(v) for k2, v in pipe.batch_at(k).items()}

    for k in range(2):
        state, _ = step(state, batch(k))
    mgr.save(2, state)
    template = tree_util.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    state_a, _ = step(state, batch(2))  # in place: state is state_a now
    restored, _ = mgr.restore(template)
    state_b, _ = step(restored, batch(2))
    for a, b in zip(tree_util.flatten(state_a["params"])[0], tree_util.flatten(state_b["params"])[0]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# two ranks on a gloo group
# ---------------------------------------------------------------------------

_DP2_WORKER = textwrap.dedent(r"""
    import json, sys
    import torch
    from repro_torch import configs, tree as tree_util
    from repro_torch.data import make_pipeline
    from repro_torch.ft import CheckpointPolicy, LeafPolicy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import train
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import ParallelPlan
    from repro_torch.train.step import init_train_state, make_train_step

    out = sys.argv[1]
    mesh = make_debug_mesh((2,), ("data",), device="cpu")
    rank = torch.distributed.get_rank()
    cfg = configs.get_smoke("qwen1.5-0.5b")
    lossless = CheckpointPolicy(rules=(("", LeafPolicy("lossless")),))
    plain, comp = ParallelPlan(mesh=mesh), ParallelPlan(mesh=mesh, grad_policy="int8:bs=512")
    assert (plain.dp, plain.dp_rank) == (2, rank)

    # the launcher's body: 3 plain steps; 4 compressed, and 3 + a resumed 1
    kw = dict(seq=16, batch=4, ckpt_every=3, ckpt_policy=lossless, device="cpu")
    opt = AdamWConfig(lr=3e-3)
    base = train(cfg, plain, opt, steps=3, ckpt_dir=out + "/base", **kw)
    whole = train(cfg, comp, opt, steps=4, ckpt_dir=out + "/whole", **kw)
    train(cfg, comp, opt, steps=3, ckpt_dir=out + "/split", **kw)
    resumed = train(cfg, comp, opt, steps=4, ckpt_dir=out + "/split", **kw)

    # tests/test_distributed.py's trajectory contract
    opt = AdamWConfig(lr=1e-3, weight_decay=0.0)
    pipe = make_pipeline(cfg, seq=16, global_batch=4)
    def run(plan):
        state = init_train_state(0, cfg, plan, opt, device="cpu")
        step = make_train_step(cfg, plan, opt, total_steps=20)
        losses = []
        for k in range(20):
            b = {x: torch.from_numpy(v[2 * rank : 2 * rank + 2]) for x, v in pipe.batch_at(k % 4).items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return losses

    # on a mesh the state's leaves are DTensors: each rank compares its pieces
    def pieces(state):
        return [t.to_local() for t in tree_util.flatten(state["params"])[0] + [state["feedback"]]]

    result = {
        "base_losses": base.losses, "whole_losses": whole.losses, "resumed_start": resumed.start,
        "resumed_losses": resumed.losses, "traj_base": run(plain), "traj_comp": run(comp),
        "same_resumed_state": all(torch.equal(a, b) for a, b in zip(pieces(whole.state), pieces(resumed.state))),
    }
    torch.save({k: v.to_local() for k, v in tree_util.flatten_with_path(base.state["params"])[0]},
               f"{out}/params{rank}.pt")
    with open(f"{out}/result{rank}.json", "w") as f:
        json.dump(result, f)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_one_process_and_keep_the_compressed_trajectory(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_DP2_WORKER)
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1", "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
        procs.append(subprocess.Popen([sys.executable, str(script), str(tmp_path)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    results = [json.loads((tmp_path / f"result{r}.json").read_text()) for r in range(2)]
    assert results[0] == results[1]  # every rank sees the group's mean loss and the same state
    res = results[0]

    # data parallel = one process on the whole batch
    one = _train(tmp_path / "one", 3, seq=16)
    np.testing.assert_allclose(res["base_losses"], one.losses, rtol=2e-6)
    for r in range(2):
        params = torch.load(tmp_path / f"params{r}.pt")
        for path, t in tree_util.flatten_with_path(one.state["params"])[0]:
            assert float((params[path] - t).abs().max()) <= 1e-6, path

    # a compressed run resumed from its checkpoint (feedback gathered, then split)
    assert res["resumed_start"] == 3 and res["resumed_losses"] == res["whole_losses"][3:]
    assert res["same_resumed_state"]
    assert (tmp_path / "split" / "step_3").exists()
    manifest = json.loads((tmp_path / "split" / "step_3" / "manifest.json").read_text())
    n = sum(np.prod(m["shape"]) for p, m in manifest["leaves"].items() if p.startswith("params/"))
    assert manifest["leaves"]["feedback"]["shape"] == [n + n % 2]  # the reference's one padded vector

    base, comp = res["traj_base"], res["traj_comp"]
    worst = max(abs(a - b) for a, b in zip(base, comp))
    assert len(base) == 20 and worst < 0.05, (base, comp)
    assert base[-1] < base[0] - 0.2 and comp[-1] < comp[0] - 0.2


# ---------------------------------------------------------------------------
# the plans' tables, and the mesh
# ---------------------------------------------------------------------------

@needs_reference
def test_plan_tables_equal_the_references():
    from repro.launch import plans as r_plans

    from repro_torch.launch import plans as t_plans

    for name in ("TRAIN_MICROBATCHES", "SEQ_SHARD_TRAIN", "COMPRESS_MOMENTS", "KV_INT8_DECODE"):
        assert getattr(t_plans, name) == getattr(r_plans, name), name


def test_a_mesh_needs_its_processes():
    code = ("from repro_torch.launch.mesh import make_debug_mesh\n"
            "try:\n    make_debug_mesh((2,), ('data',), device='cpu')\n"
            "except RuntimeError as e:\n    assert 'torchrun' in str(e), e\n    print('refused')\n")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={**env, "PYTHONPATH": str(SRC)})
    assert res.returncode == 0 and "refused" in res.stdout, res.stderr
