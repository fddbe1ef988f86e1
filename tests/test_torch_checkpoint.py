"""The port's checkpoint manager and heartbeat monitor (``repro_torch.ft``)
held to the model-free contracts of ``tests/test_ft.py`` and against the
JAX package's ``repro.ft``, on the CPU.

* contracts: lossless params round-trip bit for bit, lossy moments restore
  within their bound, async saves and GC, atomic renames, corruption
  detected; the heartbeat policy flags stragglers and dead hosts, and logs
  and counts them through the port's telemetry;
* an async save snapshots the state before it returns: ``add_`` in place
  after ``save()`` does not reach the checkpoint;
* checkpoints cross both ways: for the reference's smoke ``init_train_state``
  and for a bf16 tree, every leaf file is byte-identical, the manifests are
  equal except ``treedef`` (``null`` from the port) and the ``seconds``
  fields, and each package restores the other's checkpoint to the bits its
  own restore gives; the reference restores a bf16 leaf as a void ``|V2``
  array (its fault, logged in ROADMAP queue 3), the port as bfloat16;
* a thin ``sz3_lr`` leaf (a 4 MiB leaf of two rows whose 1-row chunk picks
  ``sz3_lr``): the one difference, the reference's known fault — it cannot
  decode the bytes it writes itself, while the port decodes both packages'
  bytes;
* leaf paths equal the reference's ``_path_str`` over JAX's
  ``tree_flatten_with_path``; placement follows the template (meta-device
  leaves go to the manager's device).

The ``cuda``-marked test saves and restores on the card
(``python -m pytest -q -m cuda tests/test_torch_checkpoint.py``).
"""
import collections
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.core import CompressionConfig, ErrorBoundMode, parse_header, sz3_lorenzo
from repro_torch.core import telemetry
from repro_torch.ft import CheckpointManager, CheckpointPolicy, Decision, HeartbeatMonitor, LeafPolicy
from repro_torch.ft import checkpoint as t_ck

try:  # the differential tests need the JAX package
    import jax
    import jax.numpy as jnp

    import repro.configs as configs
    import repro.core as rc
    from repro.ft import checkpoint as r_ck
    from repro.optim import AdamWConfig
    from repro.parallel import ParallelPlan
    from repro.train.step import init_train_state
except ImportError:  # pragma: no cover - a machine without JAX
    jax = None

CPU = "cpu"
needs_reference = pytest.mark.skipif(jax is None, reason="the JAX package is not importable")


def _mgr(path, **kw):
    return CheckpointManager(path, device=CPU, **{"use_async": False, **kw})


def _port_state(seed=0, param_dtype=torch.float32):
    """A train state laid out as the reference's ``init_train_state`` lays
    out Qwen1.5-0.5B's smoke config (2 layers, d 128, ff 256, vocab 512)."""
    g = torch.Generator().manual_seed(seed)
    L, d, ff, V = 2, 128, 256, 512

    def params(scale):
        def leaf(*shape):
            return (torch.randn(shape, generator=g) * scale).to(param_dtype)

        return {
            "embed": leaf(V, d),
            "final_norm": {"w": leaf(d)},
            "blocks": {
                "ln1": {"w": leaf(L, d)}, "ln2": {"w": leaf(L, d)},
                "attn": {"wq": leaf(L, d, d), "wk": leaf(L, d, d), "wv": leaf(L, d, d), "wo": leaf(L, d, d),
                         "bq": leaf(L, d), "bk": leaf(L, d), "bv": leaf(L, d)},
                "mlp": {"w1": leaf(L, d, ff), "w3": leaf(L, d, ff), "w2": leaf(L, ff, d)},
            },
        }

    p = params(0.02)
    m = tree_util.tree_map(lambda t: torch.cumsum(torch.randn(t.shape, generator=g), -1) * 1e-3, p)
    v = tree_util.tree_map(lambda t: torch.zeros(t.shape), p)
    return {"params": p, "opt": {"m": m, "v": v, "step": torch.tensor(3, dtype=torch.int32)}}


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _u8(a):
    return np.ascontiguousarray(a).tobytes()


def _leaves(state):
    return tree_util.flatten_with_path(state)[0]


# ---------------------------------------------------------------------------
# the model-free contracts of tests/test_ft.py
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_lossless_params(tmp_path):
    state = _port_state()
    mgr = _mgr(tmp_path)
    mgr.save(7, state)
    restored, _ = mgr.restore(state)
    for a, b in zip(tree_util.flatten(state["params"])[0], tree_util.flatten(restored["params"])[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_lossy_moments_bounded(tmp_path):
    state = _port_state()
    mgr = _mgr(tmp_path)
    manifest = mgr._write(1, state, {})
    restored, _ = mgr.restore(state)
    for a, b in zip(tree_util.flatten(state["opt"]["m"])[0], tree_util.flatten(restored["opt"]["m"])[0]):
        rng = float(a.max() - a.min())
        if a.numel() >= 1024 and rng > 0:
            assert float((a.double() - b.double()).abs().max()) <= 1e-4 * rng * (1 + 1e-6)
        else:
            assert torch.equal(a, b)
    assert manifest["ratio"] > 1.2  # compression actually happened
    assert {m["codec"] for p, m in manifest["leaves"].items() if p.startswith("opt/m/")} >= {"sz3_lorenzo_rel"}


def test_checkpoint_async_and_gc(tmp_path):
    state = _port_state()
    mgr = _mgr(tmp_path, keep=2, use_async=True)
    for s in [1, 2, 3, 4]:
        mgr.save(s, state)
    mgr.wait()
    assert mgr.list_steps() == [3, 4]


def test_checkpoint_atomic_no_partial(tmp_path):
    state = _port_state()
    mgr = _mgr(tmp_path)
    mgr.save(1, state)
    (tmp_path / ".tmp_step_2").mkdir()
    (tmp_path / ".tmp_step_2" / "garbage.bin").write_bytes(b"xx")
    mgr.restore(state)
    assert mgr.list_steps() == [1]


def test_checkpoint_corruption_detected(tmp_path):
    state = _port_state()
    mgr = _mgr(tmp_path)
    mgr.save(1, state)
    victim = next(p for p in (tmp_path / "step_1").glob("*.bin"))
    blob = bytearray(victim.read_bytes())
    if len(blob) > 10:
        blob[5] ^= 0xFF
    victim.write_bytes(bytes(blob))
    with pytest.raises(Exception):
        mgr.restore(state)


def test_heartbeat_straggler_and_death():
    t = [0.0]
    mon = HeartbeatMonitor(["h0", "h1", "h2"], timeout_s=10, straggler_factor=2.0, clock=lambda: t[0])
    for _ in range(6):
        t[0] += 1.0
        mon.beat("h0", 1.0)
        mon.beat("h1", 1.0)
        mon.beat("h2", 3.5)  # slow host
    dec = {d.host: d for d in mon.observe()}
    assert dec["h0"].kind == "ok" and dec["h2"].kind == "straggler"
    t[0] += 20.0
    mon.beat("h0", 1.0)
    mon.beat("h2", 3.5)
    dec = {d.host: d for d in mon.observe()}
    assert dec["h1"].kind == "dead"
    assert set(mon.survivors()) == {"h0", "h2"}
    assert isinstance(dec["h1"], Decision)


def test_heartbeat_logs_and_counts_through_the_ports_telemetry():
    import logging

    records = []

    class H(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    py = logging.getLogger("repro_torch.telemetry.heartbeat")
    h = H()
    py.addHandler(h)
    telemetry.reset_metrics()
    try:
        t = [0.0]
        mon = HeartbeatMonitor(["a", "b"], timeout_s=5, clock=lambda: t[0])
        mon.beat("a", 1.0)
        mon.beat("b", 9.0)
        mon.beat("a", 1.0)
        mon.beat("a", 1.0)
        t[0] = 6.0
        mon.beat("a", 1.0)
        kinds = {d.host: d.kind for d in mon.observe()}
    finally:
        py.removeHandler(h)
    assert kinds == {"a": "ok", "b": "dead"}
    assert records and records[0].startswith("host_dead host=b")
    assert telemetry.METRICS.snapshot()["counters"] == {"sz3_heartbeat_dead_total": 1}
    telemetry.reset_metrics()


# ---------------------------------------------------------------------------
# the port's own guarantees
# ---------------------------------------------------------------------------

def test_async_save_snapshot_survives_in_place_updates(tmp_path):
    state = _port_state(seed=1)
    saved = tree_util.tree_map(lambda t: t.clone(), state)
    mgr = _mgr(tmp_path, use_async=True)
    mgr.save(1, state)
    for _, leaf in _leaves(state):  # what an optimizer step does, in place
        leaf.add_(1)
    mgr.wait()
    restored, _ = mgr.restore(saved)
    for (p, a), b in zip(_leaves(saved), tree_util.flatten(restored)[0]):
        if p.startswith("opt/m/") and a.numel() >= 1024:
            assert float((a - b).abs().max()) <= 1e-4 * float(a.max() - a.min()) * (1 + 1e-6), p
        else:
            assert torch.equal(a, b), p


def test_meta_template_restores_on_the_managers_device(tmp_path):
    state = _port_state()
    mgr = _mgr(tmp_path)
    mgr.save(1, state, extra={"note": "x"})
    meta = tree_util.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    restored, extra = mgr.restore(meta)
    assert extra == {"note": "x"}
    for (p, a), b in zip(_leaves(state), tree_util.flatten(restored)[0]):
        assert b.device.type == "cpu" and b.dtype == a.dtype and b.shape == a.shape, p
        if not p.startswith("opt/m/"):
            assert torch.equal(a, b), p


def test_default_device_is_cuda_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works there")
    mgr = CheckpointManager(tmp_path, use_async=False)
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore({"w": torch.empty(4, device="meta")})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int32,
                                   torch.int64, torch.uint8, torch.bool])
def test_lossless_leaf_round_trips_every_dtype(dtype):
    x = (torch.arange(3 * 700) % 251).reshape(3, 700).to(dtype)
    blob, meta = t_ck.encode_leaf(x, LeafPolicy("lossless"))
    assert meta["dtype"] == ("<V2" if dtype == torch.bfloat16 else torch.empty(0, dtype=dtype).numpy().dtype.str)
    out = t_ck.decode_leaf(blob, meta, device=CPU, like=dtype)
    assert out.dtype == dtype and torch.equal(_bits(out), _bits(x))
    raw_blob, raw_meta = t_ck.encode_leaf(x, LeafPolicy("raw"))
    assert raw_meta["codec"] == "raw" and torch.equal(_bits(t_ck.decode_leaf(raw_blob, raw_meta, CPU, dtype)), _bits(x))


def test_leaf_gate_matches_float32_semantics():
    """Lossy only for float32/float64 leaves of >= 1024 finite elements
    whose ``max - min`` is positive in the leaf's own dtype (an overflow to
    inf still counts)."""
    lossy = LeafPolicy("lossy")
    big = torch.tensor([3e38, -3e38] * 600, dtype=torch.float32)  # max - min overflows
    assert t_ck.encode_leaf(big, lossy)[1]["codec"] == "sz3_lorenzo_rel"
    for leaf in (torch.ones(2048), torch.zeros(1023).uniform_(), torch.full((2048,), float("nan")),
                 torch.ones(2048, dtype=torch.bfloat16)):
        assert t_ck.encode_leaf(leaf, lossy)[1]["codec"].startswith("shuffle_")


# ---------------------------------------------------------------------------
# against the reference: paths, leaf blobs, manifests, restores both ways
# ---------------------------------------------------------------------------

def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _ref_state(param_dtype="float32", seed=0):
    cfg = configs.get_smoke("qwen1.5-0.5b")
    if param_dtype != "float32":
        cfg = dataclasses.replace(cfg, dtype=param_dtype)
    state = init_train_state(jax.random.PRNGKey(seed), cfg, ParallelPlan(), AdamWConfig())
    # realistic smooth moments, as tests/test_ft.py builds them
    state["opt"]["m"] = jax.tree.map(
        lambda p: (jnp.cumsum(jax.random.normal(jax.random.PRNGKey(1), p.shape), -1) * 1e-3).astype(jnp.float32),
        state["params"],
    )
    return jax.tree.map(np.asarray, state)


def _same_checkpoint(rdir, tdir):
    """Leaf files byte-identical; manifests equal except treedef and the
    seconds fields."""
    mr = json.loads((rdir / "manifest.json").read_text())
    mt = json.loads((tdir / "manifest.json").read_text())
    assert mt["treedef"] is None
    for m in (mr, mt):
        m.pop("treedef")
        for leaf in m["leaves"].values():
            leaf.pop("seconds")
    assert mt == mr
    assert list(mt["leaves"]) == list(mr["leaves"])
    for meta in mr["leaves"].values():
        assert (tdir / meta["file"]).read_bytes() == (rdir / meta["file"]).read_bytes()
    return mr


@needs_reference
def test_leaf_paths_equal_the_references():
    NT = collections.namedtuple("NT", "b a")
    t = {"z": [1, (2, 3)], "a": {"y": NT(4, {"q": 5, "p": None}), "x": 6}, "3": 7, "m": NT(None, 8)}
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    assert [(r_ck._path_str(p), leaf) for p, leaf in flat] == tree_util.flatten_with_path(t)[0]
    got, treedef = tree_util.flatten_with_path(t)
    assert tree_util.unflatten(treedef, [leaf for _, leaf in got]) == t
    state = _ref_state()
    ref_paths = [r_ck._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]
    assert [p for p, _ in _leaves(tree_util.tree_map(_to_torch, state))] == ref_paths


@needs_reference
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_checkpoint_crosses_both_ways(tmp_path, param_dtype):
    host = _ref_state(param_dtype)
    state = tree_util.tree_map(_to_torch, host)
    r_ck.CheckpointManager(tmp_path / "r", use_async=False).save(1, host)
    _mgr(tmp_path / "t").save(1, state)
    man = _same_checkpoint(tmp_path / "r" / "step_1", tmp_path / "t" / "step_1")
    if param_dtype == "bfloat16":
        assert man["leaves"]["params/embed"]["dtype"] == "<V2"
    # each package restores the other's checkpoint to its own restore's bits
    r_own, _ = r_ck.CheckpointManager(tmp_path / "r", use_async=False).restore(host)
    r_from_t, _ = r_ck.CheckpointManager(tmp_path / "t", use_async=False).restore(host)
    t_own, _ = _mgr(tmp_path / "t").restore(state)
    t_from_r, _ = _mgr(tmp_path / "r").restore(state)
    for (p, x), a, b, c, d in zip(_leaves(state), tree_util.flatten(t_own)[0], tree_util.flatten(t_from_r)[0],
                                  jax.tree.leaves(r_own), jax.tree.leaves(r_from_t)):
        assert a.dtype == b.dtype == x.dtype, p
        assert torch.equal(_bits(a), _bits(b)), p
        assert _u8(c) == _u8(d) and _u8(_bits(a).numpy()) == _u8(c), p
        if p.startswith("params/") or p == "opt/step":
            assert torch.equal(_bits(a), _bits(x)), p  # lossless: bit for bit
        if x.dtype == torch.bfloat16:
            # the reference's fault: its restore holds void |V2, not bfloat16
            assert np.asarray(c).dtype.kind == "V" and np.asarray(c).dtype.itemsize == 2


def _thin_lr_leaf():
    """A 4 MiB-and-up leaf of two rows: its chunks hold one row each, and
    the first (a noisy ramp) picks ``sz3_lr``."""
    rng = np.random.default_rng(0)
    n = 524292
    return (np.linspace(0, 1, n) + 1e-4 * rng.standard_normal((2, n))).astype(np.float32)


@needs_reference
def test_thin_lr_leaf_is_the_only_difference(tmp_path):
    """The reference writes the port's bytes for a thin ``sz3_lr`` leaf and
    cannot decode them (ROADMAP queue 3); the port restores both packages'
    checkpoints of it within the bound."""
    x = _thin_lr_leaf()
    host = {"opt": {"m": {"w": x}}}
    state = {"opt": {"m": {"w": torch.from_numpy(x.copy())}}}
    r_ck.CheckpointManager(tmp_path / "r", use_async=False, workers=1).save(1, host)
    _mgr(tmp_path / "t", workers=1).save(1, state)
    man = _same_checkpoint(tmp_path / "r" / "step_1", tmp_path / "t" / "step_1")
    blob = (tmp_path / "t" / "step_1" / man["leaves"]["opt/m/w"]["file"]).read_bytes()
    picks = [c["pipeline"] for c in rc.parse_header(blob)[0]["chunks"]]
    assert man["leaves"]["opt/m/w"]["codec"] == "sz3_auto_rel" and picks[0] == "sz3_lr"
    for d in ("r", "t"):
        with pytest.raises(ValueError):
            r_ck.CheckpointManager(tmp_path / d, use_async=False).restore(host)
        got, _ = _mgr(tmp_path / d).restore(state)
        err = float((got["opt"]["m"]["w"].double() - torch.from_numpy(x).double()).abs().max())
        assert err <= 1e-4 * float(x.max() - x.min()) * (1 + 1e-6)


@needs_reference
@pytest.mark.parametrize("mode", ["lossy", "psnr", "raw", "lossless"])
def test_encode_leaf_equals_the_references(mode):
    x = np.cumsum(np.random.default_rng(4).standard_normal((48, 96)), axis=1).astype(np.float32)
    pol_r, pol_t = r_ck.LeafPolicy(mode, 1e-4, 50.0), LeafPolicy(mode, 1e-4, 50.0)
    rblob, rmeta = r_ck.encode_leaf(x, pol_r, workers=1)
    tblob, tmeta = t_ck.encode_leaf(torch.from_numpy(x), pol_t, workers=1)
    assert tblob == rblob and tmeta == rmeta
    assert torch.equal(t_ck.decode_leaf(rblob, rmeta, device=CPU), torch.from_numpy(r_ck.decode_leaf(tblob, tmeta)))


@needs_reference
def test_policy_matches_the_references():
    for path in ("opt/m/embed", "opt/v/blocks/attn/wq", "feedback/x", "params/embed", "opt/step", "optim/m"):
        r, t = r_ck.CheckpointPolicy().for_path(path), CheckpointPolicy().for_path(path)
        assert (t.mode, t.rel_eb, t.target_psnr) == (r.mode, r.rel_eb, r.target_psnr), path


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_checkpoint_saves_and_restores_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state = tree_util.tree_map(lambda t: t.cuda(), _port_state(seed=2, param_dtype=torch.bfloat16))
    big = torch.cumsum(torch.randn(64, 16384, device="cuda"), -1) * 1e-3  # 4 MiB: the chunked contest
    state["opt"]["m"]["big"] = big
    saved = tree_util.tree_map(lambda t: t.clone(), state)
    mgr = CheckpointManager(tmp_path, use_async=True)
    mgr.save(1, state)
    for _, leaf in _leaves(state):
        leaf.add_(1)
    mgr.wait()
    man = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert man["leaves"]["opt/m/big"]["codec"] == "sz3_auto_rel"
    meta = tree_util.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), saved)
    restored, _ = mgr.restore(meta)
    conf = CompressionConfig(mode=ErrorBoundMode.REL, eb=1e-4)
    for (p, a), b in zip(_leaves(saved), tree_util.flatten(restored)[0]):
        assert b.is_cuda and b.dtype == a.dtype, p
        if man["leaves"][p]["codec"].startswith("sz3_"):
            blob = (tmp_path / "step_1" / man["leaves"][p]["file"]).read_bytes()
            assert float((a.double() - b.double()).abs().max()) <= _recorded_abs_eb(blob), p
            if man["leaves"][p]["codec"] == "sz3_lorenzo_rel":
                plain = sz3_lorenzo(route="force", device=CPU).compress(a.reshape(a.shape[0], -1).cpu(), conf).blob
                assert plain == blob, p
        else:
            assert torch.equal(_bits(a), _bits(b)), p


def _recorded_abs_eb(blob):
    """The bound a lossy leaf's container records (its first v1 body's)."""
    header, body_off = parse_header(blob)
    if "chunks" in header:
        c = header["chunks"][0]
        header = parse_header(blob[body_off + c["off"] : body_off + c["off"] + c["len"]])[0]
    return header["abs_eb"]
