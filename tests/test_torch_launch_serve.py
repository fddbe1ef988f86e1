"""The port's serve launcher (``repro_torch.launch.serve``) and serve step
(``repro_torch.serve.step``) held to ``tests/test_serving.py``'s
``TestOffloadAccounting`` and against the JAX package's launcher, on the
CPU.

* accounting: bytes in are charged at the leaf's own dtype (bf16 at 2 B),
  non-float and sub-1024-element leaves are skipped and counted, the
  quality mode with nothing to offload logs no PSNR, and the async service
  keeps the same accounting;
* same cache, same answers: a cache carried from a jitted reference decode
  (bf16 and int8) walks in the reference's leaf order with the reference's
  arrays, and ``offload_cache`` and ``offload_cache_async`` give the
  reference's ``(n_in, n_out)`` (the port's CPU host routes write the
  reference's bytes);
* ``main()`` prints the reference's metric names and log events.

Nothing here needs a card; the launcher's path on the card is
``chip_smoke.py``'s ``serve`` phase.
"""
import contextlib
import logging

import numpy as np
import pytest
import torch

import repro_torch.configs as t_configs
from repro_torch import models as t_models
from repro_torch.core import telemetry
from repro_torch.launch import serve as t_serve
from repro_torch.parallel import ParallelPlan as TPlan
from repro_torch.serve.step import cache_specs, jit_serve_step, make_serve_step

try:  # the differential tests need the JAX package
    import jax
    import jax.numpy as jnp

    import repro.configs as r_configs
    from repro import models as r_models
    from repro.core import telemetry as r_tel
    from repro.launch import serve as r_serve
    from repro.parallel import ParallelPlan as RPlan
except ImportError:  # pragma: no cover - a machine without JAX
    jax = None

needs_reference = pytest.mark.skipif(jax is None, reason="the JAX package is not importable")
CPU = "cpu"


@contextlib.contextmanager
def _captured(caplog, name):
    """caplog's records of a telemetry namespace (its root logger does not
    propagate to the root logger, where caplog listens)."""
    logger = logging.getLogger(name)
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=name):
            yield
    finally:
        logger.removeHandler(caplog.handler)


class TestOffloadAccounting:
    def _cache(self, seed=0):
        rng = np.random.default_rng(seed)
        k = np.cumsum(rng.standard_normal((64, 256)), axis=0)
        return {
            "k_bf16": torch.from_numpy(k).to(torch.bfloat16),
            "v_f32": torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32)),
            "pos_i32": torch.zeros((4,), dtype=torch.int32),  # skipped: not float
            "tiny": torch.zeros((8, 8), dtype=torch.float32),  # skipped: < 1024 elems
        }

    def test_n_in_counts_source_dtype_bytes(self):
        telemetry.reset_metrics()
        n_in, n_out = t_serve.offload_cache(self._cache(), eb=1e-3, chunk_bytes=1 << 14, verify=False, device=CPU)
        # bf16 leaf at 2 B/elem + f32 leaf at 4 B/elem — NOT 4 B for both
        assert n_in == 64 * 256 * 2 + 64 * 256 * 4
        assert n_out > 0
        counters = telemetry.METRICS.snapshot()["counters"]
        assert counters["sz3_offload_leaves_skipped_total"] == 2
        assert counters["sz3_offload_bytes_in_total"] == n_in

    def test_quality_mode_all_skipped_no_inf_psnr(self, caplog):
        telemetry.reset_metrics()
        empty = {"pos": torch.zeros((4,), dtype=torch.int32)}
        with _captured(caplog, "repro_torch.telemetry"):
            n_in, n_out = t_serve.offload_cache(empty, target_psnr=60.0, device=CPU)
        assert (n_in, n_out) == (0, 0)
        text = " ".join(r.getMessage() for r in caplog.records)
        assert "kv_offload mode=quality" in text
        assert "worst_leaf_psnr_db" not in text
        assert "inf" not in text
        counters = telemetry.METRICS.snapshot()["counters"]
        assert counters["sz3_offload_leaves_skipped_total"] == 1

    def test_async_service_offload_matches_accounting(self):
        telemetry.reset_metrics()
        n_in, n_out = t_serve.offload_cache_async(self._cache(), eb=1e-3, chunk_bytes=1 << 14, workers=2,
                                                  device=CPU)
        assert n_in == 64 * 256 * 2 + 64 * 256 * 4
        assert 0 < n_out < n_in


# ---------------------------------------------------------------------------
# a cache carried from the reference's decode
# ---------------------------------------------------------------------------

def _reference_cache(kv, arch="granite-3-8b", batch=4, steps=6):
    """The cache after ``steps`` jitted reference decode steps (granite
    smoke at batch 4: K and V hold 4,608 float32 values each in bf16 mode,
    so both pass the offload's 1024-element floor)."""
    cfg = r_configs.get_smoke(arch)
    plan = RPlan(kv_cache_dtype=kv)
    params = r_models.init_params(jax.random.PRNGKey(0), cfg, plan)
    cache = r_models.init_cache(params, cfg, plan, batch, steps + 3)
    step = jax.jit(lambda p, c, t: r_models.decode_step(p, c, t, cfg, plan))
    tok = jax.random.randint(jax.random.PRNGKey(2), (batch, 1), 0, cfg.vocab)
    for _ in range(steps):
        logits, cache = step(params, cache, tok)
        tok = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
    return cache


@needs_reference
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_leaves_walk_in_the_references_order_with_its_arrays(kv):
    rcache = _reference_cache(kv)
    tcache = t_models.cache_from_numpy(rcache, device=CPU)
    want = list(r_serve._iter_kv_leaves(rcache))
    got = list(t_serve._iter_kv_leaves(tcache))
    assert len(got) == len(want) == (6 if kv == "int8" else 4)  # k, v, [k_scale, v_scale], pos, length
    for (ta, tn, ti), (ra, rn, ri) in zip(got, want):
        assert (tn, ti) == (rn, ri)
        assert (ta is None) == (ra is None)
        if ra is not None:
            assert ta.dtype == torch.float32 and np.array_equal(ta.numpy(), ra)
    assert [tuple(t.shape) for t in tcache.leaves()] == [a.shape for a in jax.tree.leaves(rcache)]


@needs_reference
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_offload_gives_the_references_bytes_in_and_out(kv):
    rcache = _reference_cache(kv, batch=32) if kv == "int8" else _reference_cache(kv)
    tcache = t_models.cache_from_numpy(rcache, device=CPU)
    if kv == "int8":  # 32 sequences: the scales pass the 1024-element floor
        assert tcache.k_scale.numel() >= 1024
    kw = dict(eb=1e-3, chunk_bytes=1 << 13)
    want = r_serve.offload_cache(rcache, **kw)
    got = t_serve.offload_cache(tcache, device=CPU, **kw)
    assert got == want and want[0] > 0
    want = r_serve.offload_cache_async(rcache, workers=2, **kw)
    got = t_serve.offload_cache_async(tcache, workers=2, device=CPU, **kw)
    assert got == want


@needs_reference
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b", "whisper-small"])
def test_ssm_and_encdec_caches_offload_as_the_references(arch):
    """SSM states and the encoder-decoder's cross K/V: the leaves walk in
    the reference's order with its arrays, and ``offload_cache`` gives its
    ``(n_in, n_out)``."""
    rcfg = r_configs.get_smoke(arch)
    plan = RPlan()
    params = r_models.init_params(jax.random.PRNGKey(0), rcfg, plan)
    frames = None
    if rcfg.family == "encdec":
        frames = jax.random.normal(jax.random.PRNGKey(1), (4, rcfg.enc_seq, rcfg.d_model), rcfg.param_dtype)
    rcache = r_models.init_cache(params, rcfg, plan, 4, 9, enc_frames=frames)
    step = jax.jit(lambda p, c, t: r_models.decode_step(p, c, t, rcfg, plan))
    tok = jax.random.randint(jax.random.PRNGKey(2), (4, 1), 0, rcfg.vocab)
    for _ in range(3):
        logits, rcache = step(params, rcache, tok)
        tok = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
    tcache = t_models.cache_from_numpy(rcache, device=CPU)
    want = list(r_serve._iter_kv_leaves(rcache))
    got = list(t_serve._iter_kv_leaves(tcache))
    assert len(got) == len(want) == len(jax.tree.leaves(rcache))
    for (ta, tn, ti), (ra, rn, ri) in zip(got, want):
        assert (tn, ti) == (rn, ri) and (ta is None) == (ra is None)
        if ra is not None:
            assert np.array_equal(ta.numpy(), ra)
    kw = dict(eb=1e-3, chunk_bytes=1 << 13)
    assert t_serve.offload_cache(tcache, device=CPU, **kw) == r_serve.offload_cache(rcache, **kw)


#: the int8 cache's leaves: k, v, k_scale, v_scale, pos, [ssm, conv,] length
#: [, cross_k, cross_v]
INT8_LEAVES = {"deepseek-moe-16b": 6, "qwen3-moe-30b-a3b": 6, "mamba2-2.7b": 3, "zamba2-7b": 8, "whisper-small": 8}


@pytest.mark.parametrize("arch", sorted(INT8_LEAVES))
def test_main_serves_every_family(arch, capsys, caplog):
    telemetry.reset_metrics()
    with _captured(caplog, "repro_torch.telemetry"):
        t_serve.main(["--arch", arch, "--batch", "2", "--tokens", "3", "--kv", "int8", "--offload-kv", "chunked",
                      "--metrics", "--device", "cpu"])
    out = capsys.readouterr().out
    events = [r.getMessage().split()[0] for r in caplog.records]
    assert [e for e in events if e in ("decode_done", "kv_offload")] == ["decode_done", "kv_offload"]
    assert "sz3_decode_step_seconds" in out
    counters = telemetry.METRICS.snapshot()["counters"]
    seen = counters["sz3_offload_leaves_total"] + counters.get("sz3_offload_leaves_skipped_total", 0)
    assert seen == INT8_LEAVES[arch]
    if arch in ("mamba2-2.7b", "zamba2-7b", "whisper-small"):  # SSM states or cross K/V go
        assert counters["sz3_offload_leaves_total"] >= 2


@needs_reference
def test_main_prints_the_references_metric_names_and_events(capsys, caplog):
    import sys

    argv = ["--arch", "granite-3-8b", "--kv", "int8", "--offload-kv", "chunked", "--metrics"]

    def names(text):
        return sorted(line.split()[2] for line in text.splitlines() if line.startswith("# TYPE "))

    def events(records):
        return [r.getMessage().split()[0] for r in records]

    r_tel.reset_metrics()
    saved = sys.argv
    sys.argv = ["serve"] + argv
    try:
        with _captured(caplog, "repro.telemetry"):
            r_serve.main()
    finally:
        sys.argv = saved
    ref_out, ref_events = capsys.readouterr().out, events(caplog.records)
    caplog.clear()
    telemetry.reset_metrics()
    with _captured(caplog, "repro_torch.telemetry"):
        t_serve.main(argv + ["--device", "cpu"])
    out, got_events = capsys.readouterr().out, events(caplog.records)
    assert names(out) == names(ref_out)
    assert "sz3_decode_step_seconds" in names(out)
    assert "sz3_offload_leaves_skipped_total" in names(out)
    assert [e for e in got_events if e in ("decode_done", "kv_offload")] == ["decode_done", "kv_offload"]
    assert [e for e in ref_events if e in ("decode_done", "kv_offload")] == ["decode_done", "kv_offload"]
    assert "trace 'kv_offload'" in out and "trace 'kv_offload'" in ref_out


def test_serve_returns_the_run_and_the_step_is_eager():
    cfg = t_configs.get_smoke("qwen1.5-0.5b")
    plan = TPlan()
    res = t_serve.serve(cfg, plan, batch=2, tokens=3, device=CPU)
    assert res.sequences.shape == (2, 4) and res.logits.shape == (2, cfg.vocab)
    assert int(res.cache.length) == 3 and res.offload is None and res.tok_per_s > 0
    # the same model again: same prompt, same greedy tokens
    again = t_serve.serve(cfg, plan, batch=2, tokens=3, params=res.params)
    assert np.array_equal(again.sequences, res.sequences)
    step = make_serve_step(cfg, plan)
    assert jit_serve_step(step, res.params, res.cache, cfg, plan) is step
    specs = cache_specs(res.cache, cfg, plan)
    assert specs.k == () and specs.k_scale is None and specs.length == ()
    with pytest.raises(ValueError, match="offload_kv"):
        t_serve.serve(cfg, plan, 1, 1, params=res.params, offload_kv="zip")
