"""The port's dense and VLM model stack (``repro_torch.models``,
``repro_torch.configs``, ``repro_torch.parallel``) held against the JAX
package's on the CPU.

* same weights, same answers: the reference's parameters (``init_params``
  under key 0, through ``jax.device_get``) cross into the port with
  ``params_from_numpy``; 8 greedy decode steps (20 for h2o-danube, whose
  16-token window then wraps the ring) through ``models.decode_step`` give
  the jitted reference's logits, tokens and cache, at ``kv`` bf16 and
  int8, on every dense and VLM smoke config; ``prefill_logits`` gives the
  reference's too;
* the int8 append: the port's ``_quantize_token`` divides ``absmax / 127``
  where the reference's jitted one multiplies by ``f32(1/127)``; on the
  same vectors the scales differ by at most one ulp, the codes only where
  a scale differs and by at most 1, and the counts are asserted; the
  decode step's fused append writes what two ``_quantize_token`` calls and
  four ``index_copy_`` calls write;
* the reference's own model tests (``tests/test_models_smoke.py``) through
  the port, with its tolerances;
* configs and parameter paths: all ten architectures' values, shape cells
  and input specs equal the reference's; the model's leaf paths and shapes
  equal the reference tree's;
* without a card the default device raises (the other families are
  ``tests/test_torch_families.py``'s).

Tolerances, float32 smoke configs: logits within 1e-4 absolute (XLA and
torch sum, divide and take transcendentals in different orders and
precisions, a few ulps per step; 4e-6 is typical); float cache leaves
within 2e-5 absolute plus 1e-5 relative (values of order 1).  At int8
the attention products take bf16 operands (the reference rounds the
scaled query, the dequantized cache ``int8 x bf16(scale)`` and the softmax
weights to bf16), so float noise that carries a value across a bf16
rounding boundary moves it by 2^-8 relative for that step: int8 logits
are held within 1e-2 (1.6e-3 seen once in 20 steps, on h2o-danube), and
at most a quarter of the steps may exceed 1e-4.  Codes may differ by 1 at
a rounding tie, in at most 1% of the cache.

The ``cuda``-marked tests hold ``_quantize_token`` on the card to its
plain version bit for bit, and count the fused int8 append
(``kv_quantize_append``) once per layer of a decode step
(``python -m pytest -q -m cuda tests/test_torch_models.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as t_configs
from repro_torch import models as t_models
from repro_torch import tree as tree_util
from repro_torch.models import lm as t_lm
from repro_torch.parallel import ParallelPlan as TPlan
from repro_torch.parallel import single_device_plan
from repro_torch.parallel.specs import heads_shardable

try:  # the differential tests need the JAX package
    import jax
    import jax.numpy as jnp

    import repro.configs as r_configs
    from repro import models as r_models
    from repro.ft.checkpoint import _path_str
    from repro.models import lm as r_lm
    from repro.parallel import ParallelPlan as RPlan
except ImportError:  # pragma: no cover - a machine without JAX
    jax = None

needs_reference = pytest.mark.skipif(jax is None, reason="the JAX package is not importable")
CPU = "cpu"
DENSE = ["granite-3-8b", "qwen1.5-0.5b", "h2o-danube-1.8b", "nemotron-4-340b", "pixtral-12b"]
ALL_ARCHS = list(t_configs.ARCHS)
LOGIT_ATOL = 1e-4
INT8_ATOL = 1e-2
CACHE_ATOL, CACHE_RTOL = 2e-5, 1e-5


def _ref_model(arch, kv="bf16"):
    cfg = r_configs.get_smoke(arch)
    plan = RPlan(kv_cache_dtype=kv)
    params = r_models.init_params(jax.random.PRNGKey(0), cfg, plan)
    return cfg, plan, params


def _port_model(arch, params, kv="bf16"):
    cfg = t_configs.get_smoke(arch)
    plan = TPlan(kv_cache_dtype=kv)
    return cfg, plan, t_models.params_from_numpy(jax.device_get(params), cfg, device=CPU)


def _f32_ulps(a, b):
    """|a - b| in float32 ulps (same-sign finite values)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


# ---------------------------------------------------------------------------
# (a) decode: same weights, same logits, tokens and cache
# ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_the_jitted_reference(arch, kv):
    rcfg, rplan, rparams = _ref_model(arch, kv)
    tcfg, tplan, model = _port_model(arch, rparams, kv)
    B, steps = 2, (20 if arch.startswith("h2o") else 8)
    rcache = r_models.init_cache(rparams, rcfg, rplan, B, steps + 4)
    tcache = t_models.init_cache(model, tcfg, tplan, B, steps + 4)
    if arch.startswith("h2o"):
        assert rcache.k.shape[2] == tcache.k.shape[2] == 16 < steps  # the ring wraps
    step = jax.jit(lambda p, c, t: r_models.decode_step(p, c, t, rcfg, rplan), donate_argnums=1)
    first = np.random.default_rng(1).integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
    rtok, ttok = jnp.asarray(first), torch.from_numpy(first)
    loose = 0  # int8 steps beyond LOGIT_ATOL (a bf16 rounding flip)
    for _ in range(steps):
        rlogits, rcache = step(rparams, rcache, rtok)
        tlogits, tcache = t_models.decode_step(model, tcache, ttok, tcfg, tplan)
        err = float(np.abs(tlogits.numpy() - np.asarray(rlogits)).max())
        loose += err > LOGIT_ATOL
        assert err <= (INT8_ATOL if kv == "int8" else LOGIT_ATOL), err
        rtok = jnp.argmax(rlogits, -1, keepdims=True).astype(jnp.int32)
        ttok = torch.argmax(tlogits, -1, keepdim=True).to(torch.int32)
        assert np.array_equal(ttok.numpy(), np.asarray(rtok))  # greedy tokens equal
    assert tlogits.shape == (B, rcfg.vocab) and tlogits.dtype == torch.float32
    assert loose <= steps // 4, loose
    assert np.array_equal(tcache.pos.numpy(), np.asarray(rcache.pos))
    assert int(tcache.length) == int(rcache.length) == steps
    if kv == "bf16":
        assert tcache.k_scale is None and rcache.k_scale is None
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(tcache, name).numpy(), np.asarray(getattr(rcache, name)),
                                       rtol=CACHE_RTOL, atol=CACHE_ATOL)
        return
    # int8: the inputs of each quantization already differ by float noise,
    # so a scale may differ by a few ulps and a code by 1 at a rounding tie
    for name in ("k", "v"):
        tq, rq = getattr(tcache, name).numpy(), np.asarray(getattr(rcache, name))
        ts, rs = getattr(tcache, f"{name}_scale").numpy(), np.asarray(getattr(rcache, f"{name}_scale"))
        assert tq.dtype == rq.dtype == np.int8
        diff = np.abs(tq.astype(np.int32) - rq.astype(np.int32))
        assert diff.max() <= 1
        assert (diff != 0).sum() <= tq.size // 100, (diff != 0).sum()
        np.testing.assert_allclose(ts, rs, rtol=CACHE_RTOL, atol=0)


@needs_reference
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_the_references(arch):
    rcfg, rplan, rparams = _ref_model(arch)
    tcfg, tplan, model = _port_model(arch, rparams)
    toks = np.random.default_rng(2).integers(0, rcfg.vocab, (2, 12)).astype(np.int32)
    pre = jax.jit(lambda p, b: r_models.prefill_logits(p, b, rcfg, rplan))
    want = np.asarray(pre(rparams, {"tokens": jnp.asarray(toks)}))
    got = t_models.prefill_logits(model, {"tokens": torch.from_numpy(toks)}, tcfg, tplan)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    assert torch.equal(model({"tokens": torch.from_numpy(toks)}), got)  # DecoderLM.forward
    if rcfg.family == "vlm":  # the stubbed frontend's patch+token embeddings
        emb = np.random.default_rng(3).standard_normal((2, 12, rcfg.d_model)).astype(np.float32)
        want = np.asarray(pre(rparams, {"embeds": jnp.asarray(emb)}))
        got = t_models.prefill_logits(model, {"embeds": torch.from_numpy(emb)}, tcfg, tplan)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


@needs_reference
@pytest.mark.parametrize("mode", ["blocked", "scan"])
def test_attention_core_matches_the_references_blocks_and_windows(mode):
    """Both modes of the chunked attention, at 2048 queries (two 1024-query
    blocks, two KV chunks), causal with and without a sliding window."""
    from repro.models import layers as r_layers

    from repro_torch.models import layers as t_layers

    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 2048, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 2048, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 2048, 2, 8)).astype(np.float32)
    for window in (None, 700):
        want = np.asarray(r_layers.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                  causal=True, window=window, mode=mode))
        got = t_layers.attention_core(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                      causal=True, window=window, mode=mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="Sq % 1024"):
        t_layers.attention_core(torch.zeros(1, 1500, 4, 8), torch.zeros(1, 1500, 2, 8),
                                torch.zeros(1, 1500, 2, 8), causal=True, mode="blocked")


@needs_reference
def test_layers_match_the_references():
    """Norms (both), RoPE (halves, no interleave) and the three MLP
    activations (gelu: the tanh approximation, as ``jax.nn.gelu``)."""
    from repro.models import layers as r_layers

    from repro_torch.models import layers as t_layers

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    for p in ({"w": w}, {"w": w, "b": b}):
        want = np.asarray(r_layers.apply_norm({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x)))
        got = t_layers.apply_norm({k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    xh = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(100, 105)[None, :]
    want = np.asarray(r_layers.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 10000.0))
    got = t_layers.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    for act in ("swiglu", "relu2", "gelu"):
        rcfg = dataclasses.replace(r_configs.get_smoke("granite-3-8b"), d_model=64, d_ff=96, mlp_act=act)
        tcfg = dataclasses.replace(t_configs.get_smoke("granite-3-8b"), d_model=64, d_ff=96, mlp_act=act)
        rp = r_layers.init_mlp(jax.random.PRNGKey(6), rcfg)
        want = np.asarray(r_layers.apply_mlp(rp, jnp.asarray(x), rcfg, RPlan()))
        got = t_layers.apply_mlp({k: torch.from_numpy(np.array(a)) for k, a in rp.items()},
                                 torch.from_numpy(x), tcfg, TPlan())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# the int8 append: _quantize_token against the reference's jitted one
# ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_token_differs_only_by_the_reciprocal_rewrite(dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((64, 1, 8, 128)) * rng.uniform(0.01, 30, (64, 1, 8, 1))).astype(np.float32)
    x[3, 0, 2] = 0.0  # an all-zero token vector: the 1e-8 floor
    xj = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    rq, rs = jax.jit(r_lm._quantize_token)(xj)
    rq, rs = np.asarray(rq), np.asarray(rs)
    xt = torch.from_numpy(np.array(jax.device_get(xj).astype(np.float32)))
    xt = xt.to(torch.bfloat16) if dtype == "bfloat16" else xt
    tq, ts = t_lm._quantize_token(xt)
    tq, ts = tq.numpy(), ts.numpy()
    assert tq.shape == rq.shape and ts.shape == rs.shape == (64, 1, 8)
    # the port divides: its scales are the true quotient, floored at 1e-8
    xf = xt.to(torch.float32).numpy()
    oracle = np.maximum(np.abs(xf).max(-1) / np.float32(127), np.float32(1e-8))
    assert np.array_equal(ts, oracle) and ts[3, 0, 2] == np.float32(1e-8)
    ulps = _f32_ulps(ts, rs)
    scale_diff = ulps != 0
    assert ulps.max() <= 1
    assert scale_diff.sum() <= ts.size // 4, scale_diff.sum()  # the rewrite's ulp, at a minority of vectors
    code_diff = np.abs(tq.astype(np.int32) - rq.astype(np.int32))
    assert code_diff.max() <= 1
    assert not (code_diff.any(-1) & ~scale_diff).any()  # codes differ only where the scale does
    assert code_diff.astype(bool).sum() <= scale_diff.sum() * 128


@pytest.mark.parametrize("arch, slot", [("granite-3-8b", 0), ("granite-3-8b", 5), ("qwen1.5-0.5b", 3)])
def test_decode_attn_int8_append_writes_what_quantize_token_and_index_copy_write(monkeypatch, arch, slot):
    """``_decode_attn``'s fused append leaves the caches and scales exactly
    as two ``_quantize_token`` calls and four ``index_copy_`` calls on the
    same K and V would (the sequence it replaced)."""
    cfg = t_configs.get_smoke(arch)
    plan = TPlan(kv_cache_dtype="int8")
    model = t_models.init_params(5, cfg, plan, device=CPU)
    cache = t_models.init_cache(model, cfg, plan, 3, 8)
    g = torch.Generator().manual_seed(slot)
    for t in (cache.k, cache.v):
        t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
    for t in (cache.k_scale, cache.v_scale):
        t.copy_(torch.rand(t.shape, generator=g))
    before = [t[0].clone() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)]
    seen = []
    real = t_lm.kv_quantize_append

    def spy(k, v, *rest):
        seen.append((k.clone(), v.clone()))
        real(k, v, *rest)

    monkeypatch.setattr(t_lm, "kv_quantize_append", spy)
    x = torch.randn((3, 1, cfg.d_model), generator=g).to(cfg.param_dtype)
    lc = (cache.k[0], cache.v[0], cache.k_scale[0], cache.v_scale[0], cache.pos)
    pos_slot = torch.tensor([slot])
    lp = t_lm._layer(t_lm.param_tree(model)["blocks"], 0)
    t_lm._decode_attn(lp["attn"], x, lc, torch.tensor(slot, dtype=torch.int32), pos_slot, cfg, plan)
    (k, v), = seen
    assert k.shape == v.shape == (3, 1, cfg.n_kv_heads, cfg.hd)
    kq, ks = t_lm._quantize_token(k)
    vq, vs = t_lm._quantize_token(v)
    kc, vc, ksc, vsc = before
    kc.index_copy_(1, pos_slot, kq)
    vc.index_copy_(1, pos_slot, vq)
    ksc.index_copy_(1, pos_slot, ks)
    vsc.index_copy_(1, pos_slot, vs)
    for got, want in zip((cache.k[0], cache.v[0], cache.k_scale[0], cache.v_scale[0]), (kc, vc, ksc, vsc)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (c) the reference's own model tests, through the port
# ---------------------------------------------------------------------------

PLAN = TPlan()


def _toks(gen_seed, shape, vocab):
    g = torch.Generator().manual_seed(gen_seed)
    return torch.randint(0, vocab, shape, generator=g, dtype=torch.int32)


def test_prefill_matches_decode_chain():
    """prefill logits at position t == decode-step logits after consuming
    t tokens (cache correctness)."""
    cfg = t_configs.get_smoke("granite-3-8b")
    model = t_models.init_params(2, cfg, PLAN, device=CPU)
    toks = _toks(2, (1, 6), cfg.vocab)
    pre = t_models.prefill_logits(model, {"tokens": toks}, cfg, PLAN)
    cache = t_models.init_cache(model, cfg, PLAN, 1, 16)
    for t in range(6):
        logits, cache = t_models.decode_step(model, cache, toks[:, t : t + 1], cfg, PLAN)
    np.testing.assert_allclose(pre.numpy(), logits.numpy(), rtol=2e-3, atol=2e-3)


def test_swa_decode_ring_wraps():
    """Sliding-window cache must evict old tokens but keep exact recent ones."""
    cfg = t_configs.get_smoke("h2o-danube-1.8b")  # window 16
    model = t_models.init_params(3, cfg, PLAN, device=CPU)
    toks = _toks(3, (1, 24), cfg.vocab)
    cache = t_models.init_cache(model, cfg, PLAN, 1, 24)
    W = cache.k.shape[2]
    assert W == cfg.sliding_window  # ring sized to the window
    for t in range(24):
        logits, cache = t_models.decode_step(model, cache, toks[:, t : t + 1], cfg, PLAN)
    assert bool(torch.isfinite(logits).all())
    pre = t_models.prefill_logits(model, {"tokens": toks}, cfg, PLAN)
    np.testing.assert_allclose(pre.numpy(), logits.numpy(), rtol=3e-3, atol=3e-3)


def test_int8_kv_cache_close_to_bf16():
    cfg = t_configs.get_smoke("granite-3-8b")
    model = t_models.init_params(4, cfg, PLAN, device=CPU)
    toks = _toks(4, (2, 8), cfg.vocab)
    outs = {}
    for dt in ["bf16", "int8"]:
        plan = dataclasses.replace(PLAN, kv_cache_dtype=dt)
        cache = t_models.init_cache(model, cfg, plan, 2, 16)
        for t in range(8):
            logits, cache = t_models.decode_step(model, cache, toks[:, t : t + 1], cfg, plan)
        outs[dt] = torch.log_softmax(logits, -1).numpy()
    # int8 per-token quantization: small logprob drift
    drift = np.abs(outs["bf16"] - outs["int8"]).max()
    assert drift < 0.3, drift


def test_init_draws_the_references_distributions():
    """normal x 1/sqrt(fan_in) weights, the embedding at 0.02, norms ones,
    biases zeros; the same seed draws the same model."""
    cfg = t_configs.get("qwen1.5-0.5b")
    cfg = dataclasses.replace(cfg, n_layers=2, vocab=4096, dtype="float32")
    model = t_models.init_params(0, cfg, PLAN, device=CPU)
    p = model.tree()
    assert abs(float(p["embed"].std()) - 0.02) < 0.001
    assert abs(float(p["blocks"]["attn"]["wq"].std()) * np.sqrt(cfg.d_model) - 1) < 0.01
    assert abs(float(p["blocks"]["mlp"]["w2"].std()) * np.sqrt(cfg.d_ff) - 1) < 0.01
    assert torch.equal(p["blocks"]["ln1"]["w"], torch.ones(2, cfg.d_model))
    assert torch.equal(p["blocks"]["attn"]["bq"], torch.zeros(2, cfg.n_heads * cfg.hd))
    assert not torch.equal(p["blocks"]["attn"]["wq"][0], p["blocks"]["attn"]["wq"][1])
    again = t_models.init_params(0, cfg, PLAN, device=CPU).tree()
    assert all(torch.equal(a, b) for a, b in zip(tree_util.flatten(p)[0], tree_util.flatten(again)[0]))
    assert not any(t.requires_grad for t in model.parameters())


# ---------------------------------------------------------------------------
# (d) configs, (e) parameter paths
# ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_config_values(arch):
    """Both the exact and the smoke config equal the reference's field by
    field, with the same derived values; the reference's own checks hold."""
    assert t_configs.ARCHS == r_configs.ARCHS
    for t_get, r_get in ((t_configs.get, r_configs.get), (t_configs.get_smoke, r_configs.get_smoke)):
        t, r = t_get(arch), r_get(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert (t.hd, t.padded_vocab, t.d_inner, t.ssm_heads) == (r.hd, r.padded_vocab, r.d_inner, r.ssm_heads)
        assert t.block_kinds() == r.block_kinds() and t.n_flop_params() == r.n_flop_params()
        assert str(t.param_dtype).removeprefix("torch.") == np.dtype(r.param_dtype).name
    cfg = t_configs.get(arch)
    assert cfg.n_layers >= 12 and cfg.d_model >= 768
    assert cfg.padded_vocab % cfg.vocab_pad_to == 0
    assert cfg.n_flop_params() > 1e8
    kinds = cfg.block_kinds()
    if cfg.family == "hybrid":
        assert "shared_attn" in kinds and "ssm" in kinds
    for name, cell in t_configs.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(r_configs.SHAPES[name])
        assert t_configs.cell_skip_reason(cfg, cell) == r_configs.cell_skip_reason(r_configs.get(arch), cell)
        want = r_configs.input_specs(r_configs.get(arch), r_configs.SHAPES[name])
        got = t_configs.input_specs(cfg, cell)
        assert sorted(got) == sorted(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta" and tuple(got[key].shape) == spec.shape
            assert str(got[key].dtype).removeprefix("torch.") == np.dtype(spec.dtype).name


def test_exact_assigned_dims():
    c = t_configs.get("nemotron-4-340b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) == (
        96, 18432, 96, 8, 73728, 256000,
    )
    c = t_configs.get("deepseek-moe-16b")
    assert (c.n_experts, c.top_k, c.n_shared_experts, c.moe_d_ff) == (64, 6, 2, 1408)
    c = t_configs.get("qwen3-moe-30b-a3b")
    assert (c.n_experts, c.top_k, c.head_dim) == (128, 8, 128)
    c = t_configs.get("mamba2-2.7b")
    assert (c.n_layers, c.d_model, c.ssm_state) == (64, 2560, 128)
    c = t_configs.get("zamba2-7b")
    assert (c.n_layers, c.d_model, c.ssm_state) == (81, 3584, 64)
    c = t_configs.get("h2o-danube-1.8b")
    assert c.sliding_window is not None
    c = t_configs.get("granite-3-8b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab, c.padded_vocab) == (
        40, 4096, 32, 8, 12800, 49155, 49408,
    )
    assert round(c.n_flop_params() / 1e9, 2) == 8.37


@needs_reference
@pytest.mark.parametrize("arch", DENSE)
def test_param_paths_and_shapes_equal_the_references(arch):
    _, _, rparams = _ref_model(arch)
    want = [(_path_str(p), tuple(a.shape), np.dtype(a.dtype).name)
            for p, a in jax.tree_util.tree_flatten_with_path(rparams)[0]]
    cfg = t_configs.get_smoke(arch)
    own = t_models.init_params(0, cfg, PLAN, device=CPU)  # the port's own draw
    carried = t_models.params_from_numpy(jax.device_get(rparams), cfg, device=CPU)
    for model in (own, carried):
        got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for p, t in tree_util.flatten_with_path(model.tree())[0]]
        assert got == want
    # the module registers the same leaves under the same names
    named = {n.replace(".", "/"): tuple(t.shape) for n, t in own.named_parameters()}
    assert named == {p: s for p, s, _ in want}


@needs_reference
def test_plan_fields_and_single_device_facts():
    assert [f.name for f in dataclasses.fields(TPlan)] == [f.name for f in dataclasses.fields(RPlan)]
    for f_t, f_r in zip(dataclasses.fields(TPlan), dataclasses.fields(RPlan)):
        assert f_t.default == f_r.default, f_t.name
    plan = dataclasses.replace(single_device_plan(), kv_cache_dtype="int8")
    assert (plan.tp, plan.dp, plan.kv_repeat(8, 32), plan.b) == (1, 1, 1, "data")
    x = torch.randn(2, 3, 4)
    w = torch.randn(4, 5)
    assert plan.act_btd(x) is x and plan.act_heads(x) is x and plan.constrain(x, plan.ps("data")) is x
    assert torch.equal(plan.tp_project(x, w), x @ w)
    assert heads_shardable(t_configs.get("granite-3-8b"), plan)
    assert TPlan(grad_compress_bits=8).grad_compression().tier == "int8"


# ---------------------------------------------------------------------------
# (f) the default device, (g) later slices
# ---------------------------------------------------------------------------

def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works there")
    cfg = t_configs.get_smoke("granite-3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_models.init_params(0, cfg, PLAN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_models.params_from_numpy(t_models.init_params(0, cfg, PLAN, device=CPU).tree(), cfg)
    from repro_torch.launch.serve import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, PLAN, 1, 1)


class _Mesh:
    """A stand-in for a ``DeviceMesh``: the plan reads only its axis names
    and sizes."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, i):
        return self._sizes[i]


def test_training_and_meshes_raise_naming_their_slice():
    # dense training and data parallelism came with slice 11b, the other
    # families with slice 11c, sharded training with slice 11d: the plans
    # that raised before it now construct
    plan = TPlan(mesh=_Mesh(data=2, model=2))
    assert (plan.tp, plan.dp, plan.present(("data", "model")), plan.ps(plan.b, None, "model")) == \
        (2, 2, ("data", "model"), ("data", None, "model"))
    plan = TPlan(mesh=_Mesh(data=2, model=1), fsdp_axes=("data",))
    assert (plan.tp, plan.dp, plan.fsdp_axes, plan.ps("model", "data")) == (1, 2, ("data",), ("model", "data"))
    plan = TPlan(mesh=_Mesh(data=2), seq_axes=("data",))
    assert (plan.tp, plan.dp, plan.seq_axes, plan.ps(plan.b, "data")) == (1, 2, ("data",), ("data", "data"))
    assert TPlan(mesh=_Mesh(pod=2, data=4, model=2), batch_axes=("pod", "data")).dp == 8
    plan = TPlan(mesh=_Mesh(data=2, model=1), bwd_cast_bf16=True)
    assert (plan.dp, plan.tp, plan.ps("data", None)) == (2, 1, ("data", None))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_quantize_token_equals_plain_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.kvquant import kernel as K

    g = torch.Generator(device="cuda").manual_seed(8)
    for shape, dtype in (((4, 1, 8, 128), torch.bfloat16), ((3, 5, 2, 64), torch.float32)):
        x = (torch.randn(shape, generator=g, device="cuda") * 7).to(dtype)
        x[1, 0, 1] = 0  # an all-zero token vector: the 1e-8 floor
        K.reset_launches()
        q, s = t_lm._quantize_token(x)
        torch.cuda.synchronize()
        assert K.LAUNCHES["absmax"] == 1 and K.LAUNCHES["quantize_with_scale"] == 1
        pq, ps = t_lm._quantize_token(x.cpu())
        assert q.device.type == "cuda" and torch.equal(q.cpu(), pq)
        assert torch.equal(s.cpu().view(torch.int32), ps.view(torch.int32))
        assert float(ps[1, 0, 1]) == np.float32(1e-8)
    zeros = torch.zeros((2, 1, 4, 32), device="cuda")
    q, s = t_lm._quantize_token(zeros)
    assert not q.any() and bool((s == np.float32(1e-8)).all())


@pytest.mark.cuda
def test_cuda_int8_decode_step_launches_the_append_once_per_layer():
    """The fused append once per attention layer a step, and neither of the
    standalone kvquant kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.kvquant import kernel as K

    cfg = t_configs.get_smoke("granite-3-8b")
    plan = TPlan(kv_cache_dtype="int8")
    model = t_models.init_params(0, cfg, plan, device="cuda")
    cache = t_models.init_cache(model, cfg, plan, 2, 8)
    toks = _toks(0, (2, 3), cfg.vocab).cuda()
    K.reset_launches()
    for t in range(3):
        logits, cache = t_models.decode_step(model, cache, toks[:, t : t + 1], cfg, plan)
    torch.cuda.synchronize()
    assert K.LAUNCHES["quantize_append"] == 3 * cfg.n_layers
    assert K.LAUNCHES["absmax"] == K.LAUNCHES["quantize_with_scale"] == 0
    assert bool(torch.isfinite(logits).all()) and bool((cache.k_scale[:, :, :3] > 0).all())
