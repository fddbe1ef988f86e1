"""The port's training path (``repro_torch.models.loss_fn``, the remat
policies, ``repro_torch.train.step``, ``repro_torch.data``) held against
the JAX package's on the CPU, on the float32 smoke configs.

* loss and gradients: the reference's parameters (``init_params`` under key
  0) cross into the port with ``params_from_numpy``; ``loss_fn`` and its
  gradients (``torch.autograd.grad`` of detached aliases) against
  ``jax.value_and_grad`` of the reference's, on the five dense and VLM
  smoke configs; with ``bwd_cast_bf16`` too;
* remat ``none``, ``full`` and ``dots`` give the same gradients, bit for
  bit (recompute changes memory, never numbers);
* three train steps from one state (``train_state_from_numpy``) against the
  reference's jitted ``make_train_step``: plain, ``microbatches=2``,
  ``grad_accum_dtype="bfloat16"`` and compressed moments;
* ``batch_at`` of the three pipeline families, bit for bit;
* the reference's own training tests (``tests/test_system.py``,
  ``tests/test_models_smoke.py::test_arch_train_step``) through the port.

Tolerances.  Loss: 2e-6 relative (XLA and torch sum and take the
log-sum-exp in different orders; a few float32 ulps of a loss near 6 are
seen).  Gradients: 1e-5 of each leaf's largest |g| (2e-6 seen).  With
``bwd_cast_bf16`` the cotangents round to bf16 at every block boundary, so
float noise that carries a value across a bf16 rounding boundary moves it
by 2^-8 relative, and the error propagates: each leaf within 2^-6 of its
largest |g| (2^-8 seen), and its median difference from the reference's
under a tenth of the lever's own median effect on it (a fortieth seen),
which a barrier missing or misplaced would not give.
Parameters after three steps: Adam's first steps move an element by about
``lr * lr_scale`` whatever the size of its gradient, so a near-zero
gradient whose sign differs between the packages moves it by up to twice
that: every element within ``2 * lr * sum(lr_scale)`` (the schedule's
sum over the three steps), and at most 0.1% of the elements beyond 1e-5;
1% with compressed moments (0.2% seen), whose codes are not compared: the
mean predictor's base (a block mean) and ``log2 v`` round differently in
the two packages, so a code moves with them.

The ``cuda``-marked test runs three steps on the card against the CPU
(``python -m pytest -q -m cuda tests/test_torch_train.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

import repro_torch.configs as t_configs
from repro_torch import data as t_data
from repro_torch import models as t_models
from repro_torch import tree as tree_util
from repro_torch.models import lm as t_lm
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.optim import warmup_cosine
from repro_torch.parallel import ParallelPlan as TPlan
from repro_torch.train.step import init_train_state as t_init_train_state
from repro_torch.train.step import make_train_step as t_make_train_step

try:  # the differential tests need the JAX package
    import jax
    import jax.numpy as jnp

    import repro.configs as r_configs
    from repro import models as r_models
    from repro.data import make_pipeline as r_make_pipeline
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
CPU = "cpu"
DENSE = ["granite-3-8b", "qwen1.5-0.5b", "h2o-danube-1.8b", "nemotron-4-340b", "pixtral-12b"]
PLAN = TPlan()
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5
BF16_GRAD_RTOL = 2.0 ** -6
BF16_MEDIAN_SHARE = 0.1
PARAM_ATOL = 1e-5


def _t_batch(b, device=CPU):
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _r_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_grads(cfg, plan, params, batch):
    leaves, treedef = tree_util.flatten(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss = t_models.loss_fn(tree_util.unflatten(treedef, live), batch, cfg, plan)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), [g.numpy() for g in grads]


def _ref_loss_and_grads(arch, rplan, seq=32, batch=2):
    cfg = r_configs.get_smoke(arch)
    params = r_models.init_params(jax.random.PRNGKey(0), cfg, rplan)
    b = r_make_pipeline(cfg, seq=seq, global_batch=batch, seed=0).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, bb: r_models.loss_fn(p, bb, cfg, rplan)))(params, _r_batch(b))
    return jax.device_get(params), b, float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _rel_err(got, want):
    if not want.any():
        return float(np.abs(got).max())
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# ---------------------------------------------------------------------------
# loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_the_reference(arch):
    params, b, r_loss, r_grads = _ref_loss_and_grads(arch, RPlan())
    cfg = t_configs.get_smoke(arch)
    model = t_models.params_from_numpy(params, cfg, device=CPU)
    t_loss, t_grads = _port_grads(cfg, PLAN, model.tree(), _t_batch(b))
    assert abs(t_loss - r_loss) <= LOSS_RTOL * abs(r_loss), (t_loss, r_loss)
    assert len(t_grads) == len(r_grads)
    for tg, rg in zip(t_grads, r_grads):
        assert tg.shape == rg.shape and tg.dtype == rg.dtype
        assert _rel_err(tg, rg) <= GRAD_RTOL, _rel_err(tg, rg)
    if cfg.family == "vlm":  # the embedding is not read: zero gradient, as under jax.grad
        embed = tree_util.flatten_with_path(model.tree())[0]
        i = [p for p, _ in embed].index("embed")
        assert not t_grads[i].any() and not r_grads[i].any()


@needs_reference
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "pixtral-12b"])
def test_bwd_cast_bf16_grads_match_the_reference(arch):
    params, b, r_loss, r_grads = _ref_loss_and_grads(arch, RPlan(bwd_cast_bf16=True))
    cfg = t_configs.get_smoke(arch)
    tree = t_models.params_from_numpy(params, cfg, device=CPU).tree()
    t_loss, t_grads = _port_grads(cfg, TPlan(bwd_cast_bf16=True), tree, _t_batch(b))
    _, plain = _port_grads(cfg, PLAN, tree, _t_batch(b))
    assert abs(t_loss - r_loss) <= LOSS_RTOL * abs(r_loss)
    moved = 0
    for tg, rg, pg in zip(t_grads, r_grads, plain):
        assert _rel_err(tg, rg) <= BF16_GRAD_RTOL, _rel_err(tg, rg)
        lever = float(np.median(np.abs(tg - pg)))
        if lever > 0:  # the barriers sit where the reference's do
            assert float(np.median(np.abs(tg - rg))) <= BF16_MEDIAN_SHARE * lever
            moved += 1
    assert moved > len(t_grads) // 2  # the lever changes the gradients


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "h2o-danube-1.8b"])
def test_remat_policies_give_equal_grads(arch):
    cfg = t_configs.get_smoke(arch)
    tree = t_models.init_params(3, cfg, PLAN, device=CPU).tree()
    pipe = t_data.make_pipeline(cfg, seq=32, global_batch=2)
    b = _t_batch(pipe.batch_at(0))
    out = {r: _port_grads(cfg, TPlan(remat=r), tree, b) for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        assert out[r][0] == out["none"][0]
        for a, c in zip(out[r][1], out["none"][1]):
            assert np.array_equal(a, c), r


def test_remat_dots_saves_the_weight_products_and_recomputes_the_rest():
    decisions = []

    def policy(ctx, op, *a, **k):
        decision = t_lm._dots_policy(ctx, op, *a, **k)
        decisions.append((op, decision))
        return decision

    def block(x, w):  # a weight product (mm) and an attention-like einsum (bmm)
        return torch.einsum("bsd,btd->bst", x @ w, x @ w).sum()

    x = torch.randn(2, 3, 4, requires_grad=True)
    checkpoint(block, x, torch.randn(4, 4), use_reentrant=False,
               context_fn=functools.partial(create_selective_checkpoint_contexts, policy)).backward()
    saved = {op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE}
    recomputed = {op for op, d in decisions if d != CheckpointPolicy.MUST_SAVE}
    assert saved == {torch.ops.aten.mm.default}
    assert torch.ops.aten.bmm.default in recomputed


# ---------------------------------------------------------------------------
# three train steps against the reference's jitted step
# ---------------------------------------------------------------------------

STEP_VARIANTS = {
    "plain": ({}, {}),
    "microbatches2": ({"microbatches": 2}, {}),
    "bf16_accumulation": ({"microbatches": 2, "grad_accum_dtype": "bfloat16"}, {}),
    "compressed_moments": ({}, {"compress_moments": True, "moment_policy": "int8:bs=256"}),
}


@functools.lru_cache(maxsize=None)
def _ref_train_state(arch, opt_items):
    """The reference's train state under key 0, on the host, once per
    optimizer config: without gradient compression it does not depend on
    the plan, so the plain-moment variants share it."""
    cfg, opt = r_configs.get_smoke(arch), RAdamW(**dict(opt_items))
    return jax.device_get(jax.jit(lambda key: r_init_train_state(key, cfg, RPlan(), opt))(jax.random.PRNGKey(0)))


@needs_reference
@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_train_steps_match_the_jitted_reference(variant):
    plan_kw, opt_kw = STEP_VARIANTS[variant]
    arch, lr, total, n = "qwen1.5-0.5b", 3e-2, 20, 3
    rcfg, tcfg = r_configs.get_smoke(arch), t_configs.get_smoke(arch)
    ropt, topt = RAdamW(lr=lr, **opt_kw), TAdamW(lr=lr, **opt_kw)
    rplan, tplan = RPlan(**plan_kw), TPlan(**plan_kw)
    rstate = _ref_train_state(arch, tuple(sorted({"lr": lr, **opt_kw}.items())))
    tstate = t_models.train_state_from_numpy(rstate, tcfg, device=CPU)
    rstep = jax.jit(r_make_train_step(rcfg, rplan, ropt, total_steps=total))
    tstep = t_make_train_step(tcfg, tplan, topt, total_steps=total)
    pipe = r_make_pipeline(rcfg, seq=32, global_batch=4)
    for k in range(n):
        b = pipe.batch_at(k)
        rstate, rm = rstep(rstate, _r_batch(b))
        tstate2, tm = tstep(tstate, _t_batch(b))
        assert tstate2 is tstate  # updated in place
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= LOSS_RTOL * abs(float(rm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-5 * float(rm["grad_norm"])
    assert int(tstate["opt"]["step"]) == int(rstate["opt"]["step"]) == n
    sched = sum(float(warmup_cosine(torch.tensor(k), total=total)) for k in range(n))
    diff = np.concatenate([np.abs(np.asarray(r) - t.numpy()).ravel() for r, t in
                           zip(jax.tree.leaves(jax.device_get(rstate["params"])), tree_util.flatten(tstate["params"])[0])])
    assert diff.max() <= 2 * lr * sched, diff.max()
    loose = (diff > PARAM_ATOL).mean()
    assert loose <= (0.01 if opt_kw else 0.001), loose


def test_compressed_reduction_needs_a_mesh():
    cfg = t_configs.get_smoke("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="needs a ParallelPlan with a mesh"):
        t_make_train_step(cfg, TPlan(grad_policy="int8"), TAdamW())


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@needs_reference
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "pixtral-12b", "whisper-small"])
def test_batch_at_is_bit_identical(arch):
    rcfg, tcfg = r_configs.get_smoke(arch), t_configs.get_smoke(arch)
    for seed, seq, batch in ((1234, 32, 4), (7, 16, 3)):
        rp = r_make_pipeline(rcfg, seq=seq, global_batch=batch, seed=seed)
        tp = t_data.make_pipeline(tcfg, seq=seq, global_batch=batch, seed=seed)
        assert type(tp).__name__ == type(rp).__name__
        for step in (0, 1, 17, 10**6):
            rb, tb = rp.batch_at(step), tp.batch_at(step)
            assert sorted(rb) == sorted(tb)
            for k in rb:
                assert rb[k].dtype == tb[k].dtype and np.array_equal(rb[k], tb[k]), (arch, k, step)


# ---------------------------------------------------------------------------
# the reference's own training tests, through the port
# ---------------------------------------------------------------------------

def test_training_reduces_loss():
    cfg = t_configs.get_smoke("h2o-danube-1.8b")
    opt = TAdamW(lr=3e-3, weight_decay=0.0)
    state = t_init_train_state(0, cfg, PLAN, opt, device=CPU)
    step = t_make_train_step(cfg, PLAN, opt, total_steps=60)
    pipe = t_data.make_pipeline(cfg, seq=32, global_batch=4)
    losses = []
    for k in range(25):
        state, m = step(state, _t_batch(pipe.batch_at(k % 4)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::6]
    assert np.isfinite(losses).all()


def test_microbatched_step_matches_unbatched():
    cfg = t_configs.get_smoke("qwen1.5-0.5b")
    opt = TAdamW(lr=1e-3)
    pipe = t_data.make_pipeline(cfg, seq=16, global_batch=4)
    batch = _t_batch(pipe.batch_at(0))
    outs = {}
    for mb in [1, 2]:
        plan = dataclasses.replace(PLAN, microbatches=mb)
        state = t_init_train_state(0, cfg, plan, opt, device=CPU)
        step = t_make_train_step(cfg, plan, opt)
        state, m = step(state, batch)
        outs[mb] = (float(m["loss"]), tree_util.flatten(state["params"])[0][0].numpy().astype(np.float32))
    assert abs(outs[1][0] - outs[2][0]) < 1e-3
    np.testing.assert_allclose(outs[1][1], outs[2][1], atol=2e-3)


@pytest.mark.parametrize("arch", DENSE)
def test_arch_train_step(arch):
    cfg = t_configs.get_smoke(arch)
    params = t_models.init_params(0, cfg, PLAN, device=CPU)
    batch = _t_batch(t_data.make_pipeline(cfg, seq=32, global_batch=2, seed=0).batch_at(0))
    loss, grads = _port_grads(cfg, PLAN, params.tree(), batch)
    assert np.isfinite(loss), arch
    assert 2.0 < loss < 20.0, (arch, loss)
    gnorm = sum(float(np.sum(g.astype(np.float32) ** 2)) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0, arch
    assert not any(t.requires_grad for t in params.parameters())  # the trainer turns grads on, not init


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_train_steps_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = t_configs.get_smoke("qwen1.5-0.5b")
    opt = TAdamW(lr=3e-2)
    host = t_init_train_state(0, cfg, PLAN, opt, device=CPU)
    card = tree_util.tree_map(lambda t: t.cuda(), host)
    step = t_make_train_step(cfg, PLAN, opt, total_steps=20)
    pipe = t_data.make_pipeline(cfg, seq=32, global_batch=4)
    for k in range(3):
        b = pipe.batch_at(k)
        host, hm = step(host, _t_batch(b))
        card, cm = step(card, _t_batch(b, "cuda"))
        assert abs(float(cm["loss"]) - float(hm["loss"])) <= 1e-5 * abs(float(hm["loss"]))
    for h, c in zip(tree_util.flatten(host["params"])[0], tree_util.flatten(card["params"])[0]):
        assert c.device.type == "cuda"
        assert float((c.cpu() - h).abs().max()) <= 2 * 3e-2 * 0.03
