"""The port's in-training and KV compression (``repro_torch.compression``,
``repro_torch.optim``) held against the JAX package, on the CPU.

* kvcache: per-token quantization and the jit-tier prefill codes equal the
  JAX package's bit for bit (codes, scales, tags, bases, reconstruction).
* opt_state: the linear domain equals the JAX package's bit for bit; in the
  log2 domain ``log2``/``exp2`` are not correctly rounded in either library,
  so ``log2 v`` is held within 4 ulps, the encode of the SAME ``log2 v`` is
  bit-identical, and the decoded ``v̂`` keeps the block bound on
  ``|log2 v̂ - log2 v|`` plus 4 ulps of ``log2 v`` and ``2**-20`` for the
  two transcendental roundings.
* grad: at dp = 1 the reduction equals the JAX package's one-device
  ``shard_map`` bit for bit (output, feedback, leaf dtypes); at dp = 2, on a
  spawned two-process ``gloo`` group, it equals the expectation built from
  the JAX package's ``jitmode``: the bf16 sum of the two partials, halved,
  plus feedback, then encode and decode of each shard.
* AdamW: three steps at the ``qwen1.5-smoke`` shapes agree with the JAX
  package within a tolerance derived step by step from the moments' block
  bounds and ``lr`` (:func:`_adamw_allowance`); moment state converts
  between the packages both ways.
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.compression import grad as r_grad
from repro.compression import kvcache as r_kv
from repro.compression import opt_state as r_os
from repro.core import jitmode as rj
from repro.optim import AdamWConfig as RConfig
from repro.optim import init_state as r_init_state
from repro.optim import update as r_update
from repro.optim import warmup_cosine as r_warmup_cosine

from repro_torch import tree as tree_util
from repro_torch.compression import grad as t_grad
from repro_torch.compression import kvcache as t_kv
from repro_torch.compression import opt_state as t_os
from repro_torch.core import jitmode as tj
from repro_torch.optim import AdamWConfig as TConfig
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import init_state as t_init_state
from repro_torch.optim import update as t_update
from repro_torch.optim import warmup_cosine as t_warmup_cosine

CPU = "cpu"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
U = 2.0**-24  # float32 unit roundoff


def _exp2_rel(u):
    """Relative gap between the two packages' float32 ``exp2(u)``: XLA on
    the CPU computes ``exp(u * ln 2)`` in float32, which is off by up to
    ``|u| ln2`` ulps (34 ulps seen at u = -60); torch's is within an ulp."""
    return (np.abs(u) * math.log(2) + 4) * 2.0**-23


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# kvcache
# ---------------------------------------------------------------------------

def _kv_inputs():
    rng = np.random.default_rng(4)
    flat = rng.standard_normal((128, 4, 64)).astype(np.float32) * 5
    offset = (rng.standard_normal((64, 4, 64)) * 0.01 + 3.0).astype(np.float32)
    odd = rng.standard_normal((2, 9, 3, 37)).astype(np.float32)  # hd odd: padded block
    zeros = np.zeros((8, 64), np.float32)
    return {"flat": flat, "offset": offset, "odd": odd, "zeros": zeros}


KV = _kv_inputs()


@pytest.mark.parametrize("name", list(KV))
def test_quantize_tokens_equals_jax(name):
    x = KV[name]
    q, s = t_kv.quantize_tokens(torch.from_numpy(x))
    q_r, s_r = r_kv.quantize_tokens(jnp.asarray(x))
    _same(_np(q), q_r, "codes")
    _same(_np(s), s_r, "scales")
    _same(_np(t_kv.dequantize_tokens(q, s)), r_kv.dequantize_tokens(q_r, s_r), "dequantize")
    assert np.all(np.abs(_np(t_kv.dequantize_tokens(q, s)) - x) <= _np(s)[..., None] * 0.5001)


def test_snr_and_cache_bytes_match_jax():
    x = KV["flat"]
    # two means of squares summed in each library's order: a few ulps of the
    # ratio, far below 1e-4 dB
    assert abs(t_kv.quantization_snr_db(torch.from_numpy(x)) - r_kv.quantization_snr_db(jnp.asarray(x))) < 1e-4
    for args in ((32768, 8, 128, "int8"), (32768, 8, 128, "bf16"), (100, 16, 64, "float32")):
        assert t_kv.cache_bytes(*args) == r_kv.cache_bytes(*args)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["flat", "offset", "odd"])
def test_prefill_codes_equal_jax(name, bits):
    x = KV[name]
    pol_r = r_kv.prefill_policy(x.shape[-1], bits)
    pol_t = t_kv.prefill_policy(x.shape[-1], bits)
    assert dataclasses.asdict(pol_r) == dataclasses.asdict(pol_t)
    c = t_kv.quantize_prefill(torch.from_numpy(x), pol_t)
    c_r = r_kv.quantize_prefill(jnp.asarray(x), pol_r)
    for f in ("codes", "scale", "tags", "base"):
        _same(_np(getattr(c, f)), getattr(c_r, f), f)
    assert (c.orig_hd, c.bits) == (c_r.orig_hd, c_r.bits)
    back = t_kv.dequantize_prefill(c)
    _same(_np(back), r_kv.dequantize_prefill(c_r), "dequantize_prefill")
    bound = _np(c.bound())
    _same(bound, c_r.bound(), "bound")
    err = np.abs(_np(back) - x)
    assert (err.max(axis=-1) <= bound[..., 0]).all()
    # across packages, both ways
    from_jax = t_kv.PrefillCodes.from_numpy({**dataclasses.asdict(jax.tree.map(np.asarray, c_r))}, device=CPU)
    _same(_np(t_kv.dequantize_prefill(from_jax)), r_kv.dequantize_prefill(c_r), "JAX codes, port decode")
    d = c.to_numpy()
    to_jax = r_kv.PrefillCodes(**{**d, **{k: jnp.asarray(d[k]) for k in c.ARRAYS}})
    _same(r_kv.dequantize_prefill(to_jax), _np(back), "port codes, JAX decode")


# ---------------------------------------------------------------------------
# opt_state
# ---------------------------------------------------------------------------

_OS_SHAPES = [(100,), (64, 300), (4, 8, 1000), (), (3, 257)]


def _to_jax_compressed(c):
    d = c.to_numpy()
    return r_os.Compressed(**{**d, **{k: jnp.asarray(d[k]) for k in c.ARRAYS}})


def _from_jax_compressed(c):
    return t_os.Compressed.from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, c)), device=CPU)


@pytest.mark.parametrize("spec", ["", "int8:bs=256", "int4:bs=64", "int8:bs=128:pred=zero"])
@pytest.mark.parametrize("shape", _OS_SHAPES)
def test_opt_state_linear_equals_jax(shape, spec):
    rng = np.random.default_rng(2 + len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    pol_t = tj.JitPolicy.parse(spec) if spec else None
    pol_r = rj.JitPolicy.parse(spec) if spec else None
    c = t_os.compress(torch.from_numpy(x), pol_t)
    c_r = r_os.compress(jnp.asarray(x), pol_r)
    for f in ("codes", "scale", "tags", "base"):
        _same(_np(getattr(c, f)), getattr(c_r, f), f)
    assert (c.orig_last, c.bits, c.domain) == (c_r.orig_last, c_r.bits, c_r.domain)
    back = t_os.decompress(c)
    _same(_np(back), r_os.decompress(c_r), "decompress")
    _same(_np(t_os.decompress(_from_jax_compressed(c_r))), r_os.decompress(c_r), "JAX state, port decode")
    _same(r_os.decompress(_to_jax_compressed(c)), _np(back), "port state, JAX decode")
    assert np.abs(_np(back) - x.reshape(back.shape)).max() <= float(_np(c.scale).max()) * 0.5001


def test_compression_ratio_and_init_match_jax():
    for shape in ((512, 512), (7,), (3, 1000)):
        p = np.zeros(shape, np.float32)
        assert t_os.compression_ratio(torch.from_numpy(p)) == r_os.compression_ratio(jnp.asarray(p))
        for dom in ("linear", "log2"):
            c = t_os.init_compressed(torch.from_numpy(p), domain=dom)
            c_r = r_os.init_compressed(jnp.asarray(p), domain=dom)
            for f in ("codes", "scale", "tags", "base"):
                _same(_np(getattr(c, f)), getattr(c_r, f), f"{dom} {f}")
            assert not _np(t_os.decompress(c)).any()


def _nonneg_input():
    rng = np.random.default_rng(6)
    v = (rng.standard_normal(4096).astype(np.float32) ** 2) * np.logspace(-12, 2, 4096, dtype=np.float32)
    v[::97] = 0.0
    return v.reshape(16, 256)


def _ulp(a):
    return np.spacing(np.abs(np.asarray(a, np.float32))).astype(np.float64)


def test_opt_state_log2_domain_against_jax():
    v = _nonneg_input()
    u_t = _np(torch.log2(torch.clamp_min(torch.from_numpy(v), t_os.NONNEG_FLOOR)))
    u_r = np.asarray(jnp.log2(jnp.maximum(jnp.asarray(v), r_os.NONNEG_FLOOR)))
    assert np.all(np.abs(u_t.astype(np.float64) - u_r) <= 4 * _ulp(u_r))
    # the encode of the same log2 v is bit-identical
    c_same = t_os.compress(torch.from_numpy(np.array(u_r)))
    c_r = r_os.compress_nonneg(jnp.asarray(v))
    for f in ("codes", "scale", "tags", "base"):
        _same(_np(getattr(c_same, f)), getattr(c_r, f), f"log2 encode {f}")
    # the port's own path keeps the pointwise-relative bound
    c = t_os.compress_nonneg(torch.from_numpy(v))
    assert c.domain == "log2"
    back = _np(t_os.decompress_nonneg(c)).astype(np.float64)
    assert (back >= 0).all() and (back[v == 0] == 0).all()
    bs = 256
    mag = _np(tj._sel_magnitude(c.codes.reshape(16, 1, bs), c.tags, 8))
    block = (_np(c.scale) * 0.5 + (np.abs(_np(c.base)) + _np(c.scale) * mag) * 2.0**-22)[:, :1]
    nz = v > 0
    log_err = np.abs(np.log2(back[nz]) - np.log2(v[nz].astype(np.float64)))
    allowance = np.broadcast_to(block, v.shape)[nz] + 4 * _ulp(u_r[nz]) + 2.0**-20
    assert np.all(log_err <= allowance), (log_err - allowance).max()
    # from the same codes the two packages decode within exp2's rounding
    back_same = _np(t_os.decompress(dataclasses.replace(c_same, domain="log2"))).astype(np.float64)
    back_r = np.asarray(r_os.decompress(c_r)).astype(np.float64)
    u_dec = np.asarray(rj.decode_lastaxis(c_r.codes.reshape(16, 1, 256), c_r.scale, c_r.tags, c_r.base, 256, 8))
    assert np.all(np.abs(back_same - back_r) <= _exp2_rel(u_dec) * back_r)
    mixed = np.asarray([1.0] * 255 + [1e-9], np.float32)
    mb = _np(t_os.decompress(t_os.compress_nonneg(torch.from_numpy(mixed))))
    assert 0 < mb[-1] < 1e-7


# ---------------------------------------------------------------------------
# grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_shard_equals_jax(bits):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(5000).astype(np.float32) * 10
    codes, scale = t_grad.quantize_shard(torch.from_numpy(x), bits)
    codes_r, scale_r = r_grad.quantize_shard(jnp.asarray(x), bits)
    _same(_np(codes), codes_r)
    _same(_np(scale), scale_r)
    _same(_np(t_grad.dequantize_shard(codes, scale, 5000, bits)), r_grad.dequantize_shard(codes_r, scale_r, 5000, bits))


@pytest.mark.parametrize("args", [(1 << 20, 8, 8), (1 << 20, 8, 4), (463987712, 1, "int8:bs=512"),
                                  (463987712, 1, "int4:bs=512"), (1001, 3, "int8:bs=128")])
def test_collective_bytes_equal_jax(args):
    n, dp, pol = args
    assert t_grad.collective_bytes(n, dp, pol) == r_grad.collective_bytes(n, dp, pol)


def test_as_policy_matches_jax():
    for p in (8, 4, "int8:bs=256", tj.JitPolicy(tier="int4", bs=64)):
        rp = rj.JitPolicy(**dataclasses.asdict(p)) if isinstance(p, tj.JitPolicy) else p
        assert dataclasses.asdict(t_grad.as_policy(p)) == dataclasses.asdict(r_grad.as_policy(rp))
    with pytest.raises(ValueError):
        t_grad.as_policy(3)


def _grad_tree(rng, scale=1.0):
    """Insertion order differs from sorted order, leaf "b" becomes bf16, and
    the 1289 elements are odd, so dp = 2 pads the vector by one."""
    return {
        "z": (rng.standard_normal((33, 5)) * scale).astype(np.float32),
        "b": (rng.standard_normal(700) * scale).astype(np.float32),
        "a": {"y": (rng.standard_normal((3, 41)) * 100 * scale).astype(np.float32),
              "x": np.cumsum(rng.standard_normal(301)).astype(np.float32) * scale},
    }


def _t_tree(tree):
    out = tree_util.tree_map(torch.from_numpy, tree)
    out["b"] = out["b"].to(torch.bfloat16)
    return out


def _r_tree(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["b"] = out["b"].astype(jnp.bfloat16)
    return out


def test_tree_flattens_in_jax_order():
    tree = _grad_tree(np.random.default_rng(0))
    leaves, treedef = tree_util.flatten(tree)
    r_leaves = jax.tree.leaves(tree)
    assert len(leaves) == len(r_leaves) and all(a is b for a, b in zip(leaves, r_leaves))
    back = tree_util.unflatten(treedef, leaves)
    assert list(back) == sorted(tree) and list(back["a"]) == ["x", "y"]
    nested = [1, (2, None, {"b": 3, "a": 4})]
    assert tree_util.flatten(nested)[0] == jax.tree.leaves(nested)


@pytest.fixture(scope="module")
def one_rank_group(tmp_path_factory):
    """A one-process gloo group, for the dp = 1 reduction in this process."""
    if dist.is_initialized():
        pytest.skip("a default process group already exists in this process")
    store = tmp_path_factory.mktemp("store") / "filestore"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


@pytest.mark.parametrize("policy", ["int8:bs=128", "int4:bs=64", "int8:bs=512:pred=zero+lorenzo1", 8])
def test_reduce_at_dp1_equals_jax_shard_map(one_rank_group, policy):
    from jax.sharding import PartitionSpec as P

    from repro.parallel import compat

    mesh = compat.make_mesh((1,), ("data",))
    rng = np.random.default_rng(7)
    base = _grad_tree(rng)
    fb_t = t_grad.init_feedback(_t_tree(base), 1)
    fb_r = r_grad.init_feedback(_r_tree(base), 1)
    _same(_np(fb_t), fb_r, "init_feedback")

    def body(g, f):
        return r_grad.compressed_reduce_tree(g, f, ("data",), policy)

    specs = jax.tree.map(lambda _: P(), _r_tree(base))
    # compiled once for the three steps (the reference pins jit == eager)
    reduce_r = jax.jit(compat.shard_map(body, mesh, axis_names={"data"}, in_specs=(specs, P("data")),
                                        out_specs=(specs, P("data")), check_vma=False))
    for step in range(3):  # feedback carried across steps
        grads = _grad_tree(rng)
        out_r, fb_r = reduce_r(_r_tree(grads), fb_r)
        out_t, fb_t = t_grad.compressed_reduce_tree(_t_tree(grads), fb_t, one_rank_group, policy)
        _same(_np(fb_t), fb_r, f"feedback, step {step}")
        for path in ("z", "b"):
            want = np.asarray(out_r[path], np.float32)
            assert str(out_t[path].dtype).split(".")[-1] == str(out_r[path].dtype)
            _same(_np(out_t[path].to(torch.float32)), want, f"{path}, step {step}")
        for path in ("x", "y"):
            _same(_np(out_t["a"][path]), out_r["a"][path], f"a/{path}, step {step}")


_DP2_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.compression import grad as G

rank, store, src, dst, policy = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
data = np.load(src)
steps = int(data["steps"])
def tree(step):
    g = lambda k: torch.from_numpy(data[f"{k}_{rank}_{step}"])
    return {"z": g("z"), "b": g("b").to(torch.bfloat16), "a": {"y": g("y"), "x": g("x")}}
fb = G.init_feedback(tree(0), 2)
out = {}
for step in range(steps):
    o, fb = G.compressed_reduce_tree(tree(step), fb, None, policy)
    out[f"fb_{step}"] = fb.numpy()
    out[f"bdtype_{step}"] = np.array(str(o["b"].dtype))
    for k, v in (("z", o["z"]), ("b", o["b"]), ("y", o["a"]["y"]), ("x", o["a"]["x"])):
        out[f"{k}_{step}"] = v.to(torch.float32).numpy()
np.savez(dst, **out)
dist.destroy_process_group()
"""


def _dp2_expectation(partials, policy, steps):
    """The dp = 2 schedule from the JAX package's own functions: bf16 sum of
    the two partial vectors, halved, plus feedback; encode, decode, crop."""
    pol = r_grad.as_policy(policy)
    fbs = [None, None]
    expect = []
    for step in range(steps):
        flats, meta = [], None
        for r in range(2):
            flat, meta = r_grad._flatten_tree(_r_tree(partials[r][step]))
            flats.append(flat)
        n = flats[0].shape[0]
        pad = (-n) % 2
        summed = jnp.pad(flats[0], (0, pad)).astype(jnp.bfloat16) + jnp.pad(flats[1], (0, pad)).astype(jnp.bfloat16)
        m = summed.shape[0] // 2
        parts = []
        for r in range(2):
            shard = summed[r * m:(r + 1) * m].astype(jnp.float32) / 2
            if fbs[r] is not None:
                shard = shard + fbs[r]
            c = rj.encode(shard, pol)
            fbs[r] = shard - rj.decode(c)
            parts.append(rj.decode(c)[:m])
        out = r_grad._unflatten_tree(jnp.concatenate(parts)[:n], meta)
        expect.append((out, [np.asarray(f) for f in fbs]))
    return expect


@pytest.mark.parametrize("policy", ["int8:bs=128", "int4:bs=64"])
def test_reduce_at_dp2_on_a_gloo_group(tmp_path, policy):
    steps = 2
    rng = np.random.default_rng(11)
    partials = [[_grad_tree(rng, scale=1 + r) for _ in range(steps)] for r in range(2)]
    arrays = {"steps": np.array(steps)}
    for r in range(2):
        for s in range(steps):
            t = partials[r][s]
            arrays.update({f"z_{r}_{s}": t["z"], f"b_{r}_{s}": t["b"], f"y_{r}_{s}": t["a"]["y"],
                           f"x_{r}_{s}": t["a"]["x"]})
    src = tmp_path / "inputs.npz"
    np.savez(src, **arrays)
    script = tmp_path / "worker.py"
    script.write_text(_DP2_WORKER)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"), str(src),
                          str(tmp_path / f"out{r}.npz"), policy],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    expect = _dp2_expectation(partials, policy, steps)
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        for s in range(steps):
            out, fbs = expect[s]
            _same(got[f"fb_{s}"], fbs[r], f"rank {r} feedback, step {s}")
            assert str(got[f"bdtype_{s}"]) == "torch.bfloat16"
            for k, want in (("z", out["z"]), ("b", out["b"]), ("y", out["a"]["y"]), ("x", out["a"]["x"])):
                _same(got[f"{k}_{s}"], np.asarray(want, np.float32), f"rank {r} {k}, step {s}")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _smoke_params():
    from repro.configs.qwen1_5_0_5b import SMOKE
    from repro.models.lm import init_lm
    from repro.parallel.plan import ParallelPlan

    shapes = jax.eval_shape(lambda: init_lm(jax.random.PRNGKey(0), SMOKE, ParallelPlan()))
    rng = np.random.default_rng(21)
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.02).astype(np.float32), shapes)
    grads = [jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 10.0 ** rng.uniform(-5, -2)).astype(np.float32),
                          shapes) for _ in range(3)]
    return params, grads


def _moment_block_bound(d) -> np.ndarray:
    """Each element's block bound (``BlockCodes.bound``'s formula: half the
    scale plus the float32 representation slack) for a compressed int8
    moment given as a dict of numpy arrays, from either package."""
    codes, scale, tags, base = (np.asarray(d[f]) for f in ("codes", "scale", "tags", "base"))
    nb = scale.shape[-1]
    q = codes.reshape(codes.shape[:-1] + (nb, codes.shape[-1] // nb)).astype(np.int64)
    sel = np.where((tags == rj.PREDICTOR_TAGS["lorenzo1"])[..., None], np.cumsum(q, axis=-1), q)
    mag = np.abs(sel).max(axis=-1).astype(np.float64)
    b = scale * 0.5 + (np.abs(base) + scale * mag) * 2.0**-22
    return np.repeat(b, q.shape[-1], axis=-1)[..., : d["orig_last"]]


def _adamw_allowance(cfg, grads, t0, m0, v0, jax_params, jax_moments, port_moments, n_total):
    """Per-element |p_port - p_jax| allowance after each step, derived from
    the block bounds and lr, in float64.

    Starting from step ``t0`` with moments that agree within D_m (first
    moment) and D_u (log2 of the second), each step adds:

    * the gradient: both packages clip with ``grad_clip / ||g||``; the two
      norms sum n squares in different orders, relative ``eps_c = n u``,
      which moves the clipped gradient by ``eps_c`` where the clip is
      active (below it both factors are exactly 1);
    * ``m_new``: ``b1 D_m + (1-b1) |g| eps_c`` plus 4 ulps;
      ``v_new`` relative: ``2**D_u - 1 + 2 eps_c`` plus the two packages'
      ``exp2`` gap (:func:`_exp2_rel`);
    * bias corrections ``1 - b**t``: ``pow`` within 4 ulps of ``b**t``;
    * the update ``m̂ / (sqrt(v̂) + eps)``: the change from both, taken at
      the low end of ``sqrt(v̂)``; ``D_p`` grows by ``lr`` times it, plus
      ``lr wd D_p`` and 2 ulps of ``p``;
    * the new moments: each package's decode lies within ITS block bound of
      its ``m_new`` (``log2 v_new``), so ``D_m = D_m_new + B_port + B_jax``
      and likewise for ``D_u``.  Without compressed moments both bounds
      are zero.
    """
    b1, b2, eps, lr, wd = cfg.b1, cfg.b2, cfg.eps, cfg.lr, cfg.weight_decay
    eps_c = n_total * U
    m_prev, v_prev = list(m0), list(v0)
    d_m = [np.zeros_like(m) for m in m0]
    d_u = [np.zeros_like(m) for m in m0]
    d_p = [np.zeros_like(m) for m in m0]
    out = []
    for k, g_tree in enumerate(grads):
        t = t0 + k + 1
        g_leaves = [np.asarray(g, np.float64) for g in jax.tree.leaves(g_tree)]
        gnorm = math.sqrt(sum(float((g**2).sum()) for g in g_leaves))
        clip = min(1.0, cfg.grad_clip / max(gnorm, 1e-12))
        # both clip factors are exactly 1 while both norms stay below the clip
        eps_g = 0.0 if gnorm * (1 + eps_c) <= cfg.grad_clip else eps_c
        bc1, bc2 = 1 - b1**t, 1 - b2**t
        e_b1, e_b2 = 4 * U * b1**t / bc1, 4 * U * b2**t / bc2
        for i, g in enumerate(g_leaves):
            g = g * clip
            m_new = b1 * m_prev[i] + (1 - b1) * g
            v_new = b2 * np.maximum(v_prev[i], 0) + (1 - b2) * g * g
            dm_new = b1 * d_m[i] + (1 - b1) * np.abs(g) * eps_g + 4 * U * np.abs(m_new)
            rel_v = (2.0 ** d_u[i] - 1) + 2 * eps_g + _exp2_rel(np.log2(np.maximum(v_prev[i], 2.0**-100)))
            mhat, vhat = m_new / bc1, v_new / bc2
            dmhat = dm_new / bc1 + np.abs(mhat) * e_b1
            sq = np.sqrt(vhat)
            sq_lo = sq * np.maximum(1 - (rel_v + e_b2) / 2 - 4 * U, 0)
            dupd = dmhat / (sq_lo + eps) + np.abs(mhat) * (1 / (sq_lo + eps) - 1 / (sq + eps))
            d_p[i] = d_p[i] * (1 + lr * wd) + lr * dupd + 2 * U * np.abs(jax_params[k][i])
            du_new = np.log2(1 + rel_v) + 4 * U * np.abs(np.log2(np.maximum(v_new, 2.0**-100)))
            if cfg.compress_moments:
                jm, jv = jax_moments[k]["m"][i], jax_moments[k]["v"][i]
                pm, pv = port_moments[k]["m"][i], port_moments[k]["v"][i]
                d_m[i] = dm_new + _moment_block_bound(jm) + _moment_block_bound(pm)
                d_u[i] = du_new + _moment_block_bound(jv) + _moment_block_bound(pv)
                m_prev[i] = np.asarray(r_os.decompress(_jax_compressed(jm)), np.float64)
                v_prev[i] = np.asarray(r_os.decompress(_jax_compressed(jv)), np.float64)
            else:
                d_m[i], d_u[i] = dm_new, du_new
                m_prev[i], v_prev[i] = m_new, v_new
        out.append([d.copy() for d in d_p])
    return out


def _is_rc(x):
    return isinstance(x, r_os.Compressed)


def _jax_compressed(d):
    return r_os.Compressed(**{**d, **{k: jnp.asarray(d[k]) for k in t_os.Compressed.ARRAYS}})


def _jax_state_to_numpy(state):
    """The JAX package's AdamW state as numpy: compressed moments as dicts
    of their fields (the form ``state_from_numpy`` reads)."""
    def conv(c):
        return dataclasses.asdict(jax.tree.map(np.asarray, c)) if _is_rc(c) else np.asarray(c)

    return {"m": jax.tree.map(conv, state["m"], is_leaf=_is_rc),
            "v": jax.tree.map(conv, state["v"], is_leaf=_is_rc),
            "step": np.asarray(state["step"])}


def _moment_lists(np_state, treedef):
    return {k: tree_util.flatten_up_to(treedef, np_state[k]) for k in ("m", "v")}


def _run_both(r_cfg, t_cfg, p_r, p_t, s_r, s_t, grads):
    """Steps of both packages on the same gradients: per step, JAX's param
    leaves (float64), the port's, and both packages' moments as numpy."""
    treedef = tree_util.flatten(p_t)[1]
    hist = {"jax_p": [], "port_p": [], "jax_m": [], "port_m": [], "norms": []}
    for g in grads:
        p_r, s_r, met_r = r_update(p_r, jax.tree.map(jnp.asarray, g), s_r, r_cfg)
        p_t, s_t, met_t = t_update(p_t, tree_util.tree_map(torch.from_numpy, g), s_t, t_cfg)
        assert int(s_t["step"]) == int(s_r["step"])
        hist["jax_p"].append([np.asarray(a, np.float64) for a in jax.tree.leaves(p_r)])
        hist["port_p"].append([_np(a).astype(np.float64) for a in tree_util.flatten(p_t)[0]])
        hist["jax_m"].append(_moment_lists(_jax_state_to_numpy(s_r), treedef))
        hist["port_m"].append(_moment_lists(t_adamw.state_to_numpy(s_t), treedef))
        hist["norms"].append((float(met_t["grad_norm"]), float(met_r["grad_norm"])))
    return p_r, p_t, s_r, s_t, hist


def _check_within(hist, allowance, n_total):
    for ours, theirs in hist["norms"]:  # eps_c of the allowance
        assert abs(ours - theirs) <= n_total * U * theirs
    for t, (port, jx) in enumerate(zip(hist["port_p"], hist["jax_p"])):
        for i, (a, b) in enumerate(zip(port, jx)):
            over = np.abs(a - b) - allowance[t][i]
            assert np.all(over <= 0), (t, i, over.max())


def _decoded(moments):
    out = {}
    for k in ("m", "v"):
        out[k] = [np.asarray(r_os.decompress(_jax_compressed(c)), np.float64) if isinstance(c, dict)
                  else np.asarray(c, np.float64) for c in moments[k]]
    return out


@pytest.mark.parametrize("compress", [True, False])
def test_adamw_three_steps_match_jax(compress):
    params, grads = _smoke_params()
    r_cfg = RConfig(lr=1e-3, compress_moments=compress, moment_policy="int8:bs=256" if compress else "")
    t_cfg = TConfig(**r_cfg._asdict())
    p_r = jax.tree.map(jnp.asarray, params)
    p_t = tree_util.tree_map(torch.from_numpy, params)
    s_r, s_t = r_init_state(p_r, r_cfg), t_init_state(p_t, t_cfg)
    n_total = sum(a.size for a in jax.tree.leaves(params))
    zeros = [np.zeros(a.shape) for a in jax.tree.leaves(params)]
    p_r, p_t, s_r, s_t, hist = _run_both(r_cfg, t_cfg, p_r, p_t, s_r, s_t, grads)
    _check_within(hist, _adamw_allowance(t_cfg, grads, 0, zeros, zeros, hist["jax_p"], hist["jax_m"],
                                         hist["port_m"], n_total), n_total)

    # the state carries across: JAX's state after three steps continues in
    # the port (``state_from_numpy``), from JAX's parameters, for one step,
    # within the allowance of one step from a shared state
    treedef = tree_util.flatten(p_t)[1]
    shared = _jax_state_to_numpy(s_r)
    s_conv = t_adamw.state_from_numpy(shared, p_t, device=CPU)
    p_conv = tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, p_r))
    start = _decoded(_moment_lists(shared, treedef))
    *_, hist1 = _run_both(r_cfg, t_cfg, p_r, p_conv, s_r, s_conv, grads[:1])
    _check_within(hist1, _adamw_allowance(t_cfg, grads[:1], 3, start["m"], start["v"], hist1["jax_p"],
                                          hist1["jax_m"], hist1["port_m"], n_total), n_total)
    # and the port's state decodes in JAX as in the port
    back = t_adamw.state_to_numpy(s_t)
    assert int(back["step"]) == 3
    for k in ("m", "v"):
        for d, c_t in zip(tree_util.flatten_up_to(treedef, back[k]), tree_util.flatten(s_t[k])[0]):
            if not compress:
                _same(d, _np(c_t), f"port {k} as numpy")
                continue
            # the codes decode to the same bits (v: to the same log2 v); v's
            # exp2 differs by the two libraries' rounding
            c_j = _jax_compressed(d)
            lin = {"domain": "linear"}
            _same(r_os.decompress(dataclasses.replace(c_j, **lin)),
                  _np(t_os.decompress(dataclasses.replace(c_t, **lin))), f"port {k}, JAX decode")
            if k == "v":
                u = np.asarray(r_os.decompress(dataclasses.replace(c_j, **lin)))
                want = np.asarray(r_os.decompress(c_j), np.float64)
                assert np.all(np.abs(_np(t_os.decompress(c_t)) - want) <= _exp2_rel(u) * want)


def test_warmup_cosine_matches_jax():
    steps = np.arange(0, 12000, 37, dtype=np.int32)
    ours = _np(t_warmup_cosine(torch.from_numpy(steps), warmup=100, total=10000))
    theirs = np.asarray(r_warmup_cosine(jnp.asarray(steps), warmup=100, total=10000))
    assert np.all(np.abs(ours - theirs) <= 4 * _ulp(theirs) + 1e-7)


def test_adamw_state_layout_matches_jax():
    params = {"w": np.zeros((3, 300), np.float32), "b": np.zeros(5, np.float32)}
    cfg_t = TConfig(compress_moments=True)
    s_t = t_init_state(tree_util.tree_map(torch.from_numpy, params), cfg_t)
    s_r = r_init_state(jax.tree.map(jnp.asarray, params), RConfig(compress_moments=True))
    for k in ("m", "v"):
        for c_t, c_r in zip(tree_util.flatten(s_t[k])[0],
                            jax.tree.leaves(s_r[k], is_leaf=lambda x: isinstance(x, r_os.Compressed))):
            assert c_t.domain == c_r.domain and c_t.orig_last == c_r.orig_last
            for f in ("codes", "scale", "tags", "base"):
                _same(_np(getattr(c_t, f)), getattr(c_r, f), f"{k} {f}")
    assert sorted(s_t) == sorted(s_r)
