"""The port's jit-tier codec (``repro_torch.core.jitmode``) held against the
JAX package's ``repro.core.jitmode``, on the CPU.

For the five policies of ``tests/test_jitmode.py`` on that file's corpus
(subnormals, huge offsets, constants, ragged tails, sign flips) plus seeded
random arrays:

* encode is bit-identical: the port's ``encode`` on a CPU tensor, the
  port's numpy mirror ``encode_host``, the JAX package's ``encode_host``
  and its eager ``encode`` give the same codes, scales, tags and bases
  (grid tier: codes, tags, bases against JAX ``encode``);
* fixed-tier decode is bit-identical in both packages and the mirrors;
* grid-tier decode agrees within the bound's representation slack
  ``2**-22 * (|base| + 2*eb*|q_sum|)``: the ``2*eb`` grid is an arbitrary
  float, so a contracted fma may move the sum by an ulp of the product
  (the reference pins the same asymmetry between its own paths);
* the bound holds, and codes decode across packages both ways, through
  ``to_numpy``/``from_numpy``.

Floats are not drawn with hypothesis here: in this suite hypothesis aborts
before its first example (a subnormal-float check of the test process), so
the corpus and seeded arrays carry the sweep.  The ``cuda``-marked tests run
the same encode on a card
(``python -m pytest -q -m cuda tests/test_torch_jitmode.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.core import jitmode as rj
except ImportError:  # a card's machine without JAX runs the cuda-marked tests only
    jnp = rj = None

import repro_torch.core as tc
from repro_torch.core import jitmode as tj

CPU = "cpu"

POLICIES = [
    "int8:bs=256",
    "int4:bs=64",
    "int8:mode=abs:eb=1e-3:bs=128",
    "grid:eb=1e-3:bs=256",
    "grid:eb=1e-4:mode=abs:bs=128",
]

#: the deterministic corpus of tests/test_jitmode.py
_CORPUS = [
    np.zeros(300, np.float32),
    np.full(511, 7.25, np.float32),
    np.linspace(-1e4, 1e4, 1000).astype(np.float32),
    (np.logspace(-40, 30, 777, dtype=np.float64)).astype(np.float32),
    np.array([1e-39, -1e-39, 5e-38, 0.0, 1.0], np.float32),  # subnormals
    np.cumsum(np.ones(2048, np.float32)) + 1e6,  # huge offset, lorenzo regime
    np.where(np.arange(513) % 2 == 0, 1.0, -1.0).astype(np.float32),
    np.repeat(np.float32(3.0), 64) * np.float32(2.0) ** -120,
]


def _seeded():
    rng = np.random.default_rng(1013)
    walk = (np.cumsum(rng.standard_normal(4099)) * 0.01 + 300.0).astype(np.float32)
    wide = (rng.standard_normal(3001) * np.exp(rng.uniform(-30, 30, 3001))).astype(np.float32)
    mixed = np.concatenate([np.zeros(256), rng.standard_normal(300) * 1e3, np.full(129, -2.5),
                            np.linspace(0, 1, 777)]).astype(np.float32)
    tiny = (rng.standard_normal(1000) * 1e-30).astype(np.float32)  # cost floor ties
    return [rng.standard_normal(5000).astype(np.float32) * 100, walk, wide, mixed, tiny,
            np.array([np.float32(1.0)])]


INPUTS = {f"corpus{i}": x for i, x in enumerate(_CORPUS)}
INPUTS.update({f"seeded{i}": x for i, x in enumerate(_seeded())})


def _fit_policy(x: np.ndarray, spec: str):
    """``tests/test_jitmode.py``'s rule: grid policies scale ``eb`` to the
    data range (the grid tier's documented domain); returns the JAX
    package's policy (None without JAX) and the port's."""
    pol = tj.JitPolicy.parse(spec)
    if pol.tier == "grid" and x.size:
        rng = float(np.max(np.abs(x)))
        if rng > 0:
            pol = dataclasses.replace(pol, eb=max(pol.eb, rng * 2.0**-20))
    return (rj.JitPolicy(**dataclasses.asdict(pol)) if rj else None), pol


@functools.lru_cache(maxsize=None)
def _jax_encode(spec: str, name: str):
    """JAX ``encode`` of one input (each test of a case reuses it)."""
    rpol, _ = _fit_policy(INPUTS[name], spec)
    return rj.encode(jnp.asarray(INPUTS[name]), rpol)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _fields(pol):
    return ("codes", "tags", "base") if pol.tier == "grid" else ("codes", "scale", "tags", "base")


def _grid_slack(c) -> np.ndarray:
    """The representation slack of ``GridCodes.bound()`` per element."""
    q = np.asarray(c.codes, np.int64)
    sel = np.where((np.asarray(c.tags) == rj.PREDICTOR_TAGS["lorenzo1"])[:, None], np.cumsum(q, axis=-1), q)
    grid = np.float32(2.0 * c.eb)
    return (np.abs(np.asarray(c.base))[:, None] + grid * np.abs(sel)) * np.float32(2.0**-22)


def _to_jax(c):
    d = c.to_numpy()
    cls = rj.GridCodes if isinstance(c, tj.GridCodes) else rj.BlockCodes
    arrays = {k: jnp.asarray(d[k]) for k in c.ARRAYS}
    return cls(**{**d, **arrays})


# ---------------------------------------------------------------------------
# encode: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("spec", POLICIES)
def test_encode_is_bit_identical_to_jax(spec, name):
    x = INPUTS[name]
    rpol, tpol = _fit_policy(x, spec)
    ours = tj.encode(torch.from_numpy(x), tpol)
    jax_enc = _jax_encode(spec, name)
    for f in _fields(tpol):
        _same(getattr(ours, f).numpy(), getattr(jax_enc, f), f"{spec} {name}: {f} port != JAX encode")
    if tpol.tier == "grid":
        assert (ours.n, ours.eb, ours.bs) == (jax_enc.n, jax_enc.eb, jax_enc.bs)
        return
    assert (ours.n, ours.bits, ours.bs) == (jax_enc.n, jax_enc.bits, jax_enc.bs)
    jax_host = rj.encode_host(x, rpol)
    mirror = tj.encode_host(x, tpol)
    for f in _fields(tpol):
        _same(getattr(ours, f).numpy(), getattr(jax_host, f), f"{spec} {name}: {f} port != JAX encode_host")
        _same(getattr(mirror, f).numpy(), getattr(jax_host, f), f"{spec} {name}: {f} mirror != JAX encode_host")
    assert ours.wire_bytes() == jax_enc.wire_bytes() == mirror.wire_bytes()


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("spec", POLICIES)
def test_decode_and_bound(spec, name):
    """Fixed tier: decode bit-identical to JAX ``decode`` and both mirrors;
    grid tier: within the representation slack of JAX ``decode``.  Both:
    every block within ``bound()``, which equals JAX's bound bit for bit."""
    x = INPUTS[name]
    rpol, tpol = _fit_policy(x, spec)
    ours = tj.encode(torch.from_numpy(x), tpol)
    jax_enc = _jax_encode(spec, name)
    back = tj.decode(ours).numpy()
    jax_back = np.asarray(rj.decode(jax_enc))
    if tpol.tier == "grid":
        slack = _grid_slack(jax_enc).reshape(-1)[: x.size]
        assert (np.abs(back - jax_back) <= slack).all(), (spec, name)
    else:
        _same(back, jax_back, f"{spec} {name}: decode port != JAX")
        _same(tj.decode_host(ours), jax_back, f"{spec} {name}: decode_host port != JAX")
        _same(rj.decode_host(rj.encode_host(x, rpol)), back, f"{spec} {name}: JAX decode_host != port")
    bound = ours.bound().numpy()
    _same(bound, jax_enc.bound(), f"{spec} {name}: bound port != JAX")
    nb = bound.shape[0]
    err = np.pad(np.abs(back - x), (0, nb * tpol.bs - x.size)).reshape(nb, tpol.bs)
    assert (err.max(axis=1, initial=0.0) <= bound).all(), (spec, name, err.max(initial=0.0), bound.max(initial=0.0))


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("spec", POLICIES)
def test_codes_cross_decode_both_ways(spec, name):
    x = INPUTS[name]
    rpol, tpol = _fit_policy(x, spec)
    jax_enc = _jax_encode(spec, name)
    ours = tj.encode(torch.from_numpy(x), tpol)
    # JAX codes -> the port
    cls = tj.GridCodes if tpol.tier == "grid" else tj.BlockCodes
    state = {f.name: getattr(jax_enc, f.name) for f in dataclasses.fields(jax_enc)}
    state = {k: (np.asarray(v) if k in cls.ARRAYS else v) for k, v in state.items()}
    from_jax = cls.from_numpy(state, device=CPU)
    for f in _fields(tpol):
        _same(getattr(from_jax, f).numpy(), getattr(jax_enc, f), f"{spec} {name}: {f} from_numpy")
    # the port's codes -> JAX
    to_jax = _to_jax(ours)
    if tpol.tier == "grid":
        slack = _grid_slack(jax_enc).reshape(-1)[: x.size]
        assert (np.abs(tj.decode(from_jax).numpy() - np.asarray(rj.decode(jax_enc))) <= slack).all()
        assert (np.abs(np.asarray(rj.decode(to_jax)) - tj.decode(ours).numpy()) <= slack).all()
    else:
        _same(tj.decode(from_jax).numpy(), rj.decode(jax_enc), f"{spec} {name}: JAX codes, port decode")
        _same(rj.decode(to_jax), tj.decode(ours).numpy(), f"{spec} {name}: port codes, JAX decode")


# ---------------------------------------------------------------------------
# the pieces that could break bit identity
# ---------------------------------------------------------------------------

def _scales_to_snap():
    """Every positive float32 the codec can snap: the corpus's own block
    ranges, the floor, powers of two, and mantissas next to each grid step."""
    vals = [np.float32(tj.SCALE_FLOOR), np.float32(1.0), np.float32(3.4e38)]
    for x in _CORPUS + _seeded():
        if x.size:
            vals.extend(np.abs(x[x != 0]).astype(np.float32).tolist())
    m = np.arange(4, 9, dtype=np.float32) / 8
    for e in (-30, -1, 0, 7, 100):
        for mm in m:
            v = np.ldexp(mm, e).astype(np.float32)
            vals.extend([v, np.nextafter(v, np.float32(np.inf)), np.nextafter(v, np.float32(0))])
    v = np.asarray(vals, np.float32)
    return np.maximum(v, np.float32(tj.SCALE_FLOOR))


def test_frexp_and_snap_match_numpy():
    """``torch.frexp`` against ``np.frexp`` (subnormal inputs included), and
    the snapped scale against the reference's ``frexp``/``ldexp`` in numpy."""
    raw = np.concatenate([_scales_to_snap(), np.array([1e-39, 5e-38, 1.4e-45], np.float32)])
    m, e = torch.frexp(torch.from_numpy(raw))
    nm, ne = np.frexp(raw)
    _same(m.numpy(), nm, "frexp mantissa")
    np.testing.assert_array_equal(e.numpy(), ne)
    s = _scales_to_snap()
    nm, ne = np.frexp(s)
    with np.errstate(over="ignore"):  # 3.4e38 snaps up to inf, in both packages
        want = np.ldexp(np.ceil(nm * 8.0).astype(np.float32), ne - 3).astype(np.float32)
    _same(tj._snap_scale(torch.from_numpy(s)).numpy(), want, "snap")
    _same(tj._snap_scale(torch.from_numpy(s)).numpy(), rj._snap_scale(jnp.asarray(s)), "snap vs JAX")
    inf = torch.tensor([np.inf, np.nan], dtype=torch.float32)
    got = tj._snap_scale(inf)
    assert got[0] == np.inf and torch.isnan(got[1])


def test_argmin_ties_go_to_the_first_enabled_predictor():
    z = torch.tensor([0.0, 1e-30, 5.0], dtype=torch.float32)
    # all three costs floored to SCALE_FLOOR in the first two blocks: ties
    tags, _ = tj._select(z, z, z, ("mean", "lorenzo1", "zero"), 127)
    assert tags.tolist()[:2] == [tj.PREDICTOR_TAGS["mean"]] * 2
    tags, _ = tj._select(z, z, z, ("lorenzo1", "zero", "mean"), 127)
    assert tags.tolist()[:2] == [tj.PREDICTOR_TAGS["lorenzo1"]] * 2


@pytest.mark.parametrize("bits", [8, 4])
def test_lastaxis_matches_jax(bits):
    rng = np.random.default_rng(77 + bits)
    x = (rng.standard_normal((3, 5, 203)) * np.exp(rng.uniform(-5, 5, (3, 5, 1)))).astype(np.float32)
    pol = rj.JitPolicy(tier=f"int{bits}", bs=64)
    ours = tj.encode_lastaxis(torch.from_numpy(x), tj.JitPolicy(tier=f"int{bits}", bs=64))
    theirs = rj.encode_lastaxis(jnp.asarray(x), pol)
    for a, b, f in zip(ours[:4], theirs[:4], ("codes", "scale", "tags", "base")):
        _same(a.numpy(), b, f"lastaxis {f}")
    assert ours[4] == theirs[4] == 203
    back = tj.decode_lastaxis(*ours, bits).numpy()
    _same(back, rj.decode_lastaxis(*theirs, bits), "decode_lastaxis")
    assert back.shape == x.shape


def test_int4_pack_roundtrip():
    codes = torch.arange(-8, 8, dtype=torch.int8).repeat(3).reshape(3, 16)
    packed = tj._pack_int4(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 8)
    _same(packed.numpy(), rj._pack_int4(jnp.asarray(codes.numpy())), "pack")
    assert torch.equal(tj._unpack_int4(packed), codes.to(torch.int32))


@pytest.mark.parametrize("name", ["corpus2", "corpus5", "seeded0", "seeded3"])
def test_grid_code_bits_match_jax(name):
    x = INPUTS[name]
    rpol, tpol = _fit_policy(x, "grid:eb=1e-3:bs=256")
    assert tj.grid_code_bits(tj.encode(torch.from_numpy(x), tpol)) == rj.grid_code_bits(rj.encode(jnp.asarray(x), rpol))


@pytest.mark.parametrize("spec", POLICIES + ["int8", "int4:eb=1e-5", "int8:mode=abs:eb=1e-3:bs=256:pred=zero+lorenzo1"])
def test_policy_parse_matches_jax(spec):
    assert dataclasses.asdict(tj.JitPolicy.parse(spec)) == dataclasses.asdict(rj.JitPolicy.parse(spec))
    p = tj.JitPolicy.parse(spec)
    assert (p.bits, p.radius) == (rj.JitPolicy.parse(spec).bits, rj.JitPolicy.parse(spec).radius)


@pytest.mark.parametrize("spec", ["", "int2", "int8:bs", "int8:foo=1", "grid", "int8:bs=1",
                                  "int8:bs=16384", "int4:bs=63", "int8:pred=cubic", "int8:mode=pw"])
def test_policy_errors_match_jax(spec):
    with pytest.raises(ValueError) as ours:
        tj.JitPolicy.parse(spec)
    with pytest.raises(ValueError) as theirs:
        rj.JitPolicy.parse(spec)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("spec", ["int8:bs=256", "int4:bs=64", "grid:eb=1e-3:bs=256"])
def test_empty_input(spec):
    c = tj.encode(torch.zeros(0), tj.JitPolicy.parse(spec))
    assert c.n == 0 and c.codes.shape[0] == 0
    assert tj.decode(c).shape == (0,) and c.bound().shape == (0,)


def test_host_compress_names_the_registered_engines():
    """The default engine ``sz3_auto`` round-trips within the bound and
    writes the JAX package's bytes; an unknown engine raises ``KeyError``
    naming the registered ones."""
    x = np.cumsum(np.random.default_rng(3).standard_normal(5000)).astype(np.float32)
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=1e-3)
    res = tj.host_compress(x, conf=conf, device=CPU)
    assert tc.parse_header(res.blob)[0]["kind"] == "chunked"
    back = tj.host_decompress(res.blob, device=CPU).numpy()
    assert np.abs(back - x).max() <= 1e-3
    import repro.core as rc

    assert res.blob == rj.host_compress(x, conf=rc.CompressionConfig(mode=rc.ErrorBoundMode.ABS, eb=1e-3)).blob
    with pytest.raises(KeyError, match="sz3_wavelet") as err:
        tj.host_compress(x, "sz3_wavelet", conf, device=CPU)
    for name in ("sz3_auto", "sz3_fast", "sz3_hybrid", "sz3_lorenzo", "sz3_quality", "sz3_transform"):
        assert name in str(err.value)
    res = tj.host_compress(x, "sz3_lorenzo", conf, device=CPU)
    assert np.abs(tj.host_decompress(res.blob, device=CPU).numpy() - x).max() <= 1e-3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this test runs the codec on a card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("spec", POLICIES)
def test_cuda_encode_equals_host_mirror(cuda_device, spec, name):
    """The codec on a CUDA tensor: encode bit-identical to the port's CPU
    encode (and, fixed tier, to ``encode_host``), fixed-tier decode too."""
    x = INPUTS[name]
    _, tpol = _fit_policy(x, spec)
    card = tj.encode(torch.from_numpy(x).to(cuda_device), tpol)
    cpu = tj.encode(torch.from_numpy(x), tpol)
    for f in _fields(tpol):
        _same(getattr(card, f).cpu().numpy(), getattr(cpu, f).numpy(), f"{spec} {name}: {f} card != cpu")
    if tpol.tier != "grid":
        host = tj.encode_host(x, tpol)
        for f in _fields(tpol):
            _same(getattr(card, f).cpu().numpy(), getattr(host, f).numpy(), f"{spec} {name}: {f} card != host")
        _same(tj.decode(card).cpu().numpy(), tj.decode_host(host), f"{spec} {name}: decode card != host")


@pytest.mark.cuda
def test_cuda_frexp_snap_and_ties(cuda_device):
    raw = np.concatenate([_scales_to_snap(), np.array([1e-39, 5e-38, 1.4e-45], np.float32)])
    m, e = torch.frexp(torch.from_numpy(raw).to(cuda_device))
    nm, ne = np.frexp(raw)
    _same(m.cpu().numpy(), nm, "frexp mantissa on the card")
    np.testing.assert_array_equal(e.cpu().numpy(), ne)
    s = _scales_to_snap()
    _same(tj._snap_scale(torch.from_numpy(s).to(cuda_device)).cpu().numpy(),
          tj._snap_scale(torch.from_numpy(s)).numpy(), "snap on the card")
    z = torch.tensor([0.0, 1e-30, 5.0], dtype=torch.float32, device=cuda_device)
    tags, _ = tj._select(z, z, z, ("mean", "lorenzo1", "zero"), 127)
    assert tags.tolist()[:2] == [tj.PREDICTOR_TAGS["mean"]] * 2
