"""The jit-tier codec in torch: SZ3's block-predictor contest as plain tensors.

The JAX package runs this module inside ``jax.jit`` and ``shard_map`` for its
in-training compression paths (gradient all-gather, optimizer moments,
KV-cache prefill).  Here it is torch array math on the device of the tensor
it is given; no hand kernel stands behind it (the reference has no Pallas
kernel for it either).  The same per-block contest as the reference: zero /
order-1 Lorenzo / mean-centered predictors, priced by fixed-length code bits,
emitting fixed-width codes plus per-block side channels.

Two tiers:

* **fixed tier** (:func:`encode` / :func:`decode`): int8 codes, or int4
  packed two per byte, with a per-block scale
  ``snap(max(absmax_resid / radius, 2*eb, SCALE_FLOOR))``; the bound is
  per block, ``|x - x̂| <= BlockCodes.bound()``, for finite inputs.
* **grid tier** (:func:`encode_grid` / :func:`decode_grid`): int32 codes on
  the fixed ``2*eb`` grid, pointwise ``eb`` while
  ``|x - base| / (2*eb) < 2**23``.

The contract the reference states for its own paths holds across the two
packages: every reduction here is order-exact (max, min, abs-max), every
elementwise op is correctly rounded, scale multiplies are by float32
constants and the one divide is tensor by tensor (a true IEEE divide on
every device), so :func:`encode` on a CPU or CUDA tensor, the numpy mirror
:func:`encode_host` and the JAX package's ``encode``/``encode_host`` give
the same codes, scales, tags and bases bit for bit.  Fixed-tier decode is
bit-identical too (its products are exact, see :func:`_snap_scale`);
grid-tier decode is held to the bound's representation slack, not bits.

:func:`host_compress` / :func:`host_decompress` are the door to the
registered prediction engines (``core.pipeline.PIPELINES``) for host-side
callers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

SCALE_FLOOR = 1e-12

#: predictor name -> tag (the 2-bit side-channel vocabulary, hybrid's idiom)
PREDICTOR_TAGS = {"zero": 0, "lorenzo1": 1, "mean": 2}

#: grid-tier codes are clipped here (same guard as fastmode's ``_Q_CLIP``)
_GRID_CLIP = 1 << 30

_LOR = PREDICTOR_TAGS["lorenzo1"]
_MEAN = PREDICTOR_TAGS["mean"]


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JitPolicy:
    """In-loop compression policy: (mode, eb, tier) as one parseable knob.

    ``tier`` picks the container width of the fixed tier (``int8`` /
    ``int4``) or the exact-grid tier (``grid``).  ``mode`` names the bound
    semantics: ``rel`` (per-block REL, ``eb`` only floors the grid) or
    ``abs`` (``eb`` is the grid: fixed tier floors the scale at ``2*eb``,
    grid tier honors it pointwise).
    """

    tier: str = "int8"  # "int8" | "int4" | "grid"
    mode: str = "rel"  # "rel" | "abs"
    eb: float = 0.0
    bs: int = 512
    predictors: Tuple[str, ...] = ("zero", "lorenzo1", "mean")

    def __post_init__(self):
        if self.tier not in ("int8", "int4", "grid"):
            raise ValueError(f"unknown jit codec tier {self.tier!r}")
        if self.mode not in ("rel", "abs"):
            raise ValueError(f"unknown bound mode {self.mode!r}")
        if self.tier == "grid" and self.eb <= 0:
            raise ValueError("grid tier needs a positive eb")
        if self.bs < 2:
            raise ValueError("block size must be >= 2")
        if self.bs > 8192:
            # _snap_scale's exact-product budget: 3 + bits(bs*radius) <= 24
            raise ValueError("block size above 8192 breaks exact decode")
        if self.tier == "int4" and self.bs % 2:
            raise ValueError("int4 packing needs an even block size")
        bad = set(self.predictors) - set(PREDICTOR_TAGS)
        if bad or not self.predictors:
            raise ValueError(f"unknown predictors {sorted(bad)}")

    @property
    def bits(self) -> int:
        return {"int8": 8, "int4": 4, "grid": 32}[self.tier]

    @property
    def radius(self) -> int:
        return 127 if self.tier == "int8" else 7

    @classmethod
    def parse(cls, spec: str) -> "JitPolicy":
        """Parse ``"int8"``, ``"int4:eb=1e-5"``,
        ``"int8:mode=abs:eb=1e-3:bs=256:pred=zero+lorenzo1"``."""
        parts = [p for p in str(spec).split(":") if p]
        if not parts:
            raise ValueError("empty compression policy")
        kw: Dict[str, Any] = {"tier": parts[0]}
        for part in parts[1:]:
            if "=" not in part:
                raise ValueError(f"policy field {part!r} is not key=value")
            k, v = part.split("=", 1)
            if k == "eb":
                kw["eb"] = float(v)
            elif k == "bs":
                kw["bs"] = int(v)
            elif k == "mode":
                kw["mode"] = v
            elif k == "pred":
                kw["predictors"] = tuple(v.split("+"))
            else:
                raise ValueError(f"unknown policy field {k!r}")
        return cls(**kw)


# ---------------------------------------------------------------------------
# code containers
# ---------------------------------------------------------------------------

class ArrayState:
    """Conversion of a codes dataclass to and from numpy arrays.

    ``to_numpy`` gives a dict of the dataclass's fields, tensors as numpy
    arrays; ``from_numpy`` builds the dataclass from such a dict, for
    example from the JAX package's codes of the same name
    (``{f.name: np.asarray(getattr(c, f.name))}``), on ``device`` (default
    ``"cuda"``; pass ``device="cpu"`` to stay on the host)."""

    ARRAYS: Tuple[str, ...] = ()

    def to_numpy(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return out

    @classmethod
    def from_numpy(cls, state: Mapping[str, Any], device=None):
        from .pipeline import resolve_device

        dev = resolve_device(device)
        kw = {}
        for f in dataclasses.fields(cls):
            v = state[f.name]
            if f.name in cls.ARRAYS:
                kw[f.name] = torch.from_numpy(np.array(v)).to(dev)
            else:
                kw[f.name] = v.item() if isinstance(v, np.generic) else v
        return cls(**kw)


@dataclasses.dataclass
class BlockCodes(ArrayState):
    """Fixed-tier codes for one flat vector.

    ``codes`` is int8 ``(nb, bs)``, or uint8 ``(nb, bs//2)`` when
    ``bits == 4`` (two two's-complement nibbles per byte, low nibble first).
    """

    codes: torch.Tensor
    scale: torch.Tensor  # f32 (nb,)
    tags: torch.Tensor  # uint8 (nb,), PREDICTOR_TAGS values
    base: torch.Tensor  # f32 (nb,): 0 / first element / midrange
    n: int  # valid elements (tail block padding cropped on decode)
    bits: int
    bs: int

    ARRAYS = ("codes", "scale", "tags", "base")

    def wire_bytes(self) -> int:
        """Bytes this shard contributes to a code all-gather."""
        return sum(a.numel() * a.element_size() for a in (self.codes, self.scale, self.tags, self.base))

    def bound(self) -> torch.Tensor:
        """Per-block error bound: ``scale/2`` plus float32 representation
        slack ``2**-22 * (|base| + scale*max|q_sum|)``: four ulps of each
        addend of the float32 reconstruction ``base + scale*q``, computed
        from the actual codes (zero-predictor blocks pay essentially none)."""
        mag = _sel_magnitude(self.codes, self.tags, self.bits)
        slack = (self.base.abs() + self.scale * mag) * 2.0**-22
        return self.scale * 0.5 + slack


@dataclasses.dataclass
class GridCodes(ArrayState):
    """Grid-tier codes: int32 on the fixed ``2*eb`` grid (ABS bound)."""

    codes: torch.Tensor  # int32 (nb, bs)
    tags: torch.Tensor  # uint8 (nb,)
    base: torch.Tensor  # f32 (nb,)
    n: int
    eb: float
    bs: int

    ARRAYS = ("codes", "tags", "base")

    def bound(self) -> torch.Tensor:
        """Per-block ``eb`` plus the same float32 representation slack as
        :meth:`BlockCodes.bound` — the grid value is exact but its float32
        assembly ``base + 2*eb*q`` is not."""
        mag = _sel_magnitude(self.codes, self.tags, 32)
        grid = float(np.float32(2.0 * self.eb))
        slack = (self.base.abs() + grid * mag) * 2.0**-22
        return slack + float(np.float32(self.eb))


# ---------------------------------------------------------------------------
# block plumbing
# ---------------------------------------------------------------------------

def _exp2i(e: torch.Tensor) -> torch.Tensor:
    """``2.0**e`` in float32 for int32 ``e`` in the normal range, built from
    its bits: exact on every device, where ``torch.ldexp`` goes through a
    float ``pow`` whose rounding the library does not promise."""
    return ((e + 127) << 23).view(torch.float32)


def _snap_scale(x: torch.Tensor) -> torch.Tensor:
    """Snap x > 0 up to the 3-bit-mantissa grid ``(k/8) * 2**e``, k in 4..8.

    The snapped scale makes the decode product ``scale * q`` exact in
    float32 (``k * q`` needs at most 3 + 21 bits for any admissible block),
    so decode is bit-identical whether or not a compiler contracts
    ``base + scale*q`` into an fma.  ``x >= SCALE_FLOOR`` keeps ``e - 3`` in
    float32's normal range; a non-finite ``x`` snaps to itself, as numpy's
    ``frexp``/``ldexp`` leave it.
    """
    m, e = torch.frexp(x)  # x = m * 2**e, m in [0.5, 1)
    k = torch.ceil(m * 8.0)  # 4..8; exact (pow2 multiply, integral ceil)
    return torch.where(torch.isfinite(x), k * _exp2i(e - 3), x)


def _unpack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    return _unpack_int4(codes) if bits == 4 else codes.to(torch.int32)


def _select_lorenzo(q: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """``cumsum q`` in Lorenzo blocks, ``q`` elsewhere (int32)."""
    lor = torch.cumsum(q, dim=-1, dtype=torch.int32)
    return torch.where((tags == _LOR)[..., None], lor, q)


def _sel_magnitude(codes, tags, bits) -> torch.Tensor:
    """Per-block max integer magnitude of the reconstruction term
    (``max|q|`` direct, ``max|cumsum q|`` under Lorenzo) — feeds the
    representation-slack term of the bound helpers."""
    sel = _select_lorenzo(_unpack_codes(codes, bits), tags)
    if sel.shape[-1] == 0:
        return torch.zeros(sel.shape[:-1], dtype=torch.float32, device=sel.device)
    return sel.abs().amax(dim=-1).to(torch.float32)


def _pad_edge(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last axis by repeating its last element."""
    if not pad:
        return x
    return torch.cat([x, x[..., -1:].expand(*x.shape[:-1], pad)], dim=-1)


def _block_view(x: torch.Tensor, bs: int) -> Tuple[torch.Tensor, int]:
    """(nb, bs) f32 view of a flat vector, tail padded with the edge value
    (the pad rides the tail block's statistics and is cropped on decode)."""
    n = x.shape[0]
    nb = -(-n // bs) if n else 0
    x = _pad_edge(x.to(torch.float32), nb * bs - n)
    return x.reshape(nb, bs), nb


def _shift_right(t: torch.Tensor) -> torch.Tensor:
    """``[0, t_0, ..., t_{bs-2}]`` along the last axis (``t_0 * 0`` first,
    as the reference writes it)."""
    return torch.cat([t[..., :1] * 0, t[..., :-1]], dim=-1)


def _block_stats(xb: torch.Tensor):
    """Order-exact per-block statistics all three predictors price from."""
    d = xb - _shift_right(xb)
    d[..., 0] = 0.0  # first code is 0 under lorenzo1
    a_lor = d.abs().amax(dim=-1)
    a_zero = xb.abs().amax(dim=-1)
    mx = xb.amax(dim=-1)
    mn = xb.amin(dim=-1)
    a_mean = (mx - mn) * 0.5
    center = (mx + mn) * 0.5
    return a_zero, a_lor, a_mean, center


def _select(a_zero, a_lor, a_mean, predictors: Sequence[str], radius: int):
    """argmin of radius-normalized residual range == argmin fixed-length
    code bits (all side channels cost the same).  The normalization
    multiplies by float32 reciprocals, as the reference does (a multiply is
    the same op on every path).  Costs are floored at ``SCALE_FLOOR`` so
    that subnormal-range blocks tie exactly; ties go to the first enabled
    predictor (``torch.argmin`` returns the first minimum on every
    device)."""
    cost = {
        # lorenzo keeps one code of headroom: |t_i - t_{i-1}| can exceed
        # |d_i|/scale by the two rints' crossterm, so it normalizes by
        # radius-1
        "zero": a_zero * float(np.float32(1.0 / radius)),
        "lorenzo1": a_lor * float(np.float32(1.0 / (radius - 1))),
        "mean": a_mean * float(np.float32(1.0 / radius)),
    }
    enabled = [(PREDICTOR_TAGS[p], cost[p]) for p in predictors]
    stack = torch.stack([c for _, c in enabled], dim=-1)
    stack = torch.clamp_min(stack, float(np.float32(SCALE_FLOOR)))
    pick = torch.argmin(stack, dim=-1)
    tag_map = torch.tensor([t for t, _ in enabled], dtype=torch.uint8, device=stack.device)
    return tag_map[pick], stack.amin(dim=-1)


def _pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] -> uint8 nibbles, low nibble = even element."""
    u = codes.to(torch.int32) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_int4` -> int32 codes."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*out.shape[:-2], 2 * out.shape[-2])


def _bases(xb, tags, center):
    zero = torch.zeros((), dtype=torch.float32, device=xb.device)
    return torch.where(tags == _LOR, xb[..., 0], torch.where(tags == _MEAN, center, zero))


# ---------------------------------------------------------------------------
# fixed tier
# ---------------------------------------------------------------------------

def encode_blocks(xb: torch.Tensor, policy: JitPolicy):
    """Core fixed-tier encoder on pre-blocked data ``(..., nb, bs)``.

    Returns ``(codes, scale, tags, base)`` with leading dims preserved."""
    radius = policy.radius
    xb = xb.to(torch.float32)
    a_zero, a_lor, a_mean, center = _block_stats(xb)
    tags, a_eff = _select(a_zero, a_lor, a_mean, policy.predictors, radius)
    scale = _snap_scale(torch.clamp_min(a_eff, float(np.float32(max(2.0 * policy.eb, SCALE_FLOOR)))))
    base = _bases(xb, tags, center)
    t = torch.round((xb - base[..., None]) / scale[..., None])  # tensor divide: IEEE
    codes = torch.where((tags == _LOR)[..., None], t - _shift_right(t), t)
    codes = torch.clamp(codes, -radius, radius).to(torch.int8)
    if policy.bits == 4:
        codes = _pack_int4(codes)
    return codes, scale, tags, base


def decode_blocks(codes, scale, tags, base, bits: int) -> torch.Tensor:
    """Inverse of :func:`encode_blocks` -> f32 blocks ``(..., nb, bs)``."""
    sel = _select_lorenzo(_unpack_codes(codes, bits), tags)  # integer cumsum: exact
    # scale is on the 3-bit mantissa grid, so the product is exact and the
    # sum single-rounded
    return base[..., None] + scale[..., None] * sel.to(torch.float32)


def encode(x: torch.Tensor, policy: JitPolicy):
    """Encode a flat vector on its device; dispatches on tier."""
    if policy.tier == "grid":
        return encode_grid(x, policy)
    flat = x.reshape(-1)
    xb, _nb = _block_view(flat, policy.bs)
    codes, scale, tags, base = encode_blocks(xb, policy)
    return BlockCodes(codes=codes, scale=scale, tags=tags, base=base,
                      n=int(flat.shape[0]), bits=policy.bits, bs=policy.bs)


def decode(c) -> torch.Tensor:
    """Flat f32 reconstruction, tail padding cropped."""
    if isinstance(c, GridCodes):
        return decode_grid(c)
    xb = decode_blocks(c.codes, c.scale, c.tags, c.base, c.bits)
    return xb.reshape(-1)[: c.n]


def encode_lastaxis(x: torch.Tensor, policy: JitPolicy):
    """Block the LAST axis of a shaped array and encode each block.

    Returns ``(codes, scale, tags, base, orig_last)`` with leading dims
    preserved (codes ``(*lead, nb, bs_or_packed)``, side channels
    ``(*lead, nb)``)."""
    x = x.to(torch.float32)
    last = x.shape[-1]
    x = _pad_edge(x, (-last) % policy.bs)
    nb = x.shape[-1] // policy.bs
    xb = x.reshape(*x.shape[:-1], nb, policy.bs)
    codes, scale, tags, base = encode_blocks(xb, policy)
    return codes, scale, tags, base, last


def decode_lastaxis(codes, scale, tags, base, orig_last: int, bits: int) -> torch.Tensor:
    """Inverse of :func:`encode_lastaxis` -> ``(*lead, orig_last)`` f32."""
    xb = decode_blocks(codes, scale, tags, base, bits)
    return xb.reshape(*xb.shape[:-2], xb.shape[-2] * xb.shape[-1])[..., :orig_last]


# ---------------------------------------------------------------------------
# grid tier (exact ABS bound)
# ---------------------------------------------------------------------------

def encode_grid(x: torch.Tensor, policy: JitPolicy) -> GridCodes:
    """Int32 codes on the fixed ``2*eb`` grid: ``|x - x̂| <= eb`` pointwise
    while ``|x - base|/(2*eb) < 2**23``."""
    if policy.eb <= 0:
        raise ValueError("grid tier needs a positive eb")
    flat = x.reshape(-1)
    xb, _nb = _block_view(flat, policy.bs)
    a_zero, a_lor, a_mean, center = _block_stats(xb)
    # same argmin, unnormalized: grid width is common so code bits are
    # monotone in the residual range
    tags, _ = _select(a_zero, a_lor, a_mean, policy.predictors, 2)
    base = _bases(xb, tags, center)
    inv = float(np.float32(1.0 / (2.0 * policy.eb)))
    t = torch.round((xb - base[..., None]) * inv)
    t = torch.clamp(t, -_GRID_CLIP, _GRID_CLIP).to(torch.int32)
    codes = torch.where((tags == _LOR)[..., None], t - _shift_right(t), t)
    return GridCodes(codes=codes, tags=tags, base=base, n=int(flat.shape[0]),
                     eb=float(policy.eb), bs=policy.bs)


def decode_grid(c: GridCodes) -> torch.Tensor:
    """Flat f32 reconstruction; the ``2*eb`` grid is an arbitrary float, so
    this is held to the bound, not to another path's bits."""
    sel = _select_lorenzo(c.codes, c.tags)
    xb = c.base[..., None] + float(np.float32(2.0 * c.eb)) * sel.to(torch.float32)
    return xb.reshape(-1)[: c.n]


def grid_code_bits(c: GridCodes) -> float:
    """Fixed-length coded size of a grid-tier result in bits/element
    (per-block width = bitlength(max|q|), plus the base/tag/width side
    channels)."""
    q = c.codes.detach().cpu().numpy()
    if q.size == 0:
        return 0.0
    m = np.abs(q).max(axis=-1).astype(np.int64)
    w = np.zeros(m.shape, np.float64)
    nz = m > 0
    w[nz] = np.floor(np.log2(m[nz].astype(np.float64))) + 1.0
    per_block = c.bs * (w + 1.0) + 32.0 + 8.0 + 2.0
    return float(per_block.sum() / max(1, c.n))


# ---------------------------------------------------------------------------
# numpy host mirror (bit-identical to encode/decode; tests pin this)
# ---------------------------------------------------------------------------

def encode_host(x, policy: JitPolicy) -> BlockCodes:
    """Numpy mirror of :func:`encode` (fixed tier) — same op order, same
    reductions.  Returns :class:`BlockCodes` of CPU tensors."""
    flat = np.asarray(x, np.float32).reshape(-1)
    n = flat.size
    nb = -(-n // policy.bs) if n else 0
    pad = nb * policy.bs - n
    if pad:
        flat = np.pad(flat, (0, pad), mode="edge")
    xb = flat.reshape(nb, policy.bs)
    radius = policy.radius
    d = np.diff(xb, axis=-1, prepend=xb[..., :1])
    d[..., 0] = 0.0
    empty = np.zeros(nb, np.float32)
    a_lor = np.abs(d).max(axis=-1) if xb.size else empty
    a_zero = np.abs(xb).max(axis=-1) if xb.size else empty
    mx = xb.max(axis=-1) if xb.size else empty
    mn = xb.min(axis=-1) if xb.size else empty
    a_mean = ((mx - mn) * np.float32(0.5)).astype(np.float32)
    center = ((mx + mn) * np.float32(0.5)).astype(np.float32)
    cost = {
        "zero": a_zero * np.float32(1.0 / radius),
        "lorenzo1": a_lor * np.float32(1.0 / (radius - 1)),
        "mean": a_mean * np.float32(1.0 / radius),
    }
    enabled = [(PREDICTOR_TAGS[p], cost[p]) for p in policy.predictors]
    stack = np.stack([c for _, c in enabled], axis=-1)
    stack = np.maximum(stack, np.float32(SCALE_FLOOR))  # mirrors _select
    pick = np.argmin(stack, axis=-1)
    tags = np.asarray([t for t, _ in enabled], np.uint8)[pick]
    a_eff = np.min(stack, axis=-1)
    scale = np.maximum(a_eff, np.float32(max(2.0 * policy.eb, SCALE_FLOOR))).astype(np.float32)
    m, e = np.frexp(scale)  # mantissa-grid snap, mirrors _snap_scale
    scale = np.ldexp(np.ceil(m * 8.0).astype(np.float32), e - 3).astype(np.float32)
    base = np.where(
        tags == _LOR,
        xb[..., 0] if xb.size else empty,
        np.where(tags == _MEAN, center, np.float32(0.0)),
    ).astype(np.float32)
    t = np.rint((xb - base[..., None]) / scale[..., None]).astype(np.float32)
    prev_t = np.concatenate([t[..., :1] * 0, t[..., :-1]], axis=-1)
    codes = np.where((tags == _LOR)[..., None], t - prev_t, t)
    codes = np.clip(codes, -radius, radius).astype(np.int8)
    if policy.bits == 4:
        u = codes.astype(np.uint8)
        codes = (u[..., 0::2] & 0xF) | ((u[..., 1::2] & 0xF) << 4)
    return BlockCodes(
        codes=torch.from_numpy(codes), scale=torch.from_numpy(scale),
        tags=torch.from_numpy(tags), base=torch.from_numpy(base),
        n=n, bits=policy.bits, bs=policy.bs,
    )


def decode_host(c: BlockCodes) -> np.ndarray:
    """Numpy mirror of :func:`decode` (fixed tier)."""
    arr = {k: v.detach().cpu().numpy() for k, v in (("codes", c.codes), ("scale", c.scale),
                                                    ("tags", c.tags), ("base", c.base))}
    codes = arr["codes"]
    if c.bits == 4:
        lo = (codes & 0xF).astype(np.int32)
        hi = ((codes >> 4) & 0xF).astype(np.int32)
        lo = np.where(lo > 7, lo - 16, lo)
        hi = np.where(hi > 7, hi - 16, hi)
        q = np.stack([lo, hi], axis=-1).reshape(codes.shape[:-1] + (-1,))
    else:
        q = codes.astype(np.int32)
    lor = np.cumsum(q, axis=-1)
    sel = np.where((arr["tags"] == _LOR)[..., None], lor, q)
    xb = arr["base"][..., None] + arr["scale"][..., None] * sel.astype(np.float32)
    return xb.reshape(-1)[: c.n].astype(np.float32)


# ---------------------------------------------------------------------------
# host fallback: the registered prediction engines
# ---------------------------------------------------------------------------

def host_compress(arr, engine: str = "sz3_auto", conf=None, device=None):
    """Route an array through a REGISTERED pipeline of the port (the
    facade's door to the entropy-coded engines), on ``device`` (default
    ``"cuda"``).  The default ``sz3_auto`` contests every coder family per
    chunk; an unregistered engine raises ``KeyError`` naming the registered
    ones."""
    from . import pipeline as pl_mod
    from .transform import sz3_auto  # noqa: F401 (registers sz3_auto)

    if engine not in pl_mod.PIPELINES:
        raise KeyError(f"unknown engine {engine!r}; registered: {sorted(pl_mod.PIPELINES)}")
    return pl_mod.PIPELINES[engine](device=device).compress(arr, conf)


def host_decompress(blob: bytes, device=None):
    from . import pipeline as pl_mod

    return pl_mod.decompress(blob, device=device)
