"""The plain reference of an error-bounded lossy compressor, and its judge.

SZ3's guarantee for the REL and ABS modes is one absolute bound on every
point: ``max |x_hat - x| <= abs_eb``, with ``abs_eb = eb * (max(x) - min(x))``
under REL (over the finite values; a bound that resolves to 0 becomes the
smallest positive float64, as SZ does) and ``abs_eb = eb`` under ABS.  Before
the program sees a field, :func:`seal` derives that bound from the input and
takes a digest of its bits; the judge holds each field to the sealed bound,
reads the container from its bytes alone (:mod:`.container`) and holds each
field to four numbers:

* ``err_over_bound``: ``max |x_hat - x| / abs_eb``, in float64; NaN reads as
  infinity.  Its limit is the guarantee itself, 1.
* ``abs_eb_gap``: the largest relative gap between the ``abs_eb`` that a
  header (each chunk's, in a multi-chunk container) records and the one
  derived here.  The arithmetic is the same, so the limit is 0.
* ``inputs_changed``: fields whose bits differ from their digest once the
  window has closed (a program that wrote into its input would otherwise
  be judged against what it wrote).  Limit 0.
* ``blob_faults``: what is wrong with the blob the ratio is counted from:
  a prologue or chunk table that does not parse or tile, a shape or dtype
  other than the input's, a v1 body whose lossless stream does not inflate
  to the declared ``enc_len + q_len``, a reported ratio other than input bytes over blob bytes,
  a decoded field of another shape or dtype.  Limit 0.

:func:`plain_codec` is the reference put in the program's place: each value
snapped to the grid of step ``2 * abs_eb``, computed in a stated precision,
with the input (as that precision holds it) kept where the snapped value
misses the bound.  In float32 or float64 it keeps the bound; in bfloat16 it is the
control that has to come out as not correct.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional

import torch

from portbench.reference import container

#: limit of each number the judge compares (value <= limit passes)
LIMITS = {"err_over_bound": 1.0, "abs_eb_gap": 0.0, "inputs_changed": 0, "blob_faults": 0}

_DTYPE_STR = {torch.float32: "<f4", torch.float64: "<f8"}
_TINY = 2.2250738585072014e-308  # smallest positive normal float64
_BITS = {4: torch.int32, 8: torch.int64}
_DIGEST_BLOCK = 1 << 24


def abs_bound(x: torch.Tensor, mode: str, eb: float) -> float:
    """The absolute bound that ``mode`` and ``eb`` give for ``x``."""
    if mode == "abs":
        return float(eb)
    if mode != "rel":
        raise ValueError(f"the reference judges the abs and rel modes, not {mode!r}")
    fin = x if bool(torch.isfinite(x).all()) else x[torch.isfinite(x)]
    if not fin.numel():
        return _TINY
    bound = float(eb) * (float(fin.max()) - float(fin.min()))
    return bound if bound > 0 else _TINY


def digest(x: torch.Tensor) -> tuple:
    """Two sums of ``x``'s bits as integers (plain and weighted by
    position, each wrapping at 64 bits), in blocks so that it needs little
    memory: a write into ``x`` changes them."""
    bits = x.contiguous().reshape(-1).view(_BITS[x.element_size()])
    plain = torch.zeros((), dtype=torch.int64, device=x.device)
    weighted = torch.zeros((), dtype=torch.int64, device=x.device)
    for s in range(0, bits.numel(), _DIGEST_BLOCK):
        b = bits[s : s + _DIGEST_BLOCK].to(torch.int64)
        plain += b.sum()
        weighted += (b * torch.arange(s + 1, s + 1 + b.numel(), dtype=torch.int64, device=x.device)).sum()
    return int(plain), int(weighted)


@dataclasses.dataclass(frozen=True)
class Seal:
    """What the judge keeps of an input before the program sees it."""

    abs_eb: float
    digest: tuple


def seal(x: torch.Tensor, mode: str, eb: float) -> Seal:
    return Seal(abs_bound(x, mode, eb), digest(x))


def plain_codec(x: torch.Tensor, abs_eb: float, dtype: torch.dtype) -> torch.Tensor:
    """``x`` snapped to the grid of step ``2 * abs_eb``, computed in
    ``dtype``; a point whose snapped value lies further than ``abs_eb`` from
    its input as ``dtype`` holds it keeps that input.  Returns ``x``'s dtype."""
    xs = x.to(dtype)
    step = torch.tensor(2.0 * abs_eb, dtype=dtype, device=x.device)
    out = (torch.round(xs / step) * step).to(x.dtype)
    miss = (out.to(torch.float64) - xs.to(torch.float64)).abs() > abs_eb
    return torch.where(miss, xs.to(x.dtype), out)


def max_error(x: torch.Tensor, decoded: torch.Tensor) -> float:
    """``max |decoded - x|`` in float64; NaN or infinity reads as infinity."""
    err = (decoded.to(torch.float64) - x.to(torch.float64)).abs().max()
    err = float(err)
    return err if math.isfinite(err) else math.inf


def _inflate(lossless: str, body: bytes) -> Optional[int]:
    """Length of the body inflated by ``lossless``; None where this
    environment lacks the backend."""
    if lossless == "none":
        return len(body)
    if lossless == "gzip":
        return len(zlib.decompress(body))
    if lossless == "zstd":
        try:
            import zstandard
        except ImportError:
            return None
        return len(zstandard.ZstdDecompressor().decompress(body))
    return None


@dataclasses.dataclass
class FieldVerdict:
    err_over_bound: float
    abs_eb_gap: float
    blob_faults: List[str]
    input_changed: bool = False


def blob_faults(x: torch.Tensor, blob: bytes, ratio: float, abs_eb: float) -> (float, List[str]):
    """(abs_eb gap, faults) of one blob against the input it encodes."""
    faults: List[str] = []
    if ratio != x.numel() * x.element_size() / max(1, len(blob)):
        faults.append(f"reported ratio {ratio} is not {x.numel() * x.element_size()} / {len(blob)} bytes")
    try:
        top, _ = container.parse(blob)
        parts = container.leaves(blob)
    except (container.FormatError, KeyError, TypeError, UnicodeDecodeError) as e:
        return math.inf, faults + [f"container: {e}"]
    if top.get("shape") != list(x.shape) or top.get("dtype") != _DTYPE_STR.get(x.dtype):
        faults.append(f"header says {top.get('shape')} {top.get('dtype')}, the input is {list(x.shape)} {x.dtype}")
    rows = x.shape[0] if x.ndim else 1
    if sum(p["n0"] for p in parts) != rows:
        faults.append(f"chunks cover {sum(p['n0'] for p in parts)} of {rows} rows")
    gap = 0.0
    for i, part in enumerate(parts):
        h = part["header"]
        if not isinstance(h.get("abs_eb"), float):
            faults.append(f"leaf {i} records no abs_eb")
            gap = math.inf
            continue
        gap = max(gap, abs(h["abs_eb"] - abs_eb) / abs_eb)
        if h.get("spec", {}).get("kind") == "sz3":  # a v1 body is lossless(codes + quantizer state)
            try:
                got = _inflate(h.get("spec", {}).get("lossless", ""), part["body"])
            except Exception as e:  # noqa: BLE001 - any decoder error is the blob's fault
                faults.append(f"leaf {i}: the lossless stream does not inflate ({type(e).__name__}: {e})")
                continue
            if got is not None and got != h["enc_len"] + h["q_len"]:
                faults.append(f"leaf {i}: inflates to {got} bytes, declares {h['enc_len'] + h['q_len']}")
    return gap, faults


def judge_field(x: torch.Tensor, decoded: Optional[torch.Tensor], blob: bytes, ratio: float,
                traffic: Dict, sealed: Optional[Seal] = None) -> FieldVerdict:
    """One field's numbers, against the bound that ``sealed`` kept from
    before the program saw ``x`` (without a seal, derived from ``x`` now
    by the traffic mix's ``mode`` and ``eb``)."""
    if sealed is None:
        sealed = seal(x, traffic["mode"], float(traffic["eb"]))
    abs_eb = sealed.abs_eb
    changed = digest(x) != sealed.digest
    gap, faults = blob_faults(x, blob, ratio, abs_eb)
    if decoded is None or tuple(decoded.shape) != tuple(x.shape) or decoded.dtype != x.dtype:
        desc = "nothing" if decoded is None else f"{tuple(decoded.shape)} {decoded.dtype}"
        faults.append(f"decoded {desc}, the input is {tuple(x.shape)} {x.dtype}")
        return FieldVerdict(math.inf, gap, faults, changed)
    return FieldVerdict(max_error(x, decoded.to(x.device)) / abs_eb, gap, faults, changed)


def summarize(verdicts: List[FieldVerdict]) -> Dict[str, float]:
    """The run's numbers: the worst field's error and gap, all faults counted."""
    return {
        "err_over_bound": max((v.err_over_bound for v in verdicts), default=math.inf),
        "abs_eb_gap": max((v.abs_eb_gap for v in verdicts), default=math.inf),
        "inputs_changed": sum(v.input_changed for v in verdicts),
        "blob_faults": sum(len(v.blob_faults) for v in verdicts),
    }
