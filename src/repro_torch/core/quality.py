"""Closed-loop quality-targeted rate controller (the "give me 60 dB" mode).

The paper's pipelines consume an error *bound*; users usually hold a quality
*requirement* — a PSNR floor, a compression-ratio target, or a bits-per-value
budget (cf. Liu et al., arXiv:2310.14133, which searches the error bound
online to hit a PSNR/ratio target).  :class:`QualityCompressor` closes that
loop per chunk:

  1. a monotone bisection over the absolute error bound, driven by cheap
     models — the uniform-quantization-noise law ``mse ~ eb^2 / 3`` seeded
     and then corrected by trial compression of the chunk's ~4k-element
     sample (PSNR targets), or the candidates' ``estimate_error`` code-bits
     model (ratio / bitrate targets);
  2. the winning pipeline from ``chunking.select_pipeline`` compresses the
     full chunk at the found bound, and the result is CONFIRMED by trial
     decompression — a chunk that misses its quality budget tightens the
     bound and recompresses (bounded retries), so the PSNR floor is
     guaranteed by measurement, not by model;
  3. each chunk's achieved record (eb, mse, chunk PSNR, coded bits/value,
     iterations) is written into the container's chunk table (``"q"`` key)
     and the global achieved summary into the header (``"quality"`` key).

The emitted container is the JAX package's v2 multi-chunk container, byte for
byte; readers that predate the quality records ignore them.

Devices: the input is a tensor on the controller's device (``"cuda"`` unless
told otherwise) and its chunks are views of it.  The sample bisection and
the contest run on the host copy of each chunk's sample through the CPU
host routes, as ``select_pipeline`` does; each full-chunk compression and
its confirming decode run on the chunk's device, on the controller's
``route`` (so ``device="cpu", route="force"`` decodes through the kernels'
plain versions, bit for bit as the card decodes); the MSE of a decode is
numpy's, on host copies (:func:`_finite_mse`).  Every decision is a float
comparison, and the records carry the MSE, so the container equals the
reference's wherever the blobs and their decodes do.

PSNR control law: with the global value range R and target P dB, the MSE
budget is ``R^2 * 10^(-P/10)``; holding every chunk's MSE inside
``[AIM_LO, 1.0] x budget`` keeps the global (size-weighted) MSE inside the
same band, i.e. achieved PSNR in ``[P, P - 10*log10(AIM_LO)]``.  Coders with
step-quantized error (the transform family) cannot always park inside that
band; for them the confirm loop keeps the fewest-bits encoding that
satisfies the floor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import pipeline as pl_mod
from . import telemetry as tel
from .chunking import (
    ChunkRecord,
    _assemble_v2,
    _make_pipeline,
    _parallel_map_ordered,
    _routed_pipeline,
    _sample_block,
    chunk_slices,
    select_pipeline,
)
from .config import CompressionConfig, ErrorBoundMode
from .pipeline import CompressionResult
from .predictors import _host64
from .quantizers import to_host

# the block-hybrid engine registers before the candidate set is read: the
# controller's contest spans ALL families (prediction, transform, hybrid)
from . import blockwise as _blockwise  # noqa: F401,E402
from . import transform as _transform  # noqa: E402


def _auto_candidates() -> Sequence[str]:
    """Late-bound AUTO_CANDIDATES (blockwise.py and fastmode.py extend it at
    import time)."""
    return _transform.AUTO_CANDIDATES


#: chunk-MSE aim band as a fraction of the per-chunk MSE budget: the upper
#: edge is the hard budget (never exceeded after confirmation), the lower
#: edge stops the bisection from over-spending bits on needless accuracy
AIM_LO = 0.85

#: sample-level bisection iterations (each is a ~4k-element trial round trip)
MAX_SAMPLE_ITERS = 14

#: full-chunk confirm-and-tighten retries after the sample bisection
MAX_CONFIRM_ITERS = 4

#: bisection iterations for the code-bits entropy model (ratio/bitrate)
MAX_BITS_ITERS = 18

#: where the sample bisection and the contest run (their host routes write
#: the JAX package's bytes, so the controller's decisions are its decisions)
_HOST = "cpu"


@dataclasses.dataclass(frozen=True)
class QualityTarget:
    """Exactly one of the three targets must be set.

    psnr:    floor in dB w.r.t. the global value range (SZ convention).
    ratio:   compression ratio vs the stored dtype's raw bytes.
    bitrate: coded bits per value.
    """

    psnr: Optional[float] = None
    ratio: Optional[float] = None
    bitrate: Optional[float] = None

    def __post_init__(self):
        set_ = [k for k in ("psnr", "ratio", "bitrate") if getattr(self, k) is not None]
        if len(set_) != 1:
            raise ValueError(f"exactly one quality target must be set, got {set_ or 'none'}")
        if float(getattr(self, set_[0])) <= 0:
            raise ValueError(f"quality target {set_[0]} must be positive")

    @property
    def kind(self) -> str:
        if self.psnr is not None:
            return "psnr"
        return "ratio" if self.ratio is not None else "bitrate"

    def to_header(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": float(getattr(self, self.kind))}


def _geo_mid(lo: Optional[float], hi: Optional[float], cur: float) -> float:
    """Next bisection point in log space; doubles/halves until bracketed."""
    if lo is not None and hi is not None:
        return math.sqrt(lo * hi)
    return cur * 2.0 if hi is None else cur * 0.5


def _finite_mse(a, b) -> float:
    """MSE over the finite positions of ``a`` (the controller's currency), in
    numpy on host copies (tensors or arrays).

    Non-finite inputs have no meaningful squared error; the quality guarantee
    (like the REL bound's range statistics) speaks for finite positions.
    """
    a = _host64(a).reshape(-1)
    b = _host64(b).reshape(-1)
    fin = np.isfinite(a)
    if not fin.all():
        a, b = a[fin], b[fin]
    if a.size == 0:
        return 0.0
    d = a - b
    return float(np.mean(d * d))


def _psnr_from_mse(rng: float, m: float) -> float:
    """PSNR against a fixed (global) value range, degenerate-safe."""
    if m == 0:
        return float("inf")
    if rng == 0:
        return -10.0 * float(np.log10(m))
    return 20.0 * float(np.log10(rng)) - 10.0 * float(np.log10(m))


class QualityCompressor:
    """Quality-targeted chunked compression (see module docstring).

    Emits a v2 multi-chunk container whose chunk table carries per-chunk
    achieved-quality records and whose header carries the global summary;
    ``CompressionResult.meta`` always exposes both.  ``route`` goes to the
    candidates with kernel routes, as in :class:`chunking.ChunkedCompressor`.
    """

    kind = "quality"

    def __init__(
        self,
        target_psnr: Optional[float] = None,
        target_ratio: Optional[float] = None,
        target_bitrate: Optional[float] = None,
        candidates: Optional[Sequence[str]] = None,
        chunk_bytes: int = 1 << 22,
        conf: Optional[CompressionConfig] = None,
        workers: int = 1,
        route: str = "auto",
        device: pl_mod.Device = "cuda",
    ):
        self.target = QualityTarget(target_psnr, target_ratio, target_bitrate)
        self.candidates = tuple(_auto_candidates() if candidates is None else candidates)
        self.chunk_bytes = int(chunk_bytes)
        self.conf = conf or CompressionConfig()
        self.workers = max(1, int(workers))
        self.route = route
        self.device = device

    # -- per-chunk controller ------------------------------------------------

    def _trial_mse(self, comp, sample: np.ndarray, eb: float, base_conf: CompressionConfig) -> float:
        """Measured round-trip MSE of the sample at bound ``eb``."""
        eff = base_conf.replace(mode=ErrorBoundMode.ABS, eb=eb)
        try:
            blob = comp.compress(sample, eff).blob
            return _finite_mse(sample, pl_mod.decompress(blob, device=_HOST))
        except Exception:
            return float("inf")  # treated as "too lossy": bisection tightens

    def _eb_for_mse(self, sample: np.ndarray, mse_budget: float, base_conf: CompressionConfig) -> Tuple[float, int]:
        """Sample-level bisection: the largest eb whose measured sample MSE
        sits inside ``[AIM_LO, 1] x mse_budget`` (monotone: MSE grows with
        eb).  Seeded by the uniform-quantization-noise law mse = eb^2/3."""
        if mse_budget <= 0:
            return float(np.finfo(np.float64).tiny), 0
        trial = _make_pipeline("sz3_lorenzo", device=_HOST)  # cheapest Algorithm-1 pipeline
        eb = math.sqrt(3.0 * mse_budget * 0.9 * (1 + AIM_LO) / 2)
        lo: Optional[float] = None  # largest eb known too accurate
        hi: Optional[float] = None  # smallest eb known too lossy
        iters = 0
        for iters in range(1, MAX_SAMPLE_ITERS + 1):
            m = self._trial_mse(trial, sample, eb, base_conf)
            if m > mse_budget:
                hi = eb
            elif m < AIM_LO * mse_budget:
                lo = eb
            else:
                break
            nxt = _geo_mid(lo, hi, eb)
            if nxt == eb or nxt <= 0 or not math.isfinite(nxt):
                break
            eb = nxt
            # a chunk can be unreachable from above (unpredictables stored
            # exactly keep MSE below budget at ANY bound): stop growing once
            # eb dwarfs the data scale
            if lo is not None and hi is None and eb > 1e6 * math.sqrt(mse_budget):
                break
        return eb, iters

    def _eb_for_bits(
        self, sample: np.ndarray, bits_target: float, base_conf: CompressionConfig, pipelines: Dict[str, Any]
    ) -> Tuple[float, int]:
        """Bisection over eb against the candidates' code-bits entropy model
        (monotone: estimated bits fall as eb grows)."""
        fin = sample[np.isfinite(sample)]
        scale = float(np.abs(fin).max()) if fin.size else 1.0
        scale = scale or 1.0
        eb_lo, eb_hi = scale * 1e-12, scale * 2.0

        est_fns = []
        for name in self.candidates:
            comp = pipelines[name]
            est_fn = getattr(comp, "estimate_error", None)
            if est_fn is None:
                pred = getattr(comp, "predictor", None)
                est_fn = getattr(pred, "estimate_error", None)
            if est_fn is not None:
                est_fns.append(est_fn)

        def est_bits(eb: float) -> float:
            eff = base_conf.replace(mode=ErrorBoundMode.ABS, eb=eb)
            best = float("inf")
            for est_fn in est_fns:
                try:
                    best = min(best, float(est_fn(sample, eb, eff)))
                except Exception:
                    pass
            return best

        iters = 0
        for iters in range(1, MAX_BITS_ITERS + 1):
            eb = math.sqrt(eb_lo * eb_hi)
            b = est_bits(eb)
            if not math.isfinite(b):
                break
            if abs(b - bits_target) <= 0.05 * bits_target:
                return eb, iters
            if b > bits_target:  # too many bits -> loosen the bound
                eb_lo = eb
            else:
                eb_hi = eb
        return math.sqrt(eb_lo * eb_hi), iters

    def _compress_chunk(
        self,
        chunk: torch.Tensor,
        mse_budget: Optional[float],
        bits_target: Optional[float],
        global_rng: float,
        base_conf: CompressionConfig,
    ) -> Tuple[bytes, str, int, Dict[str, Any]]:
        """Controller for ONE chunk: bisect -> select -> compress -> confirm.
        Decision recording is muted for the whole scope: the probes and
        retries compress the chunk repeatedly, and only the single
        achieved-quality record per chunk that ``compress`` writes counts."""
        with tel.suppress_decisions():
            return self._compress_chunk_inner(chunk, mse_budget, bits_target, global_rng, base_conf)

    def _compress_chunk_inner(
        self,
        chunk: torch.Tensor,
        mse_budget: Optional[float],
        bits_target: Optional[float],
        global_rng: float,
        base_conf: CompressionConfig,
    ) -> Tuple[bytes, str, int, Dict[str, Any]]:
        # the contest's instances on the host; the chunk's on its device
        pipelines = {name: _make_pipeline(name, device=_HOST) for name in self.candidates}
        chunk_pipes = {name: _routed_pipeline(name, self.route, chunk.device) for name in self.candidates}
        host_chunk = to_host(chunk)
        if chunk.numel() == 0:
            eb, iters = float(np.finfo(np.float64).tiny), 0
        elif mse_budget is not None:
            eb, iters = self._eb_for_mse(to_host(_sample_block(chunk)), mse_budget, base_conf)
        else:
            eb, iters = self._eb_for_bits(to_host(_sample_block(chunk)), bits_target, base_conf, pipelines)

        def _compress_at(eb_, cands=self.candidates):
            eff = base_conf.replace(mode=ErrorBoundMode.ABS, eb=eb_)
            name_, _ = select_pipeline(chunk, eb_, eff, cands, pipelines)
            blob_ = chunk_pipes[name_].compress(chunk, eff).blob
            xhat_ = pl_mod.decompress(blob_, device=chunk.device, route=self.route)
            return name_, blob_, xhat_, _finite_mse(host_chunk, xhat_)

        name, blob, xhat, m = _compress_at(eb)
        confirms = 0
        if mse_budget is not None and chunk.numel():
            # trial-decompress confirmation, BOTH directions: the bisection
            # trials run the cheap Lorenzo pipeline, while the contest winner
            # can be far more accurate at the same bound (the transform's
            # power-of-two steps move its MSE in ~4x jumps), so the loop walks
            # eb through the aim band and keeps the FEWEST-BITS encoding
            # among those satisfying the floor; the floor (m <= budget) is
            # restored unconditionally at the end
            best = (len(blob), eb, name, blob, xhat, m) if m <= mse_budget else None
            cont = tuple(n for n in self.candidates if hasattr(pipelines[n], "preprocessor"))
            if cont and not hasattr(pipelines[name], "preprocessor"):
                # a step-quantized winner chosen from sample ESTIMATES: measure
                # the best continuous-eb pipeline at the bisected bound too
                cname, cblob, cxhat, cm = _compress_at(eb, cont)
                if cm <= mse_budget and (best is None or len(cblob) < best[0]):
                    best = (len(cblob), eb, cname, cblob, cxhat, cm)
            for _ in range(MAX_CONFIRM_ITERS):
                if m > mse_budget:
                    eb *= math.sqrt(max(mse_budget, 1e-300) * AIM_LO / m)
                elif m < AIM_LO * mse_budget:
                    grow = math.sqrt(0.92 * mse_budget / max(m, mse_budget * 1e-6))
                    eb *= min(8.0, grow)
                else:
                    break
                confirms += 1
                prev_m = m
                name, blob, xhat, m = _compress_at(eb)
                if m <= mse_budget and (best is None or len(blob) < best[0]):
                    best = (len(blob), eb, name, blob, xhat, m)
                if m == prev_m and m < AIM_LO * mse_budget:
                    break  # insensitive to eb (constant / exactly-stored data)
            if best is not None:
                _, eb, name, blob, xhat, m = best
            while m > mse_budget and confirms < MAX_CONFIRM_ITERS + 3:
                confirms += 1
                eb *= math.sqrt(max(mse_budget, 1e-300) * AIM_LO / m)
                name, blob, xhat, m = _compress_at(eb)
        elif bits_target is not None and chunk.numel():
            # correction steps from measured bits: each halving of eb costs
            # ~1 coded bit/value on the entropy stage, so jump by the gap
            while confirms < MAX_CONFIRM_ITERS:
                achieved = 8.0 * len(blob) / max(1, chunk.numel())
                delta = achieved - bits_target
                if abs(delta) <= 0.12 * bits_target or abs(delta) <= 0.05:
                    break
                confirms += 1
                eb = float(np.clip(eb * 2.0**delta, eb / 16, eb * 16))
                name, blob, xhat, m = _compress_at(eb)
        record = {
            "eb": float(eb),
            "mse": float(m),
            "psnr": _psnr_from_mse(global_rng, float(m)),
            "bits": 8.0 * len(blob) / max(1, chunk.numel()),
            "iters": int(iters),
            "confirms": int(confirms),
        }
        return blob, name, int(chunk.shape[0] if chunk.ndim else chunk.numel()), record

    # -- whole array ----------------------------------------------------------

    def compress(self, data, conf: Optional[CompressionConfig] = None, with_stats: bool = False) -> CompressionResult:
        """Compress a numpy array or torch tensor on this controller's device.
        ``conf`` supplies module knobs (block size, interp kind, ...); the
        error bound fields are controller outputs here, so ``conf.mode`` /
        ``conf.eb`` are ignored — the target was fixed at construction."""
        return self._compress(data, conf or self.conf)

    def _compress(self, data, base_conf: CompressionConfig) -> CompressionResult:
        data = pl_mod._as_tensor(data, pl_mod.resolve_device(self.device))
        flat_leading = data.reshape(-1) if data.ndim == 0 else data
        fin = flat_leading[torch.isfinite(flat_leading)] if flat_leading.numel() else flat_leading
        global_rng = float(fin.max() - fin.min()) if fin.numel() else 0.0
        dtype_bits = data.element_size() * 8
        mse_budget = bits_target = None
        if self.target.kind == "psnr":
            mse_budget = global_rng**2 * 10.0 ** (-float(self.target.psnr) / 10.0)
        elif self.target.kind == "ratio":
            bits_target = dtype_bits / float(self.target.ratio)
        else:
            bits_target = float(self.target.bitrate)

        slices = chunk_slices(tuple(flat_leading.shape), flat_leading.element_size(), self.chunk_bytes)

        def _one(args):
            i, sl = args
            chunk = flat_leading[sl]
            with tel.span("chunk", order=i, bytes=chunk.numel() * chunk.element_size()):
                return self._compress_chunk(chunk, mse_budget, bits_target, global_rng, base_conf)

        results = list(_parallel_map_ordered(_one, enumerate(slices), self.workers))
        records: List[ChunkRecord] = []
        body_parts: List[bytes] = []
        off = 0
        row = int(np.prod(tuple(flat_leading.shape[1:]), dtype=np.int64)) if flat_leading.ndim > 1 else 1
        for i, (blob, name, n0, rec) in enumerate(results):
            records.append(ChunkRecord(off, len(blob), n0, name, extra=rec))
            body_parts.append(blob)
            off += len(blob)
            if tel.enabled():
                # the achieved-quality record rides the same decision stream
                # as every other engine's selections
                tel.record_decision(tel.make_decision(
                    "sz3_quality",
                    name,
                    index=i,
                    candidates=list(self.candidates),
                    realized_bits=float(rec["bits"]),
                    n_elems=int(n0) * row,
                    extra={"quality": rec},
                ))
        # size-weighted global achieved quality
        total_se = 0.0
        total_n = 0
        for r in records:
            n = int(np.prod((r.n0,) + tuple(flat_leading.shape[1:]), dtype=np.int64))
            total_se += r.extra["mse"] * n
            total_n += n
        global_mse = total_se / max(1, total_n)
        if global_mse == 0 or total_n == 0:
            achieved_psnr = float("inf")
        elif global_rng == 0:
            achieved_psnr = -10.0 * float(np.log10(global_mse))
        else:
            achieved_psnr = 20.0 * float(np.log10(global_rng)) - 10.0 * float(np.log10(global_mse))
        quality = {
            "target": self.target.to_header(),
            "achieved_psnr": float(achieved_psnr),
            "achieved_mse": float(global_mse),
            # placeholders sized like the real values (msgpack float64 is
            # fixed-width), so the container length measured below is final
            "achieved_bits": 0.0,
            "achieved_ratio": 0.0,
            "value_range": float(global_rng),
        }
        conf = base_conf.replace(mode=ErrorBoundMode.ABS, eb=0.0)
        dtype_str = pl_mod._DTYPE_STR[data.dtype]

        def _assemble():
            return _assemble_v2(
                tuple(data.shape), dtype_str, records, body_parts, conf, header_extra={"quality": quality}
            )

        # two-pass assembly so the recorded bits/ratio count the WHOLE
        # container (header + chunk table + body), not just the body
        total_len = len(_assemble())
        quality["achieved_bits"] = 8.0 * total_len / max(1, total_n)
        quality["achieved_ratio"] = (total_n * data.element_size()) / max(1, total_len)
        blob = _assemble()
        if len(blob) != total_len:  # fixed-width floats keep this exact
            raise RuntimeError(f"quality container changed length on reassembly: {len(blob)} != {total_len}")
        meta = {"quality": quality, "chunks": [r.to_header() for r in records]}
        nbytes = data.numel() * data.element_size()
        return CompressionResult(blob=blob, ratio=nbytes / max(1, len(blob)), meta=meta)


def achieved_quality(blob: bytes) -> Optional[Dict[str, Any]]:
    """Read the achieved-quality record back out of a quality container
    (None for containers written by other pipelines)."""
    header, _ = pl_mod.parse_header(blob)
    return header.get("quality")


def sz3_quality(
    target_psnr: Optional[float] = None,
    target_ratio: Optional[float] = None,
    target_bitrate: Optional[float] = None,
    candidates: Optional[Sequence[str]] = None,
    chunk_bytes: int = 1 << 22,
    workers: int = 1,
    **kw,
) -> QualityCompressor:
    """Named factory; a bare ``sz3_quality()`` targets 60 dB PSNR.  ``kw``
    goes to :class:`QualityCompressor` (``conf``, ``route``, ``device``)."""
    if target_psnr is None and target_ratio is None and target_bitrate is None:
        target_psnr = 60.0
    return QualityCompressor(
        target_psnr=target_psnr,
        target_ratio=target_ratio,
        target_bitrate=target_bitrate,
        candidates=candidates,
        chunk_bytes=chunk_bytes,
        workers=workers,
        **kw,
    )


# registration (quality imports pipeline/chunking/transform, never vice versa)
pl_mod.PIPELINES["sz3_quality"] = sz3_quality
