"""Predictor module (paper §3.2 "Predictor", Appendix A.2).

Instances:

  * LorenzoPredictor          — N-D Lorenzo [34] in *dual-quantization* form
                                (cuSZ, arXiv:2007.09625): data are prequantized
                                onto the 2*eb grid once, then the Lorenzo
                                stencil runs on exact integers; the inverse is
                                a cumulative sum.  Error bound identical to SZ.
  * RegressionPredictor       — SZ2 [8] block-wise hyperplane fit; coefficient
                                streams are themselves quantized.
  * InterpolationPredictor    — SZ3-Interp [17]: multi-level linear/cubic
                                spline interpolation with per-level feedback.
  * CompositePredictor        — SZ2's per-block Lorenzo-vs-regression
                                selection on strided samples.
  * PatternPredictor          — SZ-Pastri [19]: periodic pattern + per-block
                                scaling for GAMESS ERI data.
  * LorenzoSequentialPredictor— the paper-faithful SZ1.4 semantics (predict
                                from *decompressed* neighbours, in scan
                                order), a float64 loop on the host: the
                                fidelity oracle, not a production path.
  * ZeroPredictor             — predicts 0 (baseline / bypass).

Predictors take and return torch tensors on the caller's device and drive
the quantizer through its array-at-a-time interface.  Their codes and meta
are byte-identical to the JAX package's predictors of the same name, on the
CPU and on the card: every float64 value that decides a byte is computed as
numpy computes it — IEEE divides (``true_div``), block sums in numpy's
pairwise order (``pairwise_rowsum``), separate multiplies and adds.

The estimators (``estimate_error`` and the helpers under it) score a small
sample on the host, in numpy, with the JAX package's code: their scores
decide which pipeline the chunked engine runs on a chunk, and ``log2`` and
torch's reductions round differently across libraries.
"""
from __future__ import annotations

import abc
import math
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import telemetry as tel
from .config import CompressionConfig
from .quantizers import QuantizerBase, check_numpy_sum_order, pairwise_rowsum, rint_int64, to_device, to_host, true_div
from ..kernels.lorenzo import ops as lops


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def lorenzo_filter(q: torch.Tensor, order: int = 1) -> torch.Tensor:
    """N-D Lorenzo difference filter on integers (zero-padded boundaries).

    Successive first differences along each axis == inclusion-exclusion
    Lorenzo stencil; applying it ``order`` times gives the higher-order
    variant [7].  Exact on int64.
    """
    d = q
    for _ in range(order):
        for ax in range(d.ndim):
            shape = list(d.shape)
            shape[ax] = 1
            d = torch.diff(d, dim=ax, prepend=d.new_zeros(shape))
    return d


def lorenzo_inverse(d: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Inverse filter: cumulative sums (the parallel-decode win of dual-quant)."""
    q = d
    for _ in range(order):
        for ax in range(q.ndim - 1, -1, -1):
            q = torch.cumsum(q, dim=ax)
    return q


# -- per-block helpers (axis 0 indexes blocks: the caller tiles once via
#    pad_to_blocks/blockify and every candidate runs batched over the
#    whole block set) ---------------------------------------------------------

def pad_to_blocks(data: torch.Tensor, b: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Replicate-pad every axis up to a multiple of ``b``; returns
    (padded, original_shape)."""
    x = data
    for ax, s in enumerate(data.shape):
        pad = (-s) % b
        if pad:
            idx = torch.arange(s + pad, device=x.device).clamp_(max=s - 1)
            x = x.index_select(ax, idx)
    return x, tuple(data.shape)


def blockify(x: torch.Tensor, b: int) -> torch.Tensor:
    """(n1, n2, ...) -> (nblocks, b, b, ...); all axes must divide by ``b``."""
    nd = x.ndim
    shape: List[int] = []
    for s in x.shape:
        shape += [s // b, b]
    y = x.reshape(shape)
    perm = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
    return y.permute(perm).reshape((-1,) + (b,) * nd)


def unblockify(blocks: torch.Tensor, padded_shape: Sequence[int], b: int) -> torch.Tensor:
    """Inverse of :func:`blockify`."""
    nd = len(padded_shape)
    grid = [s // b for s in padded_shape]
    y = blocks.reshape(grid + [b] * nd)
    perm: List[int] = []
    for i in range(nd):
        perm += [i, nd + i]
    return y.permute(perm).reshape(tuple(padded_shape))


def block_coords(b: int, nd: int, device=None) -> List[torch.Tensor]:
    """Centred per-axis float64 coordinates, broadcast-ready against
    (nb, b, ..., b)."""
    cs = []
    for ax in range(nd):
        c = torch.arange(b, dtype=torch.float64, device=device) - (b - 1) / 2.0
        shape = [1] * nd
        shape[ax] = b
        cs.append(c.reshape(shape))
    return cs


def block_sums(blocks: torch.Tensor) -> torch.Tensor:
    """Per-block sums of (nb, ...) in the order ``np.sum`` over the block
    axes takes (one contiguous run per block)."""
    return pairwise_rowsum(blocks.reshape(blocks.shape[0], math.prod(blocks.shape[1:])))


def _plane(qhat: Sequence[torch.Tensor], cs: Sequence[torch.Tensor], nb: int) -> torch.Tensor:
    """The hyperplane prediction qhat0 + sum_k qhat_k * c_k per block."""
    nd = len(cs)
    pred = qhat[0].reshape((nb,) + (1,) * nd)
    for k in range(nd):
        pred = pred + qhat[1 + k].reshape((nb,) + (1,) * nd) * cs[k]
    return pred


def block_lorenzo_filter(qblocks: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Block-local Lorenzo filter, batched: axis 0 indexes blocks, the stencil
    runs over axes 1..nd only (zero-padded block boundaries, as in SZ2's
    block-wise candidate)."""
    d = qblocks
    for _ in range(order):
        for ax in range(1, qblocks.ndim):
            shape = list(d.shape)
            shape[ax] = 1
            d = torch.diff(d, dim=ax, prepend=d.new_zeros(shape))
    return d


def block_lorenzo_inverse(dblocks: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Inverse of :func:`block_lorenzo_filter` (per-block cumulative sums)."""
    q = dblocks
    for _ in range(order):
        for ax in range(q.ndim - 1, 0, -1):
            q = torch.cumsum(q, dim=ax)
    return q


def block_plane_fit(
    blocks: torch.Tensor, b: int, eb: float
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Batched SZ2 hyperplane fit on pre-blockified float64 data.

    Returns ``(coef_q, pred, bad)``: per-block quantized coefficient integers
    (nd+1 int64 streams, SZ2 bounds — eb/2 intercept, eb/(2b) slopes), the
    prediction every decoder rebuilds from them, and a per-block mask of
    fits that are not finite or reach 2^62 bins (nan/inf inputs), whose
    coefficients are zeroed: such blocks must not win a contest."""
    nd = blocks.ndim - 1
    nb = blocks.shape[0]
    bad = torch.zeros(nb, dtype=torch.bool, device=blocks.device)
    coef_q: List[torch.Tensor] = []
    qhat: List[torch.Tensor] = []
    for k, vals in enumerate(_fit_coeffs(blocks, b)):
        step = 2.0 * _coef_eb(eb, k, b)
        scaled = true_div(vals, step)
        finite = torch.isfinite(scaled) & (scaled.abs() < float(2**62))
        bad |= ~finite
        q = rint_int64(torch.where(finite, scaled, 0.0))
        coef_q.append(q)
        qhat.append(q.to(torch.float64) * step)
    return coef_q, _plane(qhat, block_coords(b, nd, blocks.device), nb), bad


# -- estimators: host numpy, the JAX package's code ---------------------------

def _host64(sample) -> np.ndarray:
    if isinstance(sample, torch.Tensor):
        sample = to_host(sample)
    return np.asarray(sample, np.float64)


def code_bits(abs_errors, abs_eb: float, radius: int = 32768) -> float:
    """Mean estimated coded bits/element for given |prediction errors|.

    Errors become quantization-bin indices (e/(2*eb)); the entropy stage pays
    the empirical entropy of that bin population, and out-of-range points are
    stored raw (~64 bits).  This is the common currency pipelines are
    contested in.
    """
    e = _host64(abs_errors).reshape(-1)
    if e.size == 0:
        return 0.0
    return _int_code_bits(np.rint(e / (2.0 * abs_eb)), radius)


def _int_code_bits(q, radius: int) -> float:
    """Entropy of integer bin indices + raw-storage cost of out-of-range ones."""
    if isinstance(q, torch.Tensor):
        q = to_host(q)
    q = np.abs(np.asarray(q).reshape(-1))
    if q.size == 0:
        return 0.0
    out = q >= radius
    inr = q[~out]
    bits = 64.0 * float(out.mean())
    if inr.size:
        _, counts = np.unique(inr, return_counts=True)
        p = counts / inr.size
        bits += float(-(p * np.log2(p)).sum()) * float((~out).mean())
    return bits


def lorenzo_residuals(sample, abs_eb: float, order: int = 1, radius: int = 32768) -> np.ndarray:
    """|Lorenzo prediction error| per sample point (paper: estimate_error):
    the magnitude of the prequantized stencil output, clipped at the code
    range."""
    x64 = _host64(sample)
    if x64.size == 0:
        return np.zeros(0)
    q = np.rint(x64 / (2.0 * abs_eb))
    d = q
    for _ in range(order):
        for ax in range(d.ndim):
            d = np.diff(d, axis=ax, prepend=0)
    est = np.abs(d) * (2.0 * abs_eb)
    return np.minimum(est, 2.0 * abs_eb * radius)


def regression_residuals(sample, abs_eb: float, block_size: int) -> np.ndarray:
    """|hyperplane-fit residual| per sample point, block-wise as in SZ2."""
    res, _ = _regression_fit(sample, block_size)
    return res


def _regression_fit(sample, block_size: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(per-point |residual|, per-stream coefficient values) of the SZ2 fit."""
    b = max(2, int(block_size))
    x = _host64(sample)
    if x.size == 0:
        return np.zeros(0), []
    if x.ndim == 0:
        x = x.reshape(1)
    nd = x.ndim
    xp, _ = pad_to_blocks(torch.from_numpy(x), b)
    blocks = blockify(xp, b).numpy()
    axes = tuple(range(1, nd + 1))
    cs = [c.numpy() for c in block_coords(b, nd)]
    denom = (b**nd) * ((b * b - 1) / 12.0)
    # nan/inf blocks produce nan residuals/coefficients by design (estimation
    # only — such points ride the unpredictable fail path when coding)
    with np.errstate(invalid="ignore", over="ignore"):
        coeffs = [blocks.mean(axis=axes)]
        pred = coeffs[0].reshape((-1,) + (1,) * nd)
        for k in range(nd):
            beta = (blocks * cs[k]).sum(axis=axes) / denom
            coeffs.append(beta)
            pred = pred + beta.reshape((-1,) + (1,) * nd) * cs[k]
        return np.abs(blocks - pred).reshape(-1), coeffs


def regression_bits(sample, abs_eb: float, block_size: int, radius: int = 32768) -> float:
    """Estimated bits/element for the SZ2 regression stage INCLUDING the
    quantized, delta-coded coefficient streams."""
    b = max(2, int(block_size))
    res, coeffs = _regression_fit(sample, block_size)
    if res.size == 0:
        return 0.0
    bits = code_bits(res, abs_eb, radius)
    n = res.size
    for k, vals in enumerate(coeffs):
        ceb = abs_eb / 2.0 if k == 0 else abs_eb / (2.0 * b)
        q = np.rint(vals / (2.0 * ceb))
        bits += _int_code_bits(np.diff(q, prepend=0), radius) * vals.size / n
    return bits


def interp_residuals(sample) -> np.ndarray:
    """|linear-interpolation residual| pooled over ALL levels, per axis:
    each point is predicted once, at the level that fills it."""
    x = _host64(sample)
    if x.size == 0:
        return np.zeros(0)
    errs = []
    for ax in range(x.ndim):
        dim = x.shape[ax]
        if dim < 3:
            continue
        s = 1
        while s < dim:
            mid = [slice(None)] * x.ndim
            left = [slice(None)] * x.ndim
            mid[ax] = slice(s, None, 2 * s)
            n_mid = len(range(s, dim, 2 * s))
            left[ax] = slice(0, 2 * s * n_mid, 2 * s)
            right_idx = np.minimum(np.arange(n_mid) * 2 * s + 2 * s, dim - 1)
            xl = x[tuple(left)]
            xr = np.take(x, right_idx, axis=ax)
            pred = 0.5 * (xl + xr)
            errs.append(np.abs(x[tuple(mid)] - pred).reshape(-1))
            s *= 2
    if not errs:
        flat = x.reshape(-1)
        return np.abs(np.diff(flat, prepend=0.0))
    return np.concatenate(errs)


def _pack_mask(mask: torch.Tensor) -> bytes:
    return np.packbits(to_host(mask.reshape(-1))).tobytes()


def _unpack_mask(buf: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(buf, np.uint8), count=n).astype(bool)


def _patch_fails(out: torch.Tensor, meta: Dict[str, Any], shape) -> torch.Tensor:
    """Write the exactly stored fail-channel values over ``out``."""
    mask = _unpack_mask(meta["fail_mask"], math.prod(shape))
    vals = np.frombuffer(meta["fail_vals"], np.float64)
    if int(mask.sum()) != vals.size:
        raise ValueError(
            f"fail channel holds {vals.size} values for {int(mask.sum())} masked points"
        )
    out = out.reshape(-1)
    out[to_device(mask, out.device)] = to_device(vals.copy(), out.device, out.dtype)
    return out.reshape(shape)


class Predictor(abc.ABC):
    name: str = "abstract"

    def estimate_error(self, sample, abs_eb: float, conf: CompressionConfig) -> Optional[float]:
        """Estimated entropy-coded bits/element this predictor would incur
        (the paper's ``estimate_error``, §3.2) on a sample (tensor or numpy
        array, scored on the host), comparable across predictors (see
        :func:`code_bits`).  ``None`` means "no cheap estimator"."""
        return None

    @abc.abstractmethod
    def compress(
        self, data: torch.Tensor, quantizer: QuantizerBase, conf: CompressionConfig
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Return (flat quantization codes, serializable meta)."""

    @abc.abstractmethod
    def decompress(
        self,
        codes: torch.Tensor,
        shape: Tuple[int, ...],
        dtype: torch.dtype,
        quantizer: QuantizerBase,
        conf: CompressionConfig,
        meta: Dict[str, Any],
    ) -> torch.Tensor: ...


def _check_count(codes: torch.Tensor, shape) -> None:
    if codes.numel() != math.prod(shape):
        raise ValueError(
            f"{codes.numel()} codes cannot fill shape {tuple(shape)}"
        )


# ---------------------------------------------------------------------------
# Zero predictor
# ---------------------------------------------------------------------------

class ZeroPredictor(Predictor):
    name = "zero"

    def estimate_error(self, sample, abs_eb, conf):
        return code_bits(np.abs(_host64(sample)), abs_eb, conf.quant_radius)

    def compress(self, data, quantizer, conf):
        zeros = torch.zeros(data.numel(), dtype=torch.float64, device=data.device)
        codes, _ = quantizer.quantize(data.reshape(-1), zeros)
        return codes, {}

    def decompress(self, codes, shape, dtype, quantizer, conf, meta):
        _check_count(codes, shape)
        zeros = torch.zeros(codes.numel(), dtype=torch.float64, device=codes.device)
        return quantizer.recover(zeros, codes).reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# Dual-quantization Lorenzo
# ---------------------------------------------------------------------------

_ROUTES = ("auto", "force", "off")


class LorenzoPredictor(Predictor):
    """Parallel N-D Lorenzo via dual-quantization.

    Two routes behind the same codes/meta contract:

      * host route — ``prequantize`` + ``lorenzo_filter`` on int64 torch
        tensors, any ndim/order, on the data's device.
      * kernel route — the fused prequant+Lorenzo kernels
        (``kernels/lorenzo``), for order-1 float32 1-D/2-D data of at least
        4096 elements whose prequantized magnitudes pass the
        ``PIPELINE_SAFE`` guard.  The kernel computes q in float32, so after
        encoding, reconstruction is re-derived EXACTLY as both decode routes
        will compute it and any bound-breaking point is patched into the
        fail channel — the error bound is therefore identical to the host
        route's.

    ``route="auto"`` takes the kernel route for CUDA tensors only; ``"force"``
    takes it wherever the rule holds (on the CPU the kernels' plain torch
    versions run, as the JAX package runs interpret-mode Pallas); ``"off"``
    never takes it.  The rule is the JAX package's, so blobs compare byte for
    byte.  It is silent: data that fails it takes the host route.
    """

    name = "lorenzo"

    #: below this many elements the kernel dispatch overhead dominates
    _KERNEL_MIN_SIZE = 4096

    def __init__(self, order: Optional[int] = None, route: str = "auto"):
        if route not in _ROUTES:
            raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
        self.order = order
        self.route = route

    def estimate_error(self, sample, abs_eb, conf):
        return code_bits(
            lorenzo_residuals(
                sample, abs_eb, self.order or conf.lorenzo_order, conf.quant_radius
            ),
            abs_eb,
            conf.quant_radius,
        )

    # -- kernel routing -----------------------------------------------------
    def _route_allows(self, device: torch.device) -> bool:
        return self.route == "force" or (self.route == "auto" and device.type == "cuda")

    def _kernel_ok(self, data: torch.Tensor, eb: float, order: int) -> bool:
        if order != 1 or not self._route_allows(data.device):
            return False
        if (
            data.ndim not in (1, 2)
            or data.dtype != torch.float32
            or data.numel() < self._KERNEL_MIN_SIZE
        ):
            return False
        absmax = float(data.abs().max())
        return math.isfinite(absmax) and absmax / (2.0 * eb) < lops.PIPELINE_SAFE

    def _compress_kernel(self, data, quantizer):
        eb = quantizer.eb
        with tel.span("device_transfer", bytes=data.numel() * data.element_size()):
            codes32, draw = lops.encode_pipeline(data, eb=eb, radius=quantizer.radius)
        d = draw.to(torch.int64)
        x64 = data.to(torch.float64)
        # The kernel prequantizes in float32 (vs float64 on the host route);
        # verify the bound against BOTH decode routes' exact arithmetic and
        # divert any straggler through the fail channel (raw values).  The
        # two decodes may differ in the last bit, so neither stands in for
        # the other.
        recon_host = quantizer.dequantize_int(lorenzo_inverse(d, 1))
        fail = (recon_host.to(torch.float64) - x64).abs() > eb
        recon_kernel = lops.decode_pipeline(draw, eb=eb)
        fail |= (recon_kernel.to(torch.float64) - x64).abs() > eb
        flat = d.reshape(-1)
        oor = flat.abs() >= quantizer.radius
        if bool(oor.any()):
            quantizer._store_unpred_int(flat[oor])
        meta: Dict[str, Any] = {"order": 1, "nfail": int(fail.sum()), "device": 1}
        if meta["nfail"]:
            meta["fail_mask"] = _pack_mask(fail)
            meta["fail_vals"] = to_host(x64[fail]).tobytes()
        return codes32.reshape(-1), meta

    def _decode_kernel_ok(self, shape, dtype, device: torch.device) -> bool:
        return (
            self._route_allows(device)
            and len(shape) in (1, 2)
            and dtype == torch.float32
        )

    # -- the two directions --------------------------------------------------
    def compress(self, data, quantizer, conf):
        order = self.order or conf.lorenzo_order
        if self._kernel_ok(data, quantizer.eb, order):
            return self._compress_kernel(data, quantizer)
        q, recon, fail = quantizer.prequantize(data)
        d = lorenzo_filter(q, order)
        codes = quantizer.quantize_int_diff(d.reshape(-1))
        meta: Dict[str, Any] = {"order": order, "nfail": int(fail.sum())}
        if meta["nfail"]:
            meta["fail_mask"] = _pack_mask(fail)
            meta["fail_vals"] = to_host(data.to(torch.float64)[fail]).tobytes()
        return codes, meta

    def decompress(self, codes, shape, dtype, quantizer, conf, meta):
        order = int(meta["order"])
        _check_count(codes, shape)
        d = quantizer.recover_int_diff(codes).reshape(shape)
        if meta.get("device") and self._decode_kernel_ok(shape, dtype, d.device):
            # compress verified this blob against the kernel decode's float32
            # arithmetic, so the fused route is bound-exact here.  The int32
            # cast wraps as the JAX package's astype(int32) does.
            out = lops.decode_pipeline(d.to(torch.int32), eb=quantizer.eb).to(dtype)
        else:
            out = quantizer.dequantize_int(lorenzo_inverse(d, order)).to(dtype)
        if meta.get("nfail"):
            out = _patch_fails(out, meta, shape)
        return out


# ---------------------------------------------------------------------------
# Regression predictor (SZ2)
# ---------------------------------------------------------------------------

def _coef_eb(eb: float, k: int, b: int) -> float:
    """SZ2's coefficient bounds: eb/2 for the intercept, eb/(2b) per slope."""
    return eb / 2.0 if k == 0 else eb / (2.0 * b)


def _fit_coeffs(blocks: torch.Tensor, b: int) -> List[torch.Tensor]:
    """Per-block least-squares plane coefficients [beta0, beta_1..beta_nd]:
    the block mean, and sum(x * c_k) / sum(c_k^2) along each axis (centred
    coordinates make the normal equations diagonal)."""
    check_numpy_sum_order()
    nd = blocks.ndim - 1
    cs = block_coords(b, nd, blocks.device)
    denom = (b**nd) * ((b * b - 1) / 12.0)
    coeffs = [true_div(block_sums(blocks), float(b**nd))]
    coeffs += [true_div(block_sums(blocks * cs[k]), denom) for k in range(nd)]
    return coeffs


class RegressionPredictor(Predictor):
    """Block-wise hyperplane fit (SZ2 [8]).

    For each b^d block the least-squares plane f(i) = beta0 + sum_k beta_k*i_k
    is fitted in closed form.  Coefficients are quantized (eb/2b per slope,
    eb/2 for the intercept, as in SZ2), delta-coded along the block order,
    and ride the shared entropy stage.  Edge blocks are replicate-padded; the
    original extent is restored on decode.
    """

    name = "regression"

    def estimate_error(self, sample, abs_eb, conf):
        return regression_bits(sample, abs_eb, conf.block_size, conf.quant_radius)

    def compress(self, data, quantizer, conf):
        b = int(conf.block_size)
        nd = data.ndim
        x, orig_shape = pad_to_blocks(data.to(torch.float64), b)
        blocks = blockify(x, b)  # (nb, b, ..., b)
        nb = blocks.shape[0]
        eb = quantizer.eb
        coef_q = [
            rint_int64(true_div(vals, 2.0 * _coef_eb(eb, k, b)))
            for k, vals in enumerate(_fit_coeffs(blocks, b))
        ]
        qhat = [q.to(torch.float64) * (2.0 * _coef_eb(eb, k, b)) for k, q in enumerate(coef_q)]
        # delta-encode coefficient streams (adjacent blocks correlate)
        cc = [quantizer.quantize_int_diff(torch.diff(q, prepend=q.new_zeros(1))) for q in coef_q]
        pred = _plane(qhat, block_coords(b, nd, blocks.device), nb)
        dcodes, _ = quantizer.quantize(blocks.reshape(-1), pred.reshape(-1))
        codes = torch.cat(cc + [dcodes])
        meta = {
            "orig_shape": list(orig_shape),
            "padded_shape": list(x.shape),
            "nb": int(nb),
            "b": b,
        }
        return codes, meta

    def decompress(self, codes, shape, dtype, quantizer, conf, meta):
        b = int(meta["b"])
        nb = int(meta["nb"])
        padded_shape = tuple(meta["padded_shape"])
        nd = len(padded_shape)
        eb = quantizer.eb
        pos = 0
        qhat = []
        for k in range(nd + 1):
            dq = quantizer.recover_int_diff(codes[pos : pos + nb])
            pos += nb
            qhat.append(torch.cumsum(dq, 0).to(torch.float64) * (2.0 * _coef_eb(eb, k, b)))
        pred = _plane(qhat, block_coords(b, nd, codes.device), nb)
        recon = quantizer.recover(pred.reshape(-1), codes[pos:])
        out = unblockify(recon.reshape((nb,) + (b,) * nd), padded_shape, b)
        sl = tuple(slice(0, s) for s in meta["orig_shape"])
        return out[sl].to(dtype)


# ---------------------------------------------------------------------------
# Interpolation predictor (SZ3-Interp)
# ---------------------------------------------------------------------------

class InterpolationPredictor(Predictor):
    """Multi-level spline interpolation [17] with per-level feedback.

    Levels run coarse->fine; within a level each axis pass predicts the
    odd-stride points from already-reconstructed neighbours via linear or
    cubic interpolation.  Every point within a pass is independent, so a
    pass is a few whole-tensor ops: log2(max_dim) * ndim passes in all.
    """

    name = "interp"

    def __init__(self, kind: Optional[str] = None):
        self.kind = kind

    def estimate_error(self, sample, abs_eb, conf):
        return code_bits(interp_residuals(sample), abs_eb, conf.quant_radius)

    # -- pass geometry (host) --------------------------------------------------
    @staticmethod
    def _passes(shape: Tuple[int, ...]):
        """Yield (axis, stride, coords_per_axis) for every pass, coarse->fine."""
        max_dim = max(shape)
        level = max(1, int(np.ceil(np.log2(max(2, max_dim)))))
        for lev in range(level, 0, -1):
            s = 1 << (lev - 1)
            if s >= max_dim:
                continue
            for ax in range(len(shape)):
                targets = np.arange(s, shape[ax], 2 * s)
                if targets.size == 0:
                    continue
                other: List[np.ndarray] = []
                for j in range(len(shape)):
                    if j == ax:
                        other.append(targets)
                    elif j < ax:
                        other.append(np.arange(0, shape[j], s))
                    else:
                        other.append(np.arange(0, shape[j], 2 * s))
                yield ax, s, other

    @staticmethod
    def _ix(coords: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, ...]:
        """``np.ix_`` as torch index tensors on ``device``."""
        nd = len(coords)
        out = []
        for ax, c in enumerate(coords):
            shape = [1] * nd
            shape[ax] = c.size
            out.append(torch.from_numpy(c).to(device).reshape(shape))
        return tuple(out)

    def _predict_pass(
        self, xhat: torch.Tensor, ax: int, s: int, coords: Sequence[np.ndarray], kind: str
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Predictions for one pass and the pass's index grid.  The
        arithmetic is the JAX package's, one IEEE op at a time."""
        ts = coords[ax]
        dim = xhat.shape[ax]
        dev = xhat.device

        def grab(offsets: np.ndarray) -> torch.Tensor:
            cs = list(coords)
            cs[ax] = offsets
            return xhat[self._ix(cs, dev)]

        left = grab(ts - s)
        has_r = ts + s < dim
        right = grab(np.where(has_r, ts + s, ts - s))
        shape_bc = [1] * xhat.ndim
        shape_bc[ax] = ts.size
        has_r_bc = torch.from_numpy(has_r).to(dev).reshape(shape_bc)
        pred = torch.where(has_r_bc, (left + right) * 0.5, left)
        if kind == "cubic":
            has_ll = ts - 3 * s >= 0
            has_rr = ts + 3 * s < dim
            full = has_ll & has_rr & has_r
            if full.any():
                ll = grab(np.where(has_ll, ts - 3 * s, ts - s))
                rr = grab(np.where(has_rr, ts + 3 * s, ts - s))
                # (-ll + 9*left + 9*right - rr) / 16, as separate ops: no
                # fused multiply-add may round it differently
                cubic = true_div(((-ll) + left * 9.0) + right * 9.0 - rr, 16.0)
                full_bc = torch.from_numpy(full).to(dev).reshape(shape_bc)
                pred = torch.where(full_bc, cubic, pred)
        return pred, self._ix(coords, dev)

    def compress(self, data, quantizer, conf):
        kind = self.kind or conf.interp_kind
        x64 = data.to(torch.float64)
        xhat = torch.zeros_like(x64)
        all_codes: List[torch.Tensor] = []
        # anchor point: origin, predicted as 0
        origin = (0,) * x64.ndim
        zero = torch.zeros(1, dtype=torch.float64, device=x64.device)
        c0, r0 = quantizer.quantize(x64[origin].reshape(1), zero)
        xhat[origin] = r0[0].to(torch.float64)
        all_codes.append(c0)
        for ax, s, coords in self._passes(tuple(x64.shape)):
            pred, idx = self._predict_pass(xhat, ax, s, coords, kind)
            codes, recon = quantizer.quantize(x64[idx].reshape(-1), pred.reshape(-1))
            xhat[idx] = recon.reshape(pred.shape).to(torch.float64)
            all_codes.append(codes)
        return torch.cat(all_codes), {"kind": kind}

    def decompress(self, codes, shape, dtype, quantizer, conf, meta):
        kind = meta["kind"]
        _check_count(codes, shape)
        xhat = torch.zeros(tuple(shape), dtype=torch.float64, device=codes.device)
        origin = (0,) * len(shape)
        zero = torch.zeros(1, dtype=torch.float64, device=codes.device)
        xhat[origin] = quantizer.recover(zero, codes[0:1])[0].to(torch.float64)
        pos = 1
        for ax, s, coords in self._passes(tuple(shape)):
            pred, idx = self._predict_pass(xhat, ax, s, coords, kind)
            n = pred.numel()
            recon = quantizer.recover(pred.reshape(-1), codes[pos : pos + n])
            xhat[idx] = recon.reshape(pred.shape).to(torch.float64)
            pos += n
        return xhat.to(dtype)


# ---------------------------------------------------------------------------
# Composite predictor (SZ2 multi-algorithm selection)
# ---------------------------------------------------------------------------

class CompositePredictor(Predictor):
    """Block-wise best-of selection between Lorenzo and regression (SZ2 [8]).

    Per block the absolute error of each candidate is estimated on a strided
    sample (paper: ``estimate_error``); the winner's codes are kept.  Lorenzo
    runs block-locally on prequantized integers (dual-quant) so the decoder
    never needs cross-candidate reconstructions.  Selection flags are packed
    into meta (1 bit per block).
    """

    name = "composite"

    def estimate_error(self, sample, abs_eb, conf):
        # best-of its two candidates, mirroring the block-wise contest below,
        # plus the 1-bit-per-block selection flag it must also code
        x = _host64(sample)
        flag_bits = 1.0 / float(max(2, conf.block_size)) ** max(1, x.ndim)
        return flag_bits + min(
            code_bits(lorenzo_residuals(x, abs_eb, 1, conf.quant_radius), abs_eb, conf.quant_radius),
            regression_bits(x, abs_eb, conf.block_size, conf.quant_radius),
        )

    def compress(self, data, quantizer, conf):
        b = int(conf.block_size)
        nd = data.ndim
        x, orig_shape = pad_to_blocks(data.to(torch.float64), b)
        blocks = blockify(x, b)  # (nb, b, ..., b)
        nb = blocks.shape[0]
        eb = quantizer.eb

        # --- candidate 1: block-local dual-quant Lorenzo ---
        qfull, _recon, fail = quantizer.prequantize(blocks)
        d_lor = qfull
        for ax in range(1, nd + 1):
            shape = list(d_lor.shape)
            shape[ax] = 1
            d_lor = torch.diff(d_lor, dim=ax, prepend=d_lor.new_zeros(shape))

        # --- candidate 2: regression plane from quantized coefficients ---
        # non-finite block means (nan/inf inputs) quantize to garbage by
        # design: those blocks lose the contest or their points ride the
        # unpredictable fail path
        coef_q = [
            rint_int64(true_div(vals, 2.0 * _coef_eb(eb, k, b)))
            for k, vals in enumerate(_fit_coeffs(blocks, b))
        ]
        qhat = [q.to(torch.float64) * (2.0 * _coef_eb(eb, k, b)) for k, q in enumerate(coef_q)]
        pred_reg = _plane(qhat, block_coords(b, nd, blocks.device), nb)

        # --- estimation on strided samples (paper: estimate_error) ---
        stride = max(1, int(conf.sample_stride))
        sample = (slice(None),) + (slice(0, b, stride),) * nd
        est_lor = torch.clamp(
            d_lor[sample].abs().to(torch.float64) * (2.0 * eb), max=2.0 * eb * quantizer.radius
        )
        est_lor = block_sums(est_lor)
        est_reg = block_sums((blocks[sample] - pred_reg[sample]).abs())
        use_reg = est_reg < est_lor

        # --- emit codes: per-block winner, streams interleaved block-major ---
        # regression coefficient streams are only kept for winning blocks
        coef_codes = []
        for qc in coef_q:
            kept = qc[use_reg]
            coef_codes.append(quantizer.quantize_int_diff(torch.diff(kept, prepend=kept.new_zeros(1))))
        lor_codes = quantizer.quantize_int_diff(d_lor[~use_reg].reshape(-1))
        dcodes, _ = quantizer.quantize(blocks[use_reg].reshape(-1), pred_reg[use_reg].reshape(-1))
        codes = torch.cat(coef_codes + [lor_codes, dcodes])
        meta: Dict[str, Any] = {
            "orig_shape": list(orig_shape),
            "padded_shape": list(x.shape),
            "b": b,
            "nb": int(nb),
            "flags": _pack_mask(use_reg),
            "n_reg": int(use_reg.sum()),
            "nfail": int(fail.sum()),
        }
        if meta["nfail"]:
            lor_fail = fail[~use_reg]
            meta["fail_mask"] = _pack_mask(lor_fail)
            meta["fail_vals"] = to_host(blocks[~use_reg][lor_fail]).tobytes()
        return codes, meta

    def decompress(self, codes, shape, dtype, quantizer, conf, meta):
        b = int(meta["b"])
        nb = int(meta["nb"])
        padded_shape = tuple(meta["padded_shape"])
        nd = len(padded_shape)
        eb = quantizer.eb
        dev = codes.device
        use_reg = to_device(_unpack_mask(meta["flags"], nb), dev)
        n_reg = int(meta["n_reg"])
        n_lor = nb - n_reg
        pos = 0
        qhat = []
        for k in range(nd + 1):
            dq = quantizer.recover_int_diff(codes[pos : pos + n_reg])
            pos += n_reg
            qhat.append(torch.cumsum(dq, 0).to(torch.float64) * (2.0 * _coef_eb(eb, k, b)))
        blk_elems = b**nd
        d_lor = quantizer.recover_int_diff(codes[pos : pos + n_lor * blk_elems])
        pos += n_lor * blk_elems
        qfull = d_lor.reshape((n_lor,) + (b,) * nd)
        for ax in range(nd, 0, -1):
            qfull = torch.cumsum(qfull, dim=ax)
        lor_blocks = quantizer.dequantize_int(qfull).to(torch.float64)
        if meta.get("nfail"):
            fl = _unpack_mask(meta["fail_mask"], n_lor * blk_elems)
            vals = np.frombuffer(meta["fail_vals"], np.float64)
            if int(fl.sum()) != vals.size:
                raise ValueError(
                    f"fail channel holds {vals.size} values for {int(fl.sum())} masked points"
                )
            flat = lor_blocks.reshape(-1)
            flat[to_device(fl, dev)] = to_device(vals.copy(), dev)
        pred_reg = _plane(qhat, block_coords(b, nd, dev), n_reg)
        reg_recon = quantizer.recover(pred_reg.reshape(-1), codes[pos:])
        blocks = torch.empty((nb,) + (b,) * nd, dtype=torch.float64, device=dev)
        blocks[~use_reg] = lor_blocks
        blocks[use_reg] = reg_recon.reshape((n_reg,) + (b,) * nd).to(torch.float64)
        out = unblockify(blocks, padded_shape, b)
        sl = tuple(slice(0, s) for s in meta["orig_shape"])
        return out[sl].to(dtype)


# ---------------------------------------------------------------------------
# Sequential Lorenzo (paper-faithful SZ1.4 semantics; a host loop)
# ---------------------------------------------------------------------------

def _rint(v: float) -> float:
    """numpy's ``rint`` on one float64: half to even; nan/inf pass."""
    return float(round(v)) if math.isfinite(v) else v


def _fma(a: float, b: float, c: float) -> float:
    """``a * b + c`` rounded once, as XLA's CPU backend contracts the JAX
    package's ``pred + q * two_eb`` (exact rational arithmetic, one rounding
    to float64; non-finite operands keep IEEE semantics)."""
    if not (math.isfinite(a) and math.isfinite(b) and math.isfinite(c)):
        return a * b + c
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    try:
        return float(exact)
    except OverflowError:
        return math.copysign(math.inf, exact)


class LorenzoSequentialPredictor(Predictor):
    """Predict each point from *decompressed* neighbours, in raster scan order.

    The paper-faithful SZ1.4/SZ2 Lorenzo semantics: the value used for
    prediction is the reconstruction the decompressor will have, so the
    quantization-error feedback travels through the scan.  The JAX package
    runs it as one float64 ``jax.lax.scan`` with a ring buffer of the
    trailing reconstruction window; this is the same arithmetic as a
    sequential float64 loop on the host, step for step: the inclusion-
    exclusion neighbours are read through 0/1 validity masks that MULTIPLY
    (so ``0 * inf`` is NaN, as there), storage-dtype casts round to nearest,
    ``rint`` rounds half to even, and ``pred + q * 2eb`` rounds once, as the
    fused multiply-add XLA's CPU backend makes of it.  Out-of-range
    neighbours read as 0.  The fidelity oracle of the parallel dual-quant
    variant; any ndim >= 1.
    """

    name = "lorenzo_seq"

    def estimate_error(self, sample, abs_eb, conf):
        return code_bits(
            lorenzo_residuals(sample, abs_eb, 1, conf.quant_radius), abs_eb, conf.quant_radius
        )

    @staticmethod
    def _stencil(shape: Tuple[int, ...]):
        """Inclusion-exclusion neighbour set: (flat_offset, sign, valid_mask)."""
        nd = len(shape)
        strides = np.ones(nd, np.int64)
        for k in range(nd - 2, -1, -1):
            strides[k] = strides[k + 1] * shape[k + 1]
        idx = np.indices(shape).reshape(nd, -1)
        subsets = []
        for bits in range(1, 1 << nd):
            axes = [k for k in range(nd) if bits & (1 << k)]
            off = int(sum(strides[k] for k in axes))
            sign = 1.0 if (len(axes) % 2 == 1) else -1.0
            valid = np.ones(idx.shape[1], bool)
            for k in axes:
                valid &= idx[k] >= 1
            subsets.append((off, sign, valid.astype(np.float64).tolist()))
        return subsets

    @staticmethod
    def _cast(dtype: torch.dtype):
        if dtype == torch.float64:
            return lambda v: v
        return lambda v: float(np.float32(v))

    def _scan(self, shape, eb, radius, dtype, stream, aligned=False):
        """Compress (``stream`` = values) or decode (``stream`` = (codes,
        q, escape, raw) channels) in scan order; returns the per-step
        outputs as lists."""
        subsets = self._stencil(tuple(shape))
        L = max(off for off, _, _ in subsets) + 1
        two_eb = 2.0 * eb
        cast = self._cast(dtype)
        buf = [0.0] * L
        decode = isinstance(stream, tuple)
        n = len(stream[0]) if decode else len(stream)
        codes, recons, preds = [0] * n, [0.0] * n, [0.0] * n
        with np.errstate(over="ignore", invalid="ignore"):
            for i in range(n):
                pred = 0.0
                for off, sign, mask in subsets:
                    pred = pred + sign * (buf[(i - off) % L] * mask[i])
                if decode:
                    code = stream[0][i]
                    if code == 0:
                        recon = stream[3][i] if stream[2][i] else cast(_fma(stream[1][i], two_eb, pred))
                    else:
                        recon = cast(_fma(float(code) - radius, two_eb, pred))
                else:
                    x = stream[i]
                    q = _rint((x - pred) / two_eb)
                    recon_try = cast(_fma(q, two_eb, pred))
                    if abs(q) < radius and abs(recon_try - x) <= eb:
                        recon, codes[i] = recon_try, int(q) + radius
                    elif aligned:
                        recon = x if abs(recon_try - x) > eb else recon_try
                    else:
                        recon = x
                    preds[i] = pred
                buf[i % L] = recon
                recons[i] = recon
        return codes, recons, preds

    def compress(self, data, quantizer, conf):
        x64 = to_host(data).astype(np.float64).reshape(-1)
        codes, _, preds = self._scan(
            tuple(data.shape), quantizer.eb, quantizer.radius, data.dtype,
            x64.tolist(), aligned=quantizer.name == "unpred_aware",
        )
        codes = np.asarray(codes, np.int64)
        un = codes == 0
        if un.any():
            quantizer.absorb_unpred(x64[un], np.asarray(preds, np.float64)[un])
        return torch.from_numpy(codes).to(data.device), {}

    def decompress(self, codes, shape, dtype, quantizer, conf, meta):
        _check_count(codes, shape)
        c = to_host(codes).astype(np.int64).reshape(-1)
        n = c.size
        un = c == 0
        un_q = np.zeros(n, np.float64)
        un_esc = np.zeros(n, bool)
        un_raw = np.zeros(n, np.float64)
        cnt = int(un.sum())
        if cnt:
            q, esc, raw = quantizer.emit_unpred_channels(cnt)
            if q.size != cnt or raw.size != cnt:
                raise ValueError("unpredictable stream exhausted — corrupt payload")
            un_q[un], un_esc[un], un_raw[un] = q, esc, raw
        _, recons, _ = self._scan(
            tuple(shape), quantizer.eb, quantizer.radius, dtype,
            (c.tolist(), un_q.tolist(), un_esc.tolist(), un_raw.tolist()),
        )
        out = torch.tensor(recons, dtype=torch.float64).reshape(tuple(shape))
        return out.to(codes.device, dtype)


# ---------------------------------------------------------------------------
# Pattern predictor (SZ-Pastri)
# ---------------------------------------------------------------------------

class PatternPredictor(Predictor):
    """Periodic pattern + per-block scaling (SZ-Pastri [19]).

    GAMESS ERI blocks repeat a template scaled per block; the template is
    chosen as the max-energy window, itself quantized and sent first, then a
    per-block least-squares scale (delta-quantized), then the residual codes:
    the three code sections are paper Fig 3's data/pattern/scale split.

    The quantization runs on the data's device.  The float64 reductions
    whose results are written into the blob are computed as numpy computes
    them: the period's FFT and the per-block scales (a BLAS product) with
    numpy on host copies, the block energies and the template's norm in
    numpy's pairwise order (``pairwise_rowsum``) on the device.
    """

    name = "pattern"

    def __init__(self, pattern_size: Optional[int] = None):
        self.pattern_size = pattern_size

    @staticmethod
    def detect_period(x, lo: int = 4, hi: int = 4096) -> int:
        """Autocorrelation peak via FFT (preprocessing step of SZ-Pastri),
        on a host copy of at most 2^16 samples (tensor or array)."""
        size = x.numel() if isinstance(x, torch.Tensor) else np.size(x)
        n = min(size, 1 << 16)
        head = x.reshape(-1)[:n]
        v = _host64(head)
        v = v - v.mean()
        f = np.fft.rfft(v, n=2 * n)
        ac = np.fft.irfft(f * np.conj(f))[: n // 2]
        hi = min(hi, ac.size - 1)
        if hi <= lo:
            return max(2, min(64, size))
        seg = ac[lo : hi + 1]
        return int(lo + np.argmax(seg))

    def compress(self, data, quantizer, conf):
        dev = data.device
        flat = data.reshape(-1).to(torch.float64)
        n = flat.numel()
        P = self.pattern_size or conf.pattern_size or self.detect_period(flat)
        P = max(2, min(P, n))
        nb = n // P
        tail = n - nb * P
        body = flat[: nb * P].reshape(nb, P)
        check_numpy_sum_order()  # the energies and the norm are numpy's sums
        # template: max-energy block, quantized through the shared quantizer
        t_idx = int(torch.argmax(pairwise_rowsum(body * body))) if nb else 0
        template = body[t_idx] if nb else flat[:P]
        tcodes, that = quantizer.quantize(template, torch.zeros(P, dtype=torch.float64, device=dev))
        that = that.to(torch.float64)
        tt = float(pairwise_rowsum((that * that)[None, :])[0])
        if tt <= 0:
            scales = np.zeros(nb)
        else:
            scales = to_host(body) @ to_host(that) / tt
        # quantize scales (delta, integer stream)
        s_eb = quantizer.eb / (max(1.0, float(that.abs().max())))
        sq = np.rint(scales / (2.0 * s_eb)).astype(np.int64)
        scodes = quantizer.quantize_int_diff(torch.from_numpy(np.diff(sq, prepend=0)).to(dev))
        shat = torch.from_numpy(sq).to(dev, torch.float64) * (2.0 * s_eb)
        pred = shat[:, None] * that[None, :]
        dcodes, _ = quantizer.quantize(body.reshape(-1), pred.reshape(-1))
        parts = [tcodes, scodes.to(tcodes.dtype), dcodes]
        if tail:
            # tail: predict with the template prefix scaled by the last scale
            tp = (shat[-1] if nb else 0.0) * that[:tail]
            tl_codes, _ = quantizer.quantize(flat[nb * P :], tp)
            parts.append(tl_codes)
        meta = {
            "P": int(P),
            "nb": int(nb),
            "tail": int(tail),
            "s_eb": float(s_eb),
            "sections": [int(tcodes.numel()), int(scodes.numel()), int(dcodes.numel())],
        }
        return torch.cat(parts), meta

    def decompress(self, codes, shape, dtype, quantizer, conf, meta):
        P, nb, tail = int(meta["P"]), int(meta["nb"]), int(meta["tail"])
        s_eb = float(meta["s_eb"])
        n = math.prod(shape)
        if min(P, nb, tail) < 0 or nb * P + tail != n or codes.numel() != P + nb + nb * P + tail:
            raise ValueError(
                f"pattern meta (P={P}, nb={nb}, tail={tail}) and {codes.numel()} "
                f"codes do not describe shape {tuple(shape)}"
            )
        dev = codes.device
        pos = 0
        zeros = torch.zeros(P, dtype=torch.float64, device=dev)
        that = quantizer.recover(zeros, codes[pos : pos + P]).to(torch.float64)
        pos += P
        dsq = quantizer.recover_int_diff(codes[pos : pos + nb])
        pos += nb
        shat = torch.cumsum(dsq, 0).to(torch.float64) * (2.0 * s_eb)
        pred = shat[:, None] * that[None, :]
        body = quantizer.recover(pred.reshape(-1), codes[pos : pos + nb * P])
        pos += nb * P
        out = torch.empty(n, dtype=torch.float64, device=dev)
        out[: nb * P] = body
        if tail:
            tp = (shat[-1] if nb else 0.0) * that[:tail]
            out[nb * P :] = quantizer.recover(tp, codes[pos : pos + tail])
        return out.reshape(shape).to(dtype)


_REGISTRY = {
    "zero": ZeroPredictor,
    "lorenzo": LorenzoPredictor,
    "lorenzo_seq": LorenzoSequentialPredictor,
    "regression": RegressionPredictor,
    "interp": InterpolationPredictor,
    "pattern": PatternPredictor,
    "composite": CompositePredictor,
}


def register(name: str, cls) -> None:
    _REGISTRY[name] = cls


def make(name: str, **kw) -> Predictor:
    return _REGISTRY[name](**kw)
