"""Predictor module (paper §3.2 "Predictor", Appendix A.2).

Instances:

  * LorenzoPredictor          — N-D Lorenzo [34] in *dual-quantization* form
                                (cuSZ, arXiv:2007.09625): data are prequantized
                                onto the 2*eb grid once, then the Lorenzo
                                stencil runs on exact integers; the inverse is
                                a cumulative sum.  Error bound identical to SZ.
  * ZeroPredictor             — predicts 0 (baseline / bypass).

Predictors take and return torch tensors on the caller's device and drive
the quantizer through its array-at-a-time interface.  Their codes and meta
are byte-identical to the JAX package's predictors of the same name.
"""
from __future__ import annotations

import abc
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import telemetry as tel
from .config import CompressionConfig
from .quantizers import QuantizerBase, to_host, true_div
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


def code_bits(abs_errors: torch.Tensor, abs_eb: float, radius: int = 32768) -> float:
    """Mean estimated coded bits/element for given |prediction errors|.

    Errors become quantization-bin indices (e/(2*eb)); the entropy stage pays
    the empirical entropy of that bin population, and out-of-range points are
    stored raw (~64 bits).  This is the common currency pipelines are
    contested in.
    """
    e = abs_errors.to(torch.float64).reshape(-1)
    if e.numel() == 0:
        return 0.0
    return _int_code_bits(torch.round(true_div(e, 2.0 * abs_eb)), radius)


def _int_code_bits(q: torch.Tensor, radius: int) -> float:
    """Entropy of integer bin indices + raw-storage cost of out-of-range ones."""
    q = q.abs().reshape(-1)
    if q.numel() == 0:
        return 0.0
    out = q >= radius
    inr = q[~out]
    bits = 64.0 * float(out.to(torch.float64).mean())
    if inr.numel():
        _, counts = torch.unique(inr, return_counts=True)
        p = counts.to(torch.float64) / inr.numel()
        bits += float(-(p * torch.log2(p)).sum()) * float((~out).to(torch.float64).mean())
    return bits


def lorenzo_residuals(
    sample: torch.Tensor, abs_eb: float, order: int = 1, radius: int = 32768
) -> torch.Tensor:
    """|Lorenzo prediction error| per sample point (paper: estimate_error):
    the magnitude of the prequantized stencil output, clipped at the code
    range."""
    x64 = sample.to(torch.float64)
    if x64.numel() == 0:
        return torch.zeros(0, dtype=torch.float64, device=sample.device)
    q = torch.round(true_div(x64, 2.0 * abs_eb))
    est = lorenzo_filter(q, order).abs() * (2.0 * abs_eb)
    return torch.clamp(est, max=2.0 * abs_eb * radius)


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
    out[torch.from_numpy(mask).to(out.device)] = torch.from_numpy(vals.copy()).to(
        out.device, out.dtype
    )
    return out.reshape(shape)


class Predictor(abc.ABC):
    name: str = "abstract"

    def estimate_error(
        self, sample: torch.Tensor, abs_eb: float, conf: CompressionConfig
    ) -> Optional[float]:
        """Estimated entropy-coded bits/element this predictor would incur
        (the paper's ``estimate_error``, §3.2), comparable across predictors
        (see :func:`code_bits`).  ``None`` means "no cheap estimator"."""
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
        return code_bits(sample.to(torch.float64).abs(), abs_eb, conf.quant_radius)

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


_REGISTRY = {
    "zero": ZeroPredictor,
    "lorenzo": LorenzoPredictor,
}


def make(name: str, **kw) -> Predictor:
    return _REGISTRY[name](**kw)
