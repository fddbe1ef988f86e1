"""Preprocessor module (paper §3.2 "Preprocessor", Appendix A.1).

Instances:
  * Identity        — module bypass.
  * LogTransform    — pointwise-relative-bound -> absolute-bound conversion in
                      the log domain (paper ref [20]); signs/zeros side-channel.
  * Transpose       — layout alteration; the APS pipeline's "treat the 3-D
                      stack as 256x256 1-D time series" preprocessor (paper §5.2).
  * Linearize       — collapse to 1-D (unstructured-grid support, paper §1).

``forward`` returns the data to compress (a new tensor; the caller's stays
intact), the updated config and serializable meta; ``inverse`` reverses it
during decompression.  Both take and return torch tensors on the caller's
device.  ``LogTransform`` computes its ``log2`` and ``exp2`` with numpy on a
host copy: the log field feeds ``rint`` and so the codes, and a device
library's float64 ``log2``/``exp2`` are not promised to round as numpy's do.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .config import CompressionConfig, ErrorBoundMode
from .quantizers import to_device, to_host


class Preprocessor(abc.ABC):
    name: str = "abstract"

    @abc.abstractmethod
    def forward(
        self, data: torch.Tensor, conf: CompressionConfig
    ) -> Tuple[torch.Tensor, CompressionConfig, Dict[str, Any]]: ...

    @abc.abstractmethod
    def inverse(
        self, data: torch.Tensor, conf: CompressionConfig, meta: Dict[str, Any]
    ) -> torch.Tensor: ...


class Identity(Preprocessor):
    name = "identity"

    def forward(self, data, conf):
        return data, conf, {}

    def inverse(self, data, conf, meta):
        return data


class Transpose(Preprocessor):
    """Permute axes (optionally flattening) before compression.

    The APS pipeline (paper §5.2) moves the time axis innermost so a 1-D
    Lorenzo predictor follows the high-correlation direction.
    """

    name = "transpose"

    def __init__(self, perm: Tuple[int, ...] = None, flatten: bool = False):
        self.perm = perm
        self.flatten = flatten

    def forward(self, data, conf):
        perm = self.perm if self.perm is not None else tuple(range(data.ndim))[::-1]
        out = data.permute(*perm).contiguous()
        meta = {"perm": [int(p) for p in perm], "shape": list(out.shape)}
        if self.flatten:
            out = out.reshape(-1)
        return out, conf, meta

    def inverse(self, data, conf, meta):
        perm = tuple(int(p) for p in meta["perm"])
        out = data.reshape(tuple(meta["shape"]))
        inv = tuple(int(i) for i in np.argsort(perm))
        return out.permute(*inv).contiguous()


class Linearize(Preprocessor):
    """Rearrange to a 1-D array (unstructured-grid support, paper §1)."""

    name = "linearize"

    def forward(self, data, conf):
        return data.reshape(-1), conf, {"shape": list(data.shape)}

    def inverse(self, data, conf, meta):
        return data.reshape(tuple(meta["shape"]))


def pw_rel_log_eb(eb: float) -> float:
    """The ABS bound in the log2 domain equivalent to pointwise-relative ``eb``.

    A log-domain error of delta reconstructs x * 2**delta; keeping
    ``|delta| <= min(log2(1+eb), -log2(1-eb))`` keeps the multiplier inside
    ``[1-eb, 1+eb]`` in BOTH directions (log2(1-eb) is the tighter side).
    """
    eb = float(eb)
    if not (0.0 < eb < 1.0):
        raise ValueError("pointwise-relative eb must be in (0, 1)")
    return float(min(np.log2(1.0 + eb), -np.log2(1.0 - eb)))


def log_domain_view(data) -> np.ndarray:
    """log2|x| with zeros / non-finite values mapped to 0.0 (= log2(1)), as a
    float64 numpy array on the host (``data``: tensor or array).

    The selection-time view of what :class:`LogTransform` will feed the
    predictor: pipeline contests for PW_REL chunks score THIS array.
    """
    flat = np.asarray(to_host(data) if isinstance(data, torch.Tensor) else data, np.float64)
    mag = np.abs(flat)
    safe = np.where(np.isfinite(flat) & (mag > 0), mag, 1.0)
    return np.log2(safe)


class LogTransform(Preprocessor):
    """Pointwise-relative error bounds via the logarithmic domain (ref [20]).

    x -> log2|x| in float64, compressed with the ABS bound
    :func:`pw_rel_log_eb` (so the reconstructed ratio x_hat/x stays within
    [1-eb, 1+eb] pointwise); signs are stored as a packed bitmap, exact zeros /
    sub-threshold values as an exact-positions bitmap (reconstructed as 0),
    and non-finite values ride an exact raw side channel, so the bound holds
    for every finite nonzero point and everything else round-trips exactly.

    Subnormal magnitudes of the storage dtype also ride the raw channel:
    their representable quantum is relatively enormous, so no log-domain
    bound survives the ``exp2`` + cast back.
    """

    name = "log"

    def __init__(self, zero_threshold: float = 0.0):
        self.zero_threshold = zero_threshold

    def forward(self, data, conf):
        if conf.mode != ErrorBoundMode.PW_REL:
            raise ValueError("LogTransform requires ErrorBoundMode.PW_REL")
        host = to_host(data)
        flat = np.asarray(host, np.float64).reshape(-1)
        thr = self.zero_threshold
        dt = host.dtype if host.dtype.kind == "f" else np.dtype(np.float32)
        finite = np.isfinite(flat)
        zero_mask = finite & (np.abs(flat) <= thr)
        subnormal = finite & ~zero_mask & (np.abs(flat) < float(np.finfo(dt).tiny))
        nonfinite_mask = ~finite | subnormal
        sign_mask = finite & (flat < 0)
        masked = zero_mask | nonfinite_mask
        safe = np.where(masked, 1.0, np.abs(flat))
        # float64 log domain regardless of input dtype: |log2| reaches ~1024,
        # where float32 resolution (~6e-5) would eat tight bounds
        logged = np.log2(safe).reshape(host.shape)
        # headroom for the rounding the log domain cannot see: the cast back
        # to the storage dtype (half an ulp) and exp2's own float64 rounding
        eps = float(np.finfo(dt).eps) / 2 + 2.0**-52
        eb = float(conf.eb)
        eb_adj = (eb - eps) / (1.0 + eps)
        if eb_adj <= 0:
            raise ValueError(
                f"pointwise-relative eb={eb:g} is below the {dt.name} "
                f"rounding floor ({eps:.2e}); the bound cannot survive the "
                "cast back to the storage dtype"
            )
        new_conf = conf.replace(mode=ErrorBoundMode.ABS, eb=pw_rel_log_eb(eb_adj))
        meta = {
            "signs": np.packbits(sign_mask).tobytes(),
            "zeros": np.packbits(zero_mask).tobytes(),
            "n": int(flat.size),
            "orig_mode": conf.mode.value,
            "orig_eb": float(conf.eb),
        }
        if nonfinite_mask.any():
            meta["nonfinite"] = np.packbits(nonfinite_mask).tobytes()
            meta["nonfinite_vals"] = flat[nonfinite_mask].tobytes()
        return torch.from_numpy(logged).to(data.device), new_conf, meta

    def inverse(self, data, conf, meta):
        n = int(meta["n"])
        signs = np.unpackbits(np.frombuffer(meta["signs"], np.uint8), count=n).astype(bool)
        zeros = np.unpackbits(np.frombuffer(meta["zeros"], np.uint8), count=n).astype(bool)
        host = to_host(data)
        flat = np.exp2(host.reshape(-1).astype(np.float64))
        flat = np.where(signs, -flat, flat)
        flat = np.where(zeros, 0.0, flat)
        if meta.get("nonfinite"):
            nf = np.unpackbits(np.frombuffer(meta["nonfinite"], np.uint8), count=n).astype(bool)
            flat[nf] = np.frombuffer(meta["nonfinite_vals"], np.float64)
        out = flat.astype(host.dtype).reshape(host.shape)
        return to_device(out, data.device)


_REGISTRY = {
    "identity": Identity,
    "transpose": Transpose,
    "linearize": Linearize,
    "log": LogTransform,
}


def register(name: str, cls) -> None:
    _REGISTRY[name] = cls


def make(name: str, **kw) -> Preprocessor:
    return _REGISTRY[name](**kw)
