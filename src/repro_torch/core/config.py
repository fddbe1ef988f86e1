"""Compression configuration — the SZ3 ``conf`` object.

Mirrors the paper's compression configuration: an error-bound mode + value,
quantizer geometry, and per-module knobs. Every module receives the config so
pipelines stay composable (the driver in ``pipeline.py`` never reads
module-specific fields).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping, Optional, Tuple


class ErrorBoundMode(enum.Enum):
    """How the user-specified error bound is interpreted.

    ABS         : max |x - x_hat| <= eb
    REL         : max |x - x_hat| <= eb * (max(x) - min(x))   (value-range relative)
    PW_REL      : |x_i - x_hat_i| <= eb * |x_i|  for every i  (point-wise relative,
                  realized via the logarithmic-transform preprocessor, paper §3.2)
    ABS_AND_REL : both bounds hold — resolves to min(eb, eb_rel * range)
    ABS_OR_REL  : the looser bound suffices — resolves to max(eb, eb_rel * range)

    The composite modes (SZ convention: ``errorBoundMode = ABS_AND_REL`` /
    ``ABS_OR_REL``) carry the absolute bound in ``eb`` and the range-relative
    fraction in ``eb_rel``.
    """

    ABS = "abs"
    REL = "rel"
    PW_REL = "pw_rel"
    ABS_AND_REL = "abs-and-rel"
    ABS_OR_REL = "abs-or-rel"


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Configuration threaded through every SZ3 module.

    Attributes
    ----------
    mode:         error bound interpretation (see :class:`ErrorBoundMode`).
    eb:           the user error bound in the units implied by ``mode``.  For
                  the composite modes this is the ABSOLUTE half of the pair.
    eb_rel:       the range-relative fraction for the composite modes
                  (``abs-and-rel`` / ``abs-or-rel``); ignored elsewhere.
    quant_radius: half-width of the quantization code range.  Codes live in
                  ``[1, 2*quant_radius - 1]`` with ``quant_radius`` = "diff 0";
                  code 0 is reserved for unpredictable points (SZ convention).
    block_size:   side length of the cubic blocks used by block-local
                  predictors (regression / composite selection), SZ2 default 6
                  for 3-D.  The Lorenzo kernels do not read it.
    pattern_size: pattern length for the Pastri predictor (None = auto-detect
                  via autocorrelation, see predictors.PatternPredictor).
    interp_kind:  "linear" | "cubic" for the interpolation predictor.
    lorenzo_order: 1 or 2 (second-order Lorenzo uses the wider stencil).
    sample_stride: stride used when sampling points for composite-predictor
                  error estimation (paper §3.2 Predictor: estimate_error).
    extras:       free-form per-module options (kept in a mapping so new
                  modules never require touching this dataclass — the paper's
                  extensibility claim).
    """

    mode: ErrorBoundMode = ErrorBoundMode.ABS
    eb: float = 1e-3
    eb_rel: Optional[float] = None
    quant_radius: int = 32768
    block_size: int = 6
    pattern_size: Optional[int] = None
    interp_kind: str = "cubic"
    lorenzo_order: int = 1
    sample_stride: int = 3
    extras: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def resolve_abs_eb(
        self,
        value_range: float,
        value_absmax: float,
        allow_conservative: bool = False,
    ) -> float:
        """Translate the configured bound into an absolute bound.

        REL bounds scale by value range (SZ convention).  PW_REL has no
        faithful single absolute bound — it is realized by the log-transform
        preprocessor, which converts the problem into an ABS problem in the
        log domain (PW_REL-native pipelines: ``sz3_pwr``, the chunked/auto
        engines, or any ``SZ3Compressor`` composed with
        ``preprocess.LogTransform``).  Resolving PW_REL here therefore raises,
        unless the caller explicitly opts into the conservative ``eb * absmax``
        over-bound with ``allow_conservative=True`` (every point then satisfies
        an ABS bound that only equals the pointwise-relative bound at the
        largest-magnitude value — far looser everywhere else).
        """
        if self.mode == ErrorBoundMode.ABS:
            return float(self.eb)
        if self.mode == ErrorBoundMode.REL:
            return float(self.eb) * float(value_range)
        if self.mode in (ErrorBoundMode.ABS_AND_REL, ErrorBoundMode.ABS_OR_REL):
            if self.eb_rel is None:
                raise ValueError(
                    f"mode {self.mode.value!r} needs both bounds: set eb to "
                    "the absolute bound and eb_rel to the range-relative "
                    "fraction"
                )
            rel = float(self.eb_rel) * float(value_range)
            if self.mode == ErrorBoundMode.ABS_AND_REL:
                return min(float(self.eb), rel)
            return max(float(self.eb), rel)
        if self.mode == ErrorBoundMode.PW_REL:
            if not allow_conservative:
                raise ValueError(
                    "PW_REL cannot be resolved to a single absolute bound; "
                    "use a PW_REL-native pipeline (sz3_pwr, sz3_chunked, "
                    "sz3_auto, or compose preprocess.LogTransform into an "
                    "SZ3Compressor), or opt into the conservative eb*absmax "
                    "fallback with allow_conservative=True"
                )
            return float(self.eb) * float(value_absmax)
        raise ValueError(f"unknown error bound mode {self.mode}")

    def replace(self, **kw: Any) -> "CompressionConfig":
        return dataclasses.replace(self, **kw)


# Canonical shorthand used across the codebase.
Shape = Tuple[int, ...]
