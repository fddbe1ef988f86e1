"""numcodecs-compatible codec facade: SZ3 as a drop-in array-store filter.

The JAX package's ``repro.codec``, ported.  ``Sz3Codec`` wraps the
pipelines behind the three-method protocol (``encode`` / ``decode`` /
``get_config``) that zarr, numcodecs filter chains, and anything else
speaking the `numcodecs.abc.Codec` contract expect.  The container is the
ordinary self-describing SZ3 blob, so bytes written through the codec decode
with plain :func:`repro_torch.core.decompress` (and the JAX package's) and
vice versa — the codec adds vocabulary, not format.  Its config is the JAX
package's, key for key, so a stored config opens in either package.

Encode and decode run on ``device`` (``"cuda"`` unless the caller passes
``"cpu"``); the protocol's buffers are host arrays, so ``decode`` returns a
numpy array.

numcodecs itself is OPTIONAL: when it is importable the codec subclasses
``numcodecs.abc.Codec`` and registers under ``codec_id="repro.sz3"`` (zarr
can then resolve it from stored metadata); without it the same class still
works standalone with an identical API.

    >>> codec = Sz3Codec(eb_mode="abs", eb_abs=1e-3, predictor="fast", device="cpu")
    >>> buf = codec.encode(np.arange(1e6, dtype=np.float32))
    >>> out = codec.decode(buf)
    >>> codec2 = Sz3Codec.from_config(codec.get_config())  # round-trips

Vocabulary: ``eb_mode`` picks the bound family (``abs``, ``rel``,
``pw_rel``, ``abs-and-rel``, ``abs-or-rel``, or ``psnr`` for the quality-
targeted controller), ``eb_abs`` / ``eb_rel`` / ``eb_psnr`` carry the
numbers, and ``predictor`` names the engine (friendly aliases or full
``sz3_*`` pipeline names).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .core import CompressionConfig, ErrorBoundMode
from .core import pipeline as pl_mod
from .core.pipeline import decompress as sz3_decompress

try:  # numcodecs is optional: the codec degrades to a plain class without it
    from numcodecs.abc import Codec as _CodecBase
    from numcodecs.registry import register_codec as _register_codec

    _HAVE_NUMCODECS = True
except Exception:  # pragma: no cover - exercised where numcodecs is absent
    _CodecBase = object
    _register_codec = None
    _HAVE_NUMCODECS = False

#: friendly predictor aliases -> registered pipeline factory names (the full
#: ``sz3_*`` names are accepted verbatim as well)
_PREDICTOR_ALIASES = {
    "auto": "sz3_auto",
    "fast": "sz3_fast",
    "chunked": "sz3_chunked",
    "hybrid": "sz3_hybrid",
    "lorenzo": "sz3_lorenzo",
    "lr": "sz3_lr",
    "interp": "sz3_interp",
    "transform": "sz3_transform",
    "pwr": "sz3_pwr",
}

_EB_MODES = ("abs", "rel", "pw_rel", "abs-and-rel", "abs-or-rel", "psnr")


class Sz3Codec(_CodecBase):
    """SZ3 error-bounded lossy compression as a numcodecs-style codec.

    Parameters
    ----------
    eb_mode:
        Bound family — one of ``abs``, ``rel``, ``pw_rel``, ``abs-and-rel``,
        ``abs-or-rel`` (both composite modes need ``eb_abs`` AND ``eb_rel``),
        or ``psnr`` (quality-targeted; needs ``eb_psnr``).
    eb_abs / eb_rel / eb_psnr:
        The bound numbers for the selected mode.
    predictor:
        Engine name: an alias from ``auto / fast / chunked / hybrid /
        lorenzo / lr / interp / transform / pwr`` or any registered
        ``sz3_*`` pipeline name.
    device:
        Where encode and decode run (default ``"cuda"``; not part of the
        stored config, which names the codec and not its placement).
    """

    codec_id = "repro.sz3"

    def __init__(
        self,
        eb_mode: str = "abs",
        eb_abs: float = 1e-3,
        eb_rel: Optional[float] = None,
        eb_psnr: Optional[float] = None,
        predictor: str = "auto",
        device: pl_mod.Device = "cuda",
    ):
        if eb_mode not in _EB_MODES:
            raise ValueError(
                f"eb_mode must be one of {_EB_MODES}, got {eb_mode!r}"
            )
        pname = _PREDICTOR_ALIASES.get(predictor, predictor)
        if pname not in pl_mod.PIPELINES:
            raise ValueError(
                f"unknown predictor {predictor!r} (aliases: "
                f"{sorted(_PREDICTOR_ALIASES)}; registered pipelines: "
                f"{sorted(pl_mod.PIPELINES)})"
            )
        if eb_mode in ("abs-and-rel", "abs-or-rel") and eb_rel is None:
            raise ValueError(f"eb_mode {eb_mode!r} needs eb_rel as well")
        if eb_mode == "psnr" and eb_psnr is None:
            raise ValueError("eb_mode 'psnr' needs eb_psnr")
        self.eb_mode = eb_mode
        self.eb_abs = float(eb_abs)
        self.eb_rel = None if eb_rel is None else float(eb_rel)
        self.eb_psnr = None if eb_psnr is None else float(eb_psnr)
        self.predictor = predictor
        self._pname = pname
        self.device = device

    # -- engine construction --------------------------------------------------
    def _conf(self) -> CompressionConfig:
        if self.eb_mode == "abs":
            return CompressionConfig(mode=ErrorBoundMode.ABS, eb=self.eb_abs)
        if self.eb_mode == "rel":
            # REL carries the fraction in eb (matches CompressionConfig)
            eb = self.eb_rel if self.eb_rel is not None else self.eb_abs
            return CompressionConfig(mode=ErrorBoundMode.REL, eb=eb)
        if self.eb_mode == "pw_rel":
            eb = self.eb_rel if self.eb_rel is not None else self.eb_abs
            return CompressionConfig(mode=ErrorBoundMode.PW_REL, eb=eb)
        return CompressionConfig(
            mode=ErrorBoundMode(self.eb_mode), eb=self.eb_abs,
            eb_rel=self.eb_rel,
        )

    def _engine(self):
        if self.eb_mode == "psnr":
            from .core import sz3_quality

            return sz3_quality(
                target_psnr=self.eb_psnr,
                device=self.device,
                **(
                    {}
                    if self.predictor in ("auto", "sz3_auto")
                    else {"candidates": (self._pname,)}
                ),
            )
        factory = pl_mod.PIPELINES[self._pname]
        if self._pname == "sz3_pwr":
            return factory(eb=self.eb_rel if self.eb_rel is not None else self.eb_abs, device=self.device)
        return factory(device=self.device)

    # -- numcodecs protocol ---------------------------------------------------
    def encode(self, buf) -> bytes:
        data = buf if isinstance(buf, torch.Tensor) else np.asarray(buf)
        numeric = (
            not (data.is_complex() or data.dtype == torch.bool)
            if isinstance(data, torch.Tensor)
            else data.dtype.kind in "fiu"
        )
        if not numeric:
            raise TypeError(
                f"Sz3Codec encodes numeric arrays, got dtype {data.dtype}"
            )
        conf = None if self.eb_mode == "psnr" else self._conf()
        if self.eb_mode == "pw_rel" and self._pname not in (
            "sz3_pwr", "sz3_auto", "sz3_chunked", "sz3_hybrid", "sz3_fast",
        ):
            # route pointwise-relative requests through the native engine
            # rather than a per-pipeline over-bound
            from .core import sz3_pwr

            return bytes(sz3_pwr(eb=conf.eb, device=self.device).compress(data, conf).blob)
        engine = self._engine()
        if self.eb_mode == "psnr":
            return bytes(engine.compress(data).blob)
        return bytes(engine.compress(data, conf).blob)

    def decode(self, buf, out=None):
        data = sz3_decompress(bytes(buf), device=self.device).cpu().numpy()
        if out is None:
            return data
        out_arr = (
            out
            if isinstance(out, np.ndarray)
            else np.frombuffer(out, dtype=data.dtype)
        )
        view = out_arr.reshape(-1).view(data.dtype)
        np.copyto(view[: data.size], data.reshape(-1), casting="no")
        return out

    # -- config round-trip ----------------------------------------------------
    def get_config(self) -> Dict[str, Any]:
        return {
            "id": self.codec_id,
            "eb_mode": self.eb_mode,
            "eb_abs": self.eb_abs,
            "eb_rel": self.eb_rel,
            "eb_psnr": self.eb_psnr,
            "predictor": self.predictor,
        }

    @classmethod
    def from_config(cls, config: Dict[str, Any], device: pl_mod.Device = "cuda") -> "Sz3Codec":
        config = dict(config)
        config.pop("id", None)
        return cls(**config, device=device)

    def __repr__(self) -> str:
        parts = [f"eb_mode={self.eb_mode!r}", f"eb_abs={self.eb_abs!r}"]
        if self.eb_rel is not None:
            parts.append(f"eb_rel={self.eb_rel!r}")
        if self.eb_psnr is not None:
            parts.append(f"eb_psnr={self.eb_psnr!r}")
        parts.append(f"predictor={self.predictor!r}")
        parts.append(f"device={str(self.device)!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


if _HAVE_NUMCODECS:  # make "repro.sz3" resolvable from stored zarr metadata
    _register_codec(Sz3Codec)
