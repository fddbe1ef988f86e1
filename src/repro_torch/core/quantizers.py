"""Quantizer module (paper §3.2 "Quantizer", Appendix A.3).

The quantizer is the only lossy stage.  LinearScaleQuantizer is SZ's classic
linear-scaling quantizer: equal bins of width 2*eb; prediction errors become
bin indices; out-of-range points are "unpredictable" and stored exactly (raw
IEEE bytes), as in SZ1.4/SZ2.

Array math runs in torch on the device of the tensors it is given.  The
unpredictable side-storage is byte-level and lives on the host as numpy
arrays; its element order is the flattened scan order of each quantize()
call, which compression and decompression share, so the sequential
save()/load() semantics of the paper hold.  Every value matches the JAX
package's quantizer bit for bit: float64 divides are true IEEE divides (see
:func:`true_div`), rounding is half-to-even, and casts round to nearest.
"""
from __future__ import annotations

import abc
from typing import List, Optional, Tuple

import numpy as np
import torch

_INT64_MAX = np.iinfo(np.int64).max


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as an IEEE divide on every device.

    On CUDA, dividing by a Python or CPU scalar is rewritten to a multiply by
    its reciprocal, which can differ from numpy's divide in the last bit and
    so change a rounded quantization index.  A 0-dim divisor on ``x``'s own
    device keeps the true divide."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class QuantizerBase(abc.ABC):
    """Array-at-a-time analogue of the paper's QuantizerInterface."""

    name = "abstract"

    def __init__(self, radius: int = 32768):
        self.radius = int(radius)
        self._eb: Optional[float] = None
        self._dtype: Optional[torch.dtype] = None
        # compression-side accumulation / decompression-side cursor state
        self._unpred_int: List[np.ndarray] = []
        self._unpred_raw: List[np.ndarray] = []
        self._dec_int: Optional[np.ndarray] = None
        self._dec_raw: Optional[np.ndarray] = None
        self._cursor_int = 0
        self._cursor_raw = 0

    # -- lifecycle ---------------------------------------------------------
    def begin(self, abs_eb: float, dtype: torch.dtype) -> None:
        """Reset state for one (de)compression run with a resolved ABS bound."""
        if not np.isfinite(abs_eb) or abs_eb <= 0:
            raise ValueError(f"absolute error bound must be positive, got {abs_eb}")
        self._eb = float(abs_eb)
        self._dtype = dtype
        self._unpred_int, self._unpred_raw = [], []
        self._dec_int = self._dec_raw = None
        self._cursor_int = self._cursor_raw = 0

    @property
    def eb(self) -> float:
        if self._eb is None:
            raise RuntimeError("quantizer used before begin()")
        return self._eb

    @property
    def code_dtype(self):
        """Host dtype of the codes handed to the encoder."""
        return np.uint16 if self.radius <= (1 << 15) else np.uint32

    # -- float-domain interface (classic SZ predict->quantize loop) ---------
    def quantize(
        self, x: torch.Tensor, pred: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantize prediction errors; returns (codes, reconstruction).

        codes == 0 marks unpredictable points whose payload is accumulated for
        save(); reconstruction is what the decompressor will also compute.
        """
        eb, r = self.eb, self.radius
        x64 = x.to(torch.float64)
        p64 = pred.to(torch.float64)
        q = torch.round(true_div(x64 - p64, 2.0 * eb))
        in_range = q.abs() < r
        qi = torch.where(in_range, q, 0.0).to(torch.int64)
        recon = (p64 + qi.to(torch.float64) * (2.0 * eb)).to(self._dtype)
        ok = in_range & ((recon.to(torch.float64) - x64).abs() <= eb)
        codes = torch.where(ok, qi + r, 0).to(torch.int32)
        if not bool(ok.all()):
            recon = self._store_unpred_float(x64, p64, ~ok, recon)
        return codes, recon

    def recover(self, pred: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """Reverse of quantize() (paper's ``recover``)."""
        eb, r = self.eb, self.radius
        p64 = pred.to(torch.float64)
        q = codes.to(torch.int64) - r
        recon = (p64 + q.to(torch.float64) * (2.0 * eb)).to(self._dtype)
        mask = codes == 0
        if bool(mask.any()):
            recon = self._load_unpred_float(p64, mask, recon)
        return recon

    # -- integer-domain interface (dual-quantization Lorenzo path) ----------
    def prequantize(
        self, x: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x -> nearest multiple of 2*eb as int64; the only lossy step.

        Returns (qint, recon, fail_mask) where fail positions (bound broken by
        dtype-cast rounding or int64 overflow — pathological eb) must be
        patched with exact values by the caller.
        """
        eb = self.eb
        x64 = x.to(torch.float64)
        scaled = true_div(x64, 2.0 * eb)
        # non-finite inputs have no grid point; routing them through the fail
        # channel stores them exactly (nan/inf round-trip bit-stable)
        overflow = ~torch.isfinite(scaled) | (scaled.abs() >= float(_INT64_MAX // 2))
        q = torch.round(torch.where(overflow, 0.0, scaled)).to(torch.int64)
        recon = (q.to(torch.float64) * (2.0 * eb)).to(self._dtype)
        fail = overflow | ((recon.to(torch.float64) - x64).abs() > eb)
        return q, recon, fail

    def dequantize_int(self, q: torch.Tensor) -> torch.Tensor:
        return (q.to(torch.float64) * (2.0 * self.eb)).to(self._dtype)

    def quantize_int_diff(self, d: torch.Tensor) -> torch.Tensor:
        """Quantize integer Lorenzo differences; overflow -> unpredictable."""
        r = self.radius
        ok = d.abs() < r
        codes = torch.where(ok, d + r, 0).to(torch.int32)
        if not bool(ok.all()):
            self._store_unpred_int(d[~ok])
        return codes

    def recover_int_diff(self, codes: torch.Tensor) -> torch.Tensor:
        d = codes.to(torch.int64) - self.radius
        mask = codes == 0
        count = int(mask.sum())
        if count:
            vals = self._load_unpred_int(count)
            d[mask] = torch.from_numpy(vals).to(d.device)
        return d

    # -- unpredictable-point storage policy (subclass hook) -----------------
    @abc.abstractmethod
    def _store_unpred_float(self, x64, p64, mask, recon) -> torch.Tensor: ...

    @abc.abstractmethod
    def _load_unpred_float(self, p64, mask, recon) -> torch.Tensor: ...

    def _store_unpred_int(self, d: torch.Tensor) -> None:
        self._unpred_int.append(to_host(d.to(torch.int64)))

    def _load_unpred_int(self, count: int) -> np.ndarray:
        out = self._dec_int[self._cursor_int : self._cursor_int + count]
        if out.size != count:
            raise ValueError("unpredictable stream exhausted — corrupt payload")
        self._cursor_int += count
        return out

    # -- save/load (paper Appendix A.3) --------------------------------------
    def save(self) -> bytes:
        """Serialize the unpredictable payload: head [int bytes, raw count,
        escape-bit count] as int64, then the int64 diffs and the float64 raw
        values.  The escape channel belongs to the JAX package's unpred-aware
        quantizer; this one always writes it empty."""
        ints = np.concatenate(self._unpred_int) if self._unpred_int else np.zeros(0, np.int64)
        raws = np.concatenate(self._unpred_raw) if self._unpred_raw else np.zeros(0, np.float64)
        int_payload = ints.astype(np.int64).tobytes()
        head = np.asarray([len(int_payload), raws.size, 0], np.int64).tobytes()
        return head + int_payload + raws.astype(np.float64).tobytes()

    def load(self, buf: bytes) -> None:
        head = np.frombuffer(buf, np.int64, count=3)
        int_len, n_raw = int(head[0]), int(head[1])
        pos = 24
        self._dec_int = np.frombuffer(buf[pos : pos + int_len], np.int64).copy()
        pos += int_len
        self._dec_raw = np.frombuffer(buf, np.float64, count=n_raw, offset=pos)
        self._cursor_int = self._cursor_raw = 0


class LinearScaleQuantizer(QuantizerBase):
    """SZ1.4/SZ2 linear-scaling quantizer: unpredictables stored as raw IEEE
    values (exact reconstruction, zero further compressibility)."""

    name = "linear"

    def _store_unpred_float(self, x64, p64, mask, recon):
        self._unpred_raw.append(to_host(x64[mask]))
        recon = recon.clone()
        recon[mask] = x64[mask].to(self._dtype)
        return recon

    def _load_unpred_float(self, p64, mask, recon):
        count = int(mask.sum())
        vals = self._dec_raw[self._cursor_raw : self._cursor_raw + count]
        if vals.size != count:
            raise ValueError("unpredictable stream exhausted — corrupt payload")
        self._cursor_raw += count
        recon = recon.clone()
        recon[mask] = torch.from_numpy(vals.copy()).to(recon.device, self._dtype)
        return recon


_REGISTRY = {
    "linear": LinearScaleQuantizer,
}


def make(name: str, **kw) -> QuantizerBase:
    return _REGISTRY[name](**kw)
