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
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import telemetry as tel

_INT64_MAX = np.iinfo(np.int64).max


def rint_int64(v: torch.Tensor) -> torch.Tensor:
    """``np.rint(v).astype(np.int64)``, with x86's answer for what int64
    cannot hold (nan, inf, |v| >= 2^63): INT64_MIN.  torch's own cast is
    undefined there and saturates on the card."""
    ok = torch.isfinite(v) & (v.abs() < 2.0**63)
    q = torch.round(torch.where(ok, v, 0.0)).to(torch.int64)
    return torch.where(ok, q, torch.iinfo(torch.int64).min)


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as an IEEE divide on every device.

    On CUDA, dividing by a Python or CPU scalar is rewritten to a multiply by
    its reciprocal, which can differ from numpy's divide in the last bit and
    so change a rounded quantization index.  A 0-dim divisor on ``x``'s own
    device keeps the true divide; it is filled there (``torch.full``), since
    a tensor copied from the host would wait for the stream."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def pairwise_rowsum(v: torch.Tensor) -> torch.Tensor:
    """Row sums of a 2-D tensor, rounded as ``np.sum`` along a contiguous
    axis rounds them, on every device.

    numpy's pairwise rule, as a fixed sequence of elementwise adds over
    columns (IEEE adds round alike on the CPU and the card; torch's own
    reductions use other orders): below 8 terms a running sum; up to 128,
    eight running sums over every eighth term, combined as a tree, then the
    remaining terms one by one; above 128, the two halves (the first cut to
    a multiple of 8) summed recursively.  The reduction starts from its
    identity 0.0, so a sum of negative zeros is +0.0, as in numpy."""
    return _pairwise(v, 0, v.shape[1]) + 0.0


def _pairwise(v: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    if n < 8:
        res = v.new_full((v.shape[0],), -0.0)
        for i in range(lo, lo + n):
            res = res + v[:, i]
        return res
    if n <= 128:
        r = v[:, lo : lo + 8]
        i = 8
        while i < n - n % 8:
            r = r + v[:, lo + i : lo + i + 8]
            i += 8
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
        for j in range(i, n):
            res = res + v[:, lo + j]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise(v, lo, n2) + _pairwise(v, lo + n2, n - n2)


#: block shapes whose sums decide bytes: regression/composite blocks of the
#: default 6 in 1-3 D, the composite's strided samples, a long run, and the
#: block hybrid's blocks in 1-4 D
_PROBE_SHAPES = (
    (6,), (2,), (2, 2), (2, 2, 2), (6, 6), (3, 3, 3), (6, 6, 6), (300,),
    (256,), (16, 16), (8, 8, 8), (4, 4, 4, 4),
)


@functools.lru_cache(maxsize=1)
def check_numpy_sum_order() -> None:
    """Raise unless this machine's numpy sums blocks in the order
    :func:`pairwise_rowsum` reproduces (``np.sum`` over the block axes of a
    C-contiguous (nb, b, ..., b) array, and its mean).  Blobs equal the JAX
    package's only where it does; checked once per process."""
    rng = np.random.default_rng(20210614)
    for shape in _PROBE_SHAPES:
        x = rng.standard_normal((512,) + shape) * np.exp(rng.uniform(-20, 20, (512,) + (1,) * len(shape)))
        axes = tuple(range(1, x.ndim))
        got = pairwise_rowsum(torch.from_numpy(x.reshape(512, -1))).numpy()
        n = float(np.prod(shape))
        if not (
            np.array_equal(got.view(np.int64), x.sum(axis=axes).view(np.int64))
            and np.array_equal((got / n).view(np.int64), x.mean(axis=axes).view(np.int64))
        ):
            raise RuntimeError(
                f"numpy {np.__version__} sums (512, {', '.join(map(str, shape))}) blocks in "
                "an order pairwise_rowsum does not reproduce; blobs of the "
                "regression predictors would differ from the JAX package's"
            )


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array, under a ``to_host`` span (bytes copied); on a
    CPU tensor the span times a handover."""
    with tel.span("to_host", bytes=t.numel() * t.element_size()):
        return t.detach().cpu().numpy()


def to_device(arr: np.ndarray, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.from_numpy(arr)`` on ``device`` (cast to ``dtype`` where
    given), under a ``to_device`` span (bytes: the host array's)."""
    with tel.span("to_device", bytes=arr.nbytes):
        t = torch.from_numpy(arr)
        return t.to(device) if dtype is None else t.to(device, dtype)


# ---------------------------------------------------------------------------
# Bitplane codec (the transform coder's band storage): byte-level coding on
# the host, in numpy, byte for byte the JAX package's format.
# ---------------------------------------------------------------------------

def bitplane_encode(vals: np.ndarray) -> bytes:
    """Encode int64 values as sign bitmap + MSB->LSB magnitude bitplanes."""
    vals = np.asarray(vals, np.int64).reshape(-1)
    n = vals.size
    header = np.empty(2, np.int64)
    if n == 0:
        header[:] = (0, 0)
        return header.tobytes()
    signs = vals < 0
    mags = np.abs(vals).astype(np.uint64)
    maxmag = int(mags.max())
    nplanes = max(1, maxmag.bit_length())
    header[:] = (n, nplanes)
    chunks = [header.tobytes(), np.packbits(signs).tobytes()]
    # MSB plane first: long zero-runs land together for the lossless stage.
    for p in range(nplanes - 1, -1, -1):
        plane = ((mags >> np.uint64(p)) & np.uint64(1)).astype(np.uint8)
        chunks.append(np.packbits(plane).tobytes())
    return b"".join(chunks)


def bitplane_decode(buf: bytes, offset: int = 0) -> Tuple[np.ndarray, int]:
    """Inverse of :func:`bitplane_encode`; returns (values, bytes_consumed)."""
    header = np.frombuffer(buf, np.int64, count=2, offset=offset)
    n, nplanes = int(header[0]), int(header[1])
    pos = offset + 16
    if n == 0:
        return np.zeros(0, np.int64), pos - offset
    nbytes_plane = (n + 7) // 8
    signs = np.unpackbits(
        np.frombuffer(buf, np.uint8, count=nbytes_plane, offset=pos), count=n
    ).astype(bool)
    pos += nbytes_plane
    mags = np.zeros(n, np.uint64)
    for p in range(nplanes - 1, -1, -1):
        plane = np.unpackbits(
            np.frombuffer(buf, np.uint8, count=nbytes_plane, offset=pos), count=n
        )
        mags |= plane.astype(np.uint64) << np.uint64(p)
        pos += nbytes_plane
    vals = mags.astype(np.int64)
    vals[signs] = -vals[signs]
    return vals, pos - offset


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
        self._escape_bits: List[np.ndarray] = []
        self._dec_int: Optional[np.ndarray] = None
        self._dec_raw: Optional[np.ndarray] = None
        self._dec_escape: Optional[np.ndarray] = None
        self._cursor_int = 0
        self._cursor_raw = 0
        self._cursor_esc = 0

    # -- lifecycle ---------------------------------------------------------
    def begin(self, abs_eb: float, dtype: torch.dtype) -> None:
        """Reset state for one (de)compression run with a resolved ABS bound."""
        if not np.isfinite(abs_eb) or abs_eb <= 0:
            raise ValueError(f"absolute error bound must be positive, got {abs_eb}")
        self._eb = float(abs_eb)
        self._dtype = dtype
        self._unpred_int, self._unpred_raw, self._escape_bits = [], [], []
        self._dec_int = self._dec_raw = self._dec_escape = None
        self._cursor_int = self._cursor_raw = self._cursor_esc = 0

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
            d[mask] = to_device(vals, d.device)
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

    # -- direct registration/emission for wavefront (scan) predictors -------
    def absorb_unpred(self, x64, p64) -> None:
        """Register unpredictable (x, pred) pairs a sequential predictor found
        in its scan, which applied the reconstruction policy itself; this
        records the payload so save() emits it (in scan order)."""
        x = torch.as_tensor(np.asarray(x64, np.float64))
        p = torch.as_tensor(np.asarray(p64, np.float64))
        mask = torch.ones(x.shape, dtype=torch.bool)
        self._store_unpred_float(x, p, mask, torch.zeros(x.shape, dtype=self._dtype))

    def emit_unpred_channels(self, count: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decompression side: the (q, escape, raw) channels of the next
        ``count`` unpredictable points, as host arrays.  A sequential decoder
        reconstructs ``raw`` where ``escape``, else ``pred + q * 2*eb`` (pred
        is only known inside its scan, hence the split)."""
        if isinstance(self, LinearScaleQuantizer):
            raw = self._dec_raw[self._cursor_raw : self._cursor_raw + count]
            self._cursor_raw += count
            return np.zeros(count, np.float64), np.ones(count, bool), np.asarray(raw, np.float64)
        esc = np.asarray(self._dec_escape[self._cursor_esc : self._cursor_esc + count], bool)
        self._cursor_esc += count
        n_raw = int(esc.sum())
        q_small = self._load_unpred_int(count - n_raw)
        raw_small = self._dec_raw[self._cursor_raw : self._cursor_raw + n_raw]
        self._cursor_raw += n_raw
        q = np.zeros(count, np.float64)
        raw = np.zeros(count, np.float64)
        q[~esc] = q_small.astype(np.float64)
        raw[esc] = raw_small
        return q, esc, raw

    # -- save/load (paper Appendix A.3) --------------------------------------
    def save(self) -> bytes:
        """Serialize the unpredictable payload: head [int stream bytes, raw
        count, escape-bit count] as int64, then the int stream (layout per
        subclass), the float64 raw values and the packed escape bits."""
        ints = np.concatenate(self._unpred_int) if self._unpred_int else np.zeros(0, np.int64)
        raws = np.concatenate(self._unpred_raw) if self._unpred_raw else np.zeros(0, np.float64)
        escs = np.concatenate(self._escape_bits) if self._escape_bits else np.zeros(0, np.uint8)
        int_payload = self._encode_int_stream(ints.astype(np.int64))
        esc_payload = np.packbits(escs).tobytes() if escs.size else b""
        head = np.asarray([len(int_payload), raws.size, escs.size], np.int64).tobytes()
        return head + int_payload + raws.astype(np.float64).tobytes() + esc_payload

    def load(self, buf: bytes) -> None:
        head = np.frombuffer(buf, np.int64, count=3)
        int_len, n_raw, n_esc = int(head[0]), int(head[1]), int(head[2])
        pos = 24
        self._dec_int = self._decode_int_stream(buf[pos : pos + int_len])
        pos += int_len
        self._dec_raw = np.frombuffer(buf, np.float64, count=n_raw, offset=pos)
        pos += n_raw * 8
        if n_esc:
            nb = (n_esc + 7) // 8
            self._dec_escape = np.unpackbits(
                np.frombuffer(buf, np.uint8, count=nb, offset=pos), count=n_esc
            ).astype(bool)
        else:
            self._dec_escape = np.zeros(0, bool)
        self._cursor_int = self._cursor_raw = self._cursor_esc = 0

    # how the int64 unpredictable stream is laid out — THE subclass difference
    def _encode_int_stream(self, ints: np.ndarray) -> bytes:
        return ints.tobytes()

    def _decode_int_stream(self, payload: bytes) -> np.ndarray:
        return np.frombuffer(payload, np.int64).copy()


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
        recon[mask] = to_device(vals.copy(), recon.device, self._dtype)
        return recon


class UnpredAwareQuantizer(QuantizerBase):
    """Paper §4.2: exponent-align unpredictable prediction errors to the error
    bound, store the resulting integers in MSB->LSB bitplane order.

    Float-domain unpredictables become q = rint((x - pred)/(2*eb)) (error
    <= eb); the rare points where a dtype cast would still break the bound
    escape to raw storage via a 1-bit side channel.  Integer-domain
    unpredictables (the dual-quant Lorenzo path, both routes) are
    bitplane-coded directly.  The arithmetic runs on the tensors' device;
    the streams are built on the host.
    """

    name = "unpred_aware"

    def _store_unpred_float(self, x64, p64, mask, recon):
        eb = self.eb
        xm, pm = x64[mask], p64[mask]
        scaled = true_div(xm - pm, 2.0 * eb)
        overflow = scaled.abs() >= float(_INT64_MAX // 2)
        # a NaN error is not escaped (NaN compares False) and is stored as
        # x86 numpy's cast of it, INT64_MIN, on every device
        q = rint_int64(torch.where(overflow, 0.0, scaled))
        cand = (pm + q.to(torch.float64) * (2.0 * eb)).to(self._dtype)
        bad = overflow | ((cand.to(torch.float64) - xm).abs() > eb)
        # escape channel: 1 = raw IEEE value, 0 = bitplane integer
        self._escape_bits.append(to_host(bad).astype(np.uint8))
        self._unpred_int.append(to_host(q[~bad]))
        if bool(bad.any()):
            self._unpred_raw.append(to_host(xm[bad]))
            cand = cand.clone()
            cand[bad] = xm[bad].to(self._dtype)
        recon = recon.clone()
        recon[mask] = cand
        return recon

    def _load_unpred_float(self, p64, mask, recon):
        count = int(mask.sum())
        esc = self._dec_escape[self._cursor_esc : self._cursor_esc + count]
        if esc.size != count:
            raise ValueError("escape stream exhausted — corrupt payload")
        self._cursor_esc += count
        n_raw = int(esc.sum())
        q = self._load_unpred_int(count - n_raw)
        raw = self._dec_raw[self._cursor_raw : self._cursor_raw + n_raw]
        if raw.size != n_raw:
            raise ValueError("unpredictable stream exhausted — corrupt payload")
        self._cursor_raw += n_raw
        dev = p64.device
        esc_t = to_device(esc.copy(), dev)
        preds = p64[mask]
        vals = torch.empty(count, dtype=torch.float64, device=dev)
        vals[~esc_t] = preds[~esc_t] + to_device(q, dev, torch.float64) * (2.0 * self.eb)
        if n_raw:
            vals[esc_t] = to_device(raw.copy(), dev)
        recon = recon.clone()
        recon[mask] = vals.to(self._dtype)
        return recon

    def _encode_int_stream(self, ints: np.ndarray) -> bytes:
        return bitplane_encode(ints)

    def _decode_int_stream(self, payload: bytes) -> np.ndarray:
        vals, _ = bitplane_decode(payload)
        return vals


_REGISTRY = {
    "linear": LinearScaleQuantizer,
    "unpred_aware": UnpredAwareQuantizer,
}


def register(name: str, cls) -> None:
    _REGISTRY[name] = cls


def make(name: str, **kw) -> QuantizerBase:
    return _REGISTRY[name](**kw)
