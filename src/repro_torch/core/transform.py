"""Transform-based coding subsystem: blockwise decorrelation + bitplane coding.

The paper's pipelines are all prediction-based; this module is the OTHER
coder family of the lossy-compression literature (ZFP-style transform coding,
cf. Tao et al., arXiv:1806.08901):

  1. the array is padded (edge replication) to 4-point blocks per axis and
     each 4^d block is rotated by the orthonormal 4-point DCT-II basis
     ``MAT`` — smooth or oscillatory content concentrates into few bands;
  2. coefficients are quantized on an EXPONENT-ALIGNED grid: the step is the
     largest power of two such that the worst-case L_inf amplification of the
     inverse basis (``AMP_1AXIS ** ndim``) keeps every reconstructed value
     within the absolute error bound;
  3. integer coefficients are regrouped band-major (the DC band delta-coded
     across blocks) and stored as MSB-first embedded bitplane streams via
     ``quantizers.bitplane_encode``;
  4. the rare points where float rounding still breaks the bound (or
     non-finite inputs) are patched through a raw fail channel — the bound
     holds unconditionally.

Array math runs in torch on the data's device; the bitplane coding and the
lossless stage run on the host.  Two routes compute the coefficients:

  * host route — float64, any ndim: numpy's own product on CPU tensors, the
    float64 axis kernel (rounded as numpy rounds) on CUDA tensors, so the
    blob equals the JAX package's host-route blob byte for byte.
  * kernel route — 1-D/2-D float32 data of at least 4096 elements: the
    float32 ``fwd``/``inv`` kernels (``kernels/transform``).  Compress
    verifies the reconstruction against the float64 host inverse AND the
    float32 kernel inverse and patches stragglers, then tags the blob
    ``device_backend = "repro_torch"``.

``route="auto"`` takes the kernel route for CUDA tensors only, ``"force"``
wherever the size and dtype rule holds (the plain versions run on CPU
tensors), ``"off"`` never.  Decode takes the float32 inverse (kernel on the
card, plain version on the CPU) only for blobs carrying this package's tag;
every other blob — the JAX package's, tagged with a JAX backend name — takes
the float64 host inverse, which every compress verifies.  The tag is never a
JAX backend name, so the JAX package decodes this package's blobs through
its host inverse too.

Containers carry the v3 header tag (``kind: "transform"``).  The module also
holds ``sz3_auto``, the chunked engine over ``AUTO_CANDIDATES`` (prediction,
transform, block-hybrid and fast coders contesting per chunk).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import lossless as ll_mod
from . import pipeline as pl_mod
from . import telemetry as tel
from .chunking import DEFAULT_CANDIDATES, ChunkedCompressor
from .config import CompressionConfig
from .integrity import ContainerError, guard_alloc, guard_count, guard_shape
from .pipeline import CompressionResult, container_body, pack_container
from .predictors import _int_code_bits, _pack_mask, _unpack_mask
from .quantizers import bitplane_decode, bitplane_encode, to_host, true_div
from ..kernels.transform import ops as tops

_VERSION3 = 3
_BLOCK = 4

#: the basis and its 1-axis L_inf amplification (``kernels/transform/ref``)
MAT = tops.MAT
AMP_1AXIS = tops.AMP_1AXIS

_INT_SAFE = float(1 << 62)

#: cost-model calibration of the bitplane + lossless stage against the
#: empirical entropy (the JAX package's constant)
_BITPLANE_OVERHEAD = 1.15

#: the ``device_backend`` tag of blobs whose float32 kernel arithmetic this
#: package verified; never a JAX backend name (cpu, gpu, cuda, tpu, rocm)
BACKEND_TAG = "repro_torch"

_ROUTES = ("auto", "force", "off")


# ---------------------------------------------------------------------------
# blockwise separable transform (host route, float64)
# ---------------------------------------------------------------------------

def _fwd_host(x64: torch.Tensor) -> torch.Tensor:
    out = x64
    for ax in range(out.ndim - 1, -1, -1):  # last axis first (kernel order)
        out = tops.apply_axis_f64(out, MAT, ax)
    return out


def _inv_host(c64: torch.Tensor) -> torch.Tensor:
    out = c64
    for ax in range(out.ndim - 1, -1, -1):
        out = tops.apply_axis_f64(out, MAT.T, ax)
    return out


def _pad_blocks(x: torch.Tensor) -> torch.Tensor:
    """Edge-replicate to multiples of the block size (keeps edge-block
    coefficients small; zero padding would inject an artificial step)."""
    for ax, s in enumerate(x.shape):
        pad = (-s) % _BLOCK
        if pad:
            edge = x.narrow(ax, s - 1, 1)
            reps = [1] * x.ndim
            reps[ax] = pad
            x = torch.cat([x, edge.repeat(reps)], dim=ax)
    return x


def _blockify(kp: torch.Tensor) -> torch.Tensor:
    """Padded grid -> (4^d, nblocks) band-major (all DC together, ...)."""
    d = kp.ndim
    inter = []
    for s in kp.shape:
        inter += [s // _BLOCK, _BLOCK]
    t = kp.reshape(inter)
    order = list(range(1, 2 * d, 2)) + list(range(0, 2 * d, 2))
    return t.permute(order).reshape(_BLOCK**d, -1)


def _unblockify(bands: torch.Tensor, pshape: Tuple[int, ...]) -> torch.Tensor:
    d = len(pshape)
    if any(s % _BLOCK for s in pshape) or bands.numel() != math.prod(pshape):
        raise ContainerError(
            f"corrupt transform container: {tuple(bands.shape)} bands do not "
            f"tile the padded shape {list(pshape)}"
        )
    t = bands.reshape((_BLOCK,) * d + tuple(s // _BLOCK for s in pshape))
    order = []
    for i in range(d):
        order += [d + i, i]
    return t.permute(order).reshape(pshape)


def _step_exponent(abs_eb: float, ndim: int) -> int:
    """Largest power-of-two step with amp^ndim * step/2 <= abs_eb (the
    exponent alignment of the quantization grid)."""
    target = 2.0 * abs_eb / (AMP_1AXIS ** max(1, ndim))
    e = int(np.floor(np.log2(target)))
    return max(-1022, min(1023, e))


def _quantize_coeffs(c: torch.Tensor, step: float) -> torch.Tensor:
    """Coefficients -> int64 on the aligned grid; overflow positions -> 0
    (they surface as fail-channel points after verification).  ``step`` is a
    power of two, so the division is exact; ``torch.round`` rounds half to
    even like ``np.rint``."""
    scaled = true_div(c, step)
    bad = ~torch.isfinite(scaled) | (scaled.abs() >= _INT_SAFE)
    return torch.round(torch.where(bad, 0.0, scaled)).to(torch.int64)


def _encode_bands(bands: np.ndarray) -> bytes:
    """Band-major int64 -> concatenated embedded bitplane streams (DC band
    delta-coded across blocks first)."""
    parts = []
    for i in range(bands.shape[0]):
        vals = np.diff(bands[i], prepend=0) if i == 0 else bands[i]
        parts.append(bitplane_encode(vals))
    return b"".join(parts)


def _decode_bands(payload: bytes, nbands: int, nblocks: int) -> np.ndarray:
    bands = np.empty((nbands, nblocks), np.int64)
    pos = 0
    for i in range(nbands):
        vals, consumed = bitplane_decode(payload, pos)
        pos += consumed
        if vals.size != nblocks:
            raise ValueError("corrupt transform payload: band size mismatch")
        bands[i] = np.cumsum(vals) if i == 0 else vals
    return bands


# ---------------------------------------------------------------------------
# the compressor
# ---------------------------------------------------------------------------

class TransformCompressor:
    """Blockwise transform coder (the fourth coder family; see module doc)."""

    kind = "transform"

    #: below this many elements the kernel dispatch overhead dominates
    _KERNEL_MIN_SIZE = 4096

    def __init__(
        self,
        lossless: str = "zstd",
        route: str = "auto",
        conf: Optional[CompressionConfig] = None,
        device: pl_mod.Device = "cuda",
    ):
        if route not in _ROUTES:
            raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
        self.lossless = ll_mod.make(lossless)
        self.route = route
        self.conf = conf or CompressionConfig()
        self.device = device

    def spec(self) -> Dict[str, Any]:
        return {"kind": self.kind, "block": _BLOCK, "lossless": self.lossless.name}

    # -- cost model (the select_pipeline criterion) --------------------------
    def estimate_error(self, sample, abs_eb: float, conf: CompressionConfig) -> float:
        """Estimated coded bits/element on a sample — the same currency as the
        predictors' ``estimate_error`` (empirical entropy)."""
        dev = pl_mod.resolve_device(self.device)
        if isinstance(sample, torch.Tensor):
            x64 = sample.detach().to(dev, torch.float64)
        else:
            x64 = torch.from_numpy(np.asarray(sample, np.float64)).to(dev)
        if x64.numel() == 0:
            return 0.0
        if x64.ndim == 0:
            x64 = x64.reshape(1)
        x64 = torch.where(torch.isfinite(x64), x64, 0.0)
        step = 2.0 ** _step_exponent(abs_eb, x64.ndim)
        bands = _blockify(_quantize_coeffs(_fwd_host(_pad_blocks(x64)), step))
        bits = 0.0
        for i in range(bands.shape[0]):
            vals = torch.diff(bands[i], prepend=bands.new_zeros(1)) if i == 0 else bands[i]
            bits += _int_code_bits(vals, int(_INT_SAFE))
        return bits / bands.shape[0] * _BITPLANE_OVERHEAD

    # -- kernel routing ------------------------------------------------------
    def _kernel_ok(self, x: torch.Tensor) -> bool:
        if self.route == "off" or (self.route == "auto" and x.device.type != "cuda"):
            return False
        return x.ndim in (1, 2) and x.dtype == torch.float32 and x.numel() >= self._KERNEL_MIN_SIZE

    # -- compress ------------------------------------------------------------
    def compress(self, data, conf: Optional[CompressionConfig] = None, with_stats: bool = False) -> CompressionResult:
        """Compress a numpy array or torch tensor on this compressor's device."""
        conf = conf or self.conf
        data = pl_mod._as_tensor(data, pl_mod.resolve_device(self.device))
        shape = tuple(data.shape)
        x = data.reshape(1) if data.ndim == 0 else data
        x64 = x.to(torch.float64)
        finite = torch.isfinite(x64)
        rng, absmax = pl_mod._finite_stats(x64)
        abs_eb = conf.resolve_abs_eb(rng, absmax)
        if abs_eb <= 0:
            abs_eb = float(np.finfo(np.float64).tiny)
        meta: Dict[str, Any] = {}
        nbytes = data.numel() * data.element_size()
        if x.numel() == 0:
            header = self._header(shape, tuple(x.shape), data.dtype, conf, abs_eb, 0, 0, 0, meta)
            blob = pack_container(header, b"")
            return CompressionResult(blob=blob, ratio=nbytes / max(1, len(blob)))
        xc = torch.where(finite, x64, 0.0)
        xp = _pad_blocks(xc)
        e = _step_exponent(abs_eb, xp.ndim)
        step = 2.0**e

        kernel = self._kernel_ok(x)
        if kernel:
            with tel.span("device_transfer", bytes=xp.numel() * 8):
                c = tops.fwd_pipeline(xp.to(torch.float32)).to(torch.float64)
        else:
            with tel.span("predict", bytes=xp.numel() * 8):  # decorrelating stage
                c = _fwd_host(xp)
        with tel.span("quantize", bytes=c.numel() * 8):
            k = _quantize_coeffs(c, step)

        # verify against every decode route — POST output-dtype cast, since
        # decode rounds the float64 reconstruction onto the storage grid and
        # that rounding alone can push a value past the bound; stragglers
        # ride the fail channel
        crop = tuple(slice(0, s) for s in x.shape)
        kstep = k.to(torch.float64) * step
        recon = _inv_host(kstep)[crop]
        recon_cast = recon.to(data.dtype).to(torch.float64)
        fail = ~finite | ((recon_cast - x64).abs() > abs_eb)
        if kernel:
            recon_k = tops.inv_pipeline(kstep.to(torch.float32)).to(torch.float64)[crop]
            recon_k = recon_k.to(data.dtype).to(torch.float64)
            fail |= (recon_k - x64).abs() > abs_eb
            meta["device"] = 1
            # the float32-inverse verification above covers this package's
            # kernel and plain version (bit-identical); decode takes that
            # inverse only for blobs with this tag
            meta["device_backend"] = BACKEND_TAG
        meta["nfail"] = int(fail.sum())
        if meta["nfail"]:
            meta["fail_mask"] = _pack_mask(fail)
            meta["fail_vals"] = to_host(x64[fail]).tobytes()

        bands = to_host(_blockify(k))
        with tel.span("huffman", bytes=bands.nbytes):  # bitplane coding stage
            payload = _encode_bands(bands)
        with tel.span("lossless", bytes=len(payload)):
            body = self.lossless.compress(payload)
        header = self._header(
            shape, tuple(xp.shape), data.dtype, conf, abs_eb, e, bands.shape[0],
            bands.shape[1], meta,
        )
        # declared plaintext size: lets decode bound the lossless inflation
        header["payload_len"] = len(payload)
        blob = pack_container(header, body)
        return CompressionResult(
            blob=blob,
            ratio=nbytes / max(1, len(blob)),
            codes=bands if with_stats else None,
            meta=meta if with_stats else None,
        )

    def _header(self, shape, pshape, dtype, conf, abs_eb, step_exp, nbands, nblocks, meta) -> Dict[str, Any]:
        return {
            "v": _VERSION3,
            "kind": self.kind,
            "spec": self.spec(),
            "shape": list(shape),
            "pshape": list(pshape),
            "dtype": pl_mod._DTYPE_STR[dtype],
            "mode": conf.mode.value,
            "eb": float(conf.eb),
            "abs_eb": float(abs_eb),
            "step_exp": int(step_exp),
            "nbands": int(nbands),
            "nblocks": int(nblocks),
            "meta": dict(meta),
        }

    # -- decompress ----------------------------------------------------------
    @staticmethod
    def _decompress_body(
        blob: bytes, header: Dict[str, Any], body_off: int, device: torch.device
    ) -> torch.Tensor:
        spec = header["spec"]
        dtype = pl_mod._torch_dtype(header["dtype"], "dtype")
        shape = guard_shape(header["shape"], dtype.itemsize, "shape")
        pshape = guard_shape(header["pshape"], 8, "pshape")
        meta = header.get("meta") or {}
        nbands = guard_count(header["nbands"], 1 << 20, "nbands")
        nblocks = guard_count(header["nblocks"], 1 << 40, "nblocks")
        guard_alloc(nbands * nblocks * 8, "band grid")
        if nblocks == 0:
            return torch.zeros(shape, dtype=dtype, device=device)
        crop_shape = shape if shape else (1,)
        if len(crop_shape) != len(pshape) or any(s > p for s, p in zip(crop_shape, pshape)):
            raise ContainerError(
                f"corrupt transform container: shape {list(shape)} does not fit "
                f"the padded shape {list(pshape)}"
            )
        backend = ll_mod.make(spec["lossless"])
        raw = container_body(blob, body_off)
        payload_len = header.get("payload_len")
        if payload_len is not None:
            payload_len = guard_alloc(payload_len, "payload_len")
            payload = backend.decompress_bounded(raw, payload_len)
            if len(payload) != payload_len:
                raise ContainerError(
                    f"transform body decompressed to {len(payload)} bytes; "
                    f"header declares {payload_len}"
                )
        else:  # pre-integrity v3 blob: no declared plaintext size
            payload = backend.decompress(raw)
        bands = torch.from_numpy(_decode_bands(payload, nbands, nblocks)).to(device)
        kstep = _unblockify(bands, pshape).to(torch.float64) * 2.0 ** int(header["step_exp"])
        crop = tuple(slice(0, s) for s in crop_shape)
        if meta.get("device") and meta.get("device_backend") == BACKEND_TAG and len(pshape) in (1, 2):
            # compress verified this blob against the float32 inverse, whose
            # kernel and plain version are bit-identical
            out = tops.inv_pipeline(kstep.to(torch.float32)).to(torch.float64)[crop]
        else:
            out = _inv_host(kstep)[crop]
        if meta.get("nfail"):
            mask = torch.from_numpy(_unpack_mask(meta["fail_mask"], out.numel())).to(device)
            vals = np.frombuffer(meta["fail_vals"], np.float64)
            if int(mask.sum()) != vals.size:
                raise ContainerError(
                    f"corrupt transform container: fail channel holds {vals.size} "
                    f"values for {int(mask.sum())} masked points"
                )
            out = out.reshape(-1).clone()
            out[mask] = torch.from_numpy(vals.copy()).to(device)
        return out.to(dtype).reshape(shape)


# ---------------------------------------------------------------------------
# named pipeline
# ---------------------------------------------------------------------------

def sz3_transform(lossless: str = "zstd", route: str = "auto", **kw) -> TransformCompressor:
    """Pure transform coder (ZFP-family analogue); ``kw`` goes to
    :class:`TransformCompressor` (``conf``, ``device``)."""
    return TransformCompressor(lossless=lossless, route=route, **kw)


#: prediction AND transform entrants — the online SZ/ZFP selection criterion.
#: blockwise.py appends "sz3_hybrid" and fastmode.py "sz3_fast" at import
#: time, so consumers read this at CALL time (late binding), never capture it
#: in a default argument.
AUTO_CANDIDATES: Tuple[str, ...] = DEFAULT_CANDIDATES + ("sz3_transform",)


def sz3_auto(candidates=None, chunk_bytes: int = 1 << 22, workers: int = 1, **kw) -> ChunkedCompressor:
    """Chunked engine contesting prediction vs transform (vs block-hybrid vs
    fast) per chunk.  ``candidates=None`` resolves ``AUTO_CANDIDATES`` at
    call time so late-registered engines join the contest; ``kw`` goes to
    :class:`ChunkedCompressor` (``conf``, ``route``, ``device``, ...)."""
    return ChunkedCompressor(
        candidates=AUTO_CANDIDATES if candidates is None else candidates,
        chunk_bytes=chunk_bytes,
        workers=workers,
        **kw,
    )


# registration happens here (transform imports pipeline, not vice versa)
pl_mod.PIPELINES["sz3_transform"] = sz3_transform
pl_mod.PIPELINES["sz3_auto"] = sz3_auto
