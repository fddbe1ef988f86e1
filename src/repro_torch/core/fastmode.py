"""SZx-style ultra-fast fixed-length coder (v6 container, factory ``sz3_fast``).

The prediction pipelines buy ratio with an entropy stage (Huffman + lossless)
whose encode cost dominates end-to-end throughput.  SZx ("An Ultra-fast
Error-bounded Lossy Compressor") shows the other end of the speed-ratio
frontier: fixed-length coding with NO entropy pass at all.  This is that tier.

Format (all offsets derivable from the header — no in-band markers):

  * the flattened array is partitioned into fixed ``bs``-element blocks
    (256 default, 128 supported); the tail block is padded with its own edge
    value and cropped on decode.
  * each block stores its mean in the storage dtype.  A block is CONSTANT
    when every |x_i - mean| <= eb — 1 tag bit + the mean is its payload.
  * NONCONSTANT blocks quantize the mean-subtracted residuals on the 2*eb
    grid (``q = rint((x - mean) / (2 eb))``) and store them FIXED-LENGTH: the
    block's bit count ``w = bitlength(max|q|)`` rides a 1-byte side channel,
    and blocks sharing a width are pooled into one truncated-bitplane group
    (``w + 1`` planes of offset-binary ``q + 2^w``, packed 8 values/byte).
  * points the grid cannot represent in bound — non-finite values, residuals
    beyond the 2^30 code clip, cast-rounding stragglers — ride the exact fail
    channel (indices + raw storage-dtype values): the bound is unconditional.

Every block operation runs in torch on the data's device, in the storage
dtype, as separate IEEE operations (residual, scale, ``rint``, verify,
reconstruct), so CPU and CUDA give numpy's bits.  Scalars meet the tensors
as 0-dim tensors of the storage dtype, as numpy 2 casts a Python float that
meets a float32 array (NEP 50).  The decoder reconstructs with the same
dtype and operation order, so the encoder verifies every coded point against
the decoder's bit-identical reconstruction.  Bit packing stays on the host,
in numpy.

Block statistics (mean + max deviation) come from one of two routes:

  * host route — the float64 mean, summed in numpy's pairwise order so the
    blob equals the JAX package's host-route blob byte for byte;
  * kernel route — the classify+reduce kernel (``kernels/fastmode``) for
    float32 means and a max-deviation hint; constant blocks are re-verified
    against the stored mean, so the hint can cost ratio, never the bound.

``route="auto"`` takes the kernel route for CUDA tensors of at least 2^16
elements, ``"force"`` always (the plain version runs on CPU tensors),
``"off"`` never.

Error modes: every mode; PW_REL composes ``preprocess.LogTransform`` when
the preprocessor is ``Identity`` (side channels in ``pre_meta``), and the
float64 log field's blocks reach the kernel route cast to float32, as in the
JAX package.  Container: v6, kind "fast".
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import lossless as ll_mod
from . import pipeline as pl_mod
from . import preprocess as pre_mod
from . import telemetry as tel
from . import transform as tr_mod
from .config import CompressionConfig, ErrorBoundMode
from .integrity import ContainerError, guard_alloc, guard_count, guard_shape
from .pipeline import CompressionResult, container_body, pack_container
from .quantizers import pairwise_rowsum, to_device, to_host, true_div
from ..kernels.fastmode import ops as fops

_VERSION6 = 6

#: fixed block length (elements); 128 also supported
DEFAULT_BS = 256
VALID_BS = (128, 256)

#: residual codes are clipped to +-2^30 (clipped points go to the fail
#: channel) so offset-binary values stay well inside uint32
_Q_CLIP = 1 << 30

#: below this many elements the kernel route costs more than it saves
_KERNEL_MIN_SIZE = 1 << 16

_ROUTES = ("auto", "force", "off")

# ---------------------------------------------------------------------------
# fixed-width planar bit packing (the truncated-bitplane storage, host)
# ---------------------------------------------------------------------------

def _pack_planes(u: np.ndarray, nplanes: int) -> bytes:
    """Pack unsigned values (< 2^nplanes) as ``nplanes`` planar bitplanes:
    one plane of all values, then the next, each byte-aligned."""
    u = np.ascontiguousarray(u, np.uint32)
    uv = u.view(np.uint8)
    parts = []
    tmp = np.empty(u.size, np.uint8)
    for base in range(0, nplanes, 8):
        lane = base // 8 if np.little_endian else 3 - base // 8
        ub = np.ascontiguousarray(uv[lane::4])
        for p in range(base, min(nplanes, base + 8)):
            np.bitwise_and(ub, np.uint8(1 << (p - base)), out=tmp)
            parts.append(np.packbits(tmp))
    return b"".join(part.tobytes() for part in parts)


def _unpack_planes(buf: bytes, offset: int, n: int, nplanes: int) -> Tuple[np.ndarray, int]:
    """Inverse of :func:`_pack_planes`; returns (values, bytes consumed)."""
    nbytes_plane = (n + 7) // 8
    u = np.zeros(n, np.uint32)
    pos = offset
    for p in range(nplanes):
        plane = np.unpackbits(
            np.frombuffer(buf, np.uint8, count=nbytes_plane, offset=pos),
            count=n,
        )
        u |= plane.astype(np.uint32) << np.uint32(p)
        pos += nbytes_plane
    return u, pos - offset


def _required_bits(maxmag: torch.Tensor) -> torch.Tensor:
    """Per-block magnitude bit count: bitlength(max|q|), 0 for all-zero.
    The exponent of ``frexp`` is the bit length, exactly, for every
    magnitude a float64 holds exactly."""
    m = maxmag.to(torch.int64)
    _, e = torch.frexp(m.to(torch.float64))
    return torch.where(m > 0, e, 0).to(torch.uint8)


def _pad_blocks_1d(x: torch.Tensor, bs: int) -> Tuple[torch.Tensor, int]:
    """(nb, bs) view of the flat tensor, tail padded with its edge value
    (the pad rides the tail block's own statistics and is cropped on
    decode)."""
    n = x.numel()
    nb = (n + bs - 1) // bs
    pad = nb * bs - n
    if pad:
        edge = float(x[-1])
        edge = edge if np.isfinite(edge) else 0.0
        x = torch.cat([x, x.new_full((pad,), edge)])
    return x.reshape(nb, bs), nb


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype, as a 0-dim tensor beside it."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


class FastModeCompressor:
    """SZx-style fixed-length block coder (module docstring above)."""

    kind = "fast"

    def __init__(
        self,
        bs: int = DEFAULT_BS,
        preprocessor: Optional[pre_mod.Preprocessor] = None,
        lossless: Optional[ll_mod.LosslessBackend] = None,
        conf: Optional[CompressionConfig] = None,
        route: str = "auto",
        device: pl_mod.Device = "cuda",
    ):
        if int(bs) not in VALID_BS:
            raise ValueError(f"fast-mode block size must be one of {VALID_BS}")
        if route not in _ROUTES:
            raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
        self.bs = int(bs)
        self.preprocessor = preprocessor or pre_mod.Identity()
        # Passthrough by default: a lossless pass would reintroduce the very
        # latency this tier exists to shed
        self.lossless = lossless or ll_mod.Passthrough()
        self.conf = conf or CompressionConfig()
        self.route = route
        self.device = device

    # -- spec (self-describing container) ------------------------------------
    def spec(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "bs": self.bs,
            "preprocessor": self.preprocessor.name,
            "lossless": self.lossless.name,
        }

    # -- selection-contest hook ----------------------------------------------
    def estimate_error(self, sample, abs_eb: float, conf: CompressionConfig) -> float:
        """Estimated coded bits/element on ``sample``: constant blocks pay the
        mean + tag, nonconstant blocks ``w + 1`` bits/element plus the mean
        and width side channels."""
        dev = pl_mod.resolve_device(self.device)
        if isinstance(sample, torch.Tensor):
            itemsize = sample.element_size() if sample.dtype in (torch.float32, torch.float64) else 4
            x64 = sample.detach().to(dev, torch.float64).reshape(-1)
        else:
            sample = np.asarray(sample)
            itemsize = np.dtype(
                sample.dtype if sample.dtype in (np.float32, np.float64) else np.float32
            ).itemsize
            x64 = torch.from_numpy(np.asarray(sample, np.float64).reshape(-1)).to(dev)
        if x64.numel() == 0:
            return 0.0
        bs = self.bs
        eb = max(float(abs_eb), float(np.finfo(np.float64).tiny))
        xb, _n = _pad_blocks_1d(x64, bs)
        means = true_div(pairwise_rowsum(xb), float(bs))
        means = torch.where(torch.isfinite(means), means, 0.0)
        resid = xb - means[:, None]
        const = resid.abs().amax(dim=1) <= eb
        q = true_div(torch.where(torch.isfinite(resid), resid, 0.0), 2.0 * eb)
        mq = torch.round(torch.clamp(q, -_Q_CLIP, _Q_CLIP)).abs().amax(dim=1)
        w = _required_bits(mq[~const])
        bits = (
            xb.shape[0] * (1.0 + 8.0 * itemsize)
            + float((w.to(torch.float64) + 1.0).sum()) * bs
            + w.numel() * 8.0
        )
        return bits / x64.numel()

    # -- kernel routing -------------------------------------------------------
    def _kernel_stats(self, xb: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """(float32 means, float64 max-deviation hint) from the classify+reduce
        kernel, or None when the host route should run."""
        if self.route == "off":
            return None
        if self.route == "auto" and (xb.device.type != "cuda" or xb.numel() < _KERNEL_MIN_SIZE):
            return None
        with tel.span("device_transfer", bytes=xb.numel() * xb.element_size()):
            means32, dev32 = fops.block_stats(xb.to(torch.float32))
        return means32, dev32.to(torch.float64)

    # -- compression ----------------------------------------------------------
    def compress(self, data, conf: Optional[CompressionConfig] = None, with_stats: bool = False) -> CompressionResult:
        """Compress a numpy array or torch tensor on this compressor's device."""
        conf = conf or self.conf
        data = pl_mod._as_tensor(data, pl_mod.resolve_device(self.device))
        pre = self.preprocessor
        if conf.mode == ErrorBoundMode.PW_REL and isinstance(pre, pre_mod.Identity):
            # PW_REL-native: compose the log-domain conversion so the
            # pointwise bound holds by construction
            pre = pre_mod.LogTransform()
        pdata, conf2, pre_meta = pre.forward(data, conf)
        rng, absmax = pl_mod._finite_stats(pdata)
        abs_eb = conf2.resolve_abs_eb(rng, absmax)
        if abs_eb <= 0:
            abs_eb = float(np.finfo(np.float64).tiny)
        with tel.span("quantize", bytes=pdata.numel() * pdata.element_size()):
            body_parts, fmeta = self._encode_blocks(pdata, abs_eb)
        spec = self.spec()
        spec["preprocessor"] = pre.name  # the EFFECTIVE preprocessor
        header = {
            "v": _VERSION6,
            "kind": "fast",
            "spec": spec,
            "shape": list(data.shape),
            "pshape": list(pdata.shape),
            "dtype": pl_mod._DTYPE_STR[data.dtype],
            "pdtype": pl_mod._DTYPE_STR[pdata.dtype],
            "mode": conf.mode.value,
            "eb": float(conf.eb),
            "abs_eb": float(abs_eb),
            **(
                {"eb_rel": float(conf.eb_rel)}
                if conf.eb_rel is not None
                else {}
            ),
            "pre_meta": dict(pre_meta),
            "fast_meta": fmeta,
        }
        with tel.span("lossless", bytes=sum(len(p) for p in body_parts)):
            body = self.lossless.compress(b"".join(body_parts))
        blob = pack_container(header, body)
        if tel.enabled():
            nb, n_const = int(fmeta["nb"]), int(fmeta["n_const"])
            tel.record_decision(tel.make_decision(
                "sz3_fast",
                "constant" if n_const * 2 > nb else "fixed_length",
                scope="block-summary",
                candidates=["constant", "fixed_length"],
                estimates={"constant": float(n_const),
                           "fixed_length": float(nb - n_const)},
                realized_bits=8.0 * len(blob) / max(1, data.numel()),
                n_elems=int(data.numel()),
                fallbacks=int(fmeta["nfail"]),
                device="device" if fmeta.get("device") else "host",
            ))
        meta = None
        if with_stats:
            meta = {k: v for k, v in fmeta.items() if not isinstance(v, bytes)}
        return CompressionResult(
            blob=blob, ratio=data.numel() * data.element_size() / max(1, len(blob)), meta=meta
        )

    def _encode_blocks(self, pdata: torch.Tensor, abs_eb: float) -> Tuple[List[bytes], Dict[str, Any]]:
        bs = self.bs
        pdtype = pdata.dtype  # ALL block arithmetic runs in the storage dtype
        flat = pdata.reshape(-1)
        n = int(flat.numel())
        if n == 0:
            return [b""], {
                "n": 0, "nb": 0, "n_const": 0, "nfail": 0,
                "const_len": 0, "means_len": 0, "w_len": 0, "planes_len": 0,
            }
        xb, nb = _pad_blocks_1d(flat, bs)
        # the verify threshold keeps a relative margin inside eb: storage-dtype
        # rounding in the residual/verify passes can under-report a true
        # error by a few ulps — points inside the margin fail to exact storage
        eb_strict = float(abs_eb) * (1.0 - 1e-6)
        eb_strict_st = _scalar(eb_strict, xb)
        stats = self._kernel_stats(xb)
        if stats is not None:
            means_st = stats[0].to(pdtype)
            dev_hint = stats[1]
        else:
            # float64 accumulator, numpy's summation order
            means_st = true_div(pairwise_rowsum(xb.to(torch.float64)), float(bs)).to(pdtype)
            dev_hint = None
        # blocks whose mean is non-finite (an inf/nan inside) restart from a
        # masked mean so the REST of the block still codes cheaply; the
        # non-finite points themselves go to the fail channel
        bad = ~torch.isfinite(means_st)
        if bool(bad.any()):
            xbad = xb[bad].to(torch.float64)
            fin = torch.isfinite(xbad)
            cnt = torch.clamp(fin.sum(dim=1), min=1).to(torch.float64)
            means_st = means_st.clone()
            means_st[bad] = (pairwise_rowsum(torch.where(fin, xbad, 0.0)) / cnt).to(pdtype)
            dev_hint = None  # hint no longer matches the stored means
        resid = xb - means_st[:, None]  # storage dtype, the only big temp
        if dev_hint is not None:
            # the kernel's hint classifies; constant blocks are then
            # re-VERIFIED against the stored mean
            const = dev_hint <= eb_strict
            if bool(const.any()):
                exact = resid[const].abs().amax(dim=1) <= eb_strict_st
                idx = torch.nonzero(const).reshape(-1)
                const[idx[~exact]] = False
            gmin = gmax = None  # the hint is approximate; probe exactly below
        else:
            # nan devs compare False -> nonconstant
            rmax = resid.amax(dim=1)
            rmin = resid.amin(dim=1)
            const = torch.maximum(rmax, -rmin) <= eb_strict_st
            gmin, gmax = float(rmin.min()), float(rmax.max())  # nan-propagating
        nonconst = ~const
        n_nc = int(nonconst.sum())
        fail_idx = torch.zeros(0, dtype=torch.int64, device=xb.device)
        q = torch.zeros((0, bs), dtype=torch.int32, device=xb.device)
        w = torch.zeros(0, dtype=torch.uint8, device=xb.device)
        if n_nc:
            twoeb = _scalar(2.0 * float(abs_eb), xb)
            inv = _scalar(1.0 / (2.0 * float(abs_eb)), xb)
            resid = resid * inv
            if gmin is None:
                lo, hi = float(resid.min()), float(resid.max())
            else:
                # the block reductions already scanned resid — scale them
                # instead of two more full passes (a probe only)
                lo, hi = gmin * float(inv), gmax * float(inv)
            if not (lo >= -float(_Q_CLIP) and hi <= float(_Q_CLIP)):
                # non-finite or beyond the code clip: the affected points
                # land in the fail channel via the verify
                resid = torch.nan_to_num(resid, nan=0.0, posinf=0.0, neginf=0.0)
                resid = torch.clamp(resid, -float(_Q_CLIP), float(_Q_CLIP))
            resid = torch.round(resid)
            all_nc = n_nc == nb
            q = (resid if all_nc else resid[nonconst]).to(torch.int32)
            x_nc = xb if all_nc else xb[nonconst]
            means_nc = means_st if all_nc else means_st[nonconst]
            # verify against the decoder's exact reconstruction — same dtype,
            # same operation order; whatever lands out of bound is stored raw
            recon = means_nc[:, None] + q.to(pdtype) * twoeb
            fail_mask = ~((x_nc - recon).abs() <= eb_strict_st)
            if bool(fail_mask.any()):
                # fail positions in the ORIGINAL flat index space (row-major
                # nonzero keeps them sorted; padding cropped)
                block_idx = torch.nonzero(nonconst).reshape(-1)
                rows, cols = torch.nonzero(fail_mask, as_tuple=True)
                ff = block_idx[rows] * bs + cols
                fail_idx = ff[ff < n]
            w = _required_bits(torch.maximum(q.amax(dim=1), -q.amin(dim=1)))
        const_h, w_h, q_h = to_host(const), to_host(w), to_host(q)
        const_bytes = np.packbits(const_h).tobytes()
        means_bytes = to_host(means_st).tobytes()
        w_bytes = w_h.tobytes()
        plane_parts: List[bytes] = []
        for width in np.unique(w_h):
            width = int(width)
            if width == 0:
                continue  # all-zero residuals: the mean is the payload
            vals = q_h[w_h == width].reshape(-1)
            # offset-binary q + 2^w via two's-complement wraparound (the true
            # value is in [0, 2^31], so the low 32 bits ARE the value)
            plane_parts.append(
                _pack_planes(vals.view(np.uint32) + np.uint32(1 << width), width + 1)
            )
        planes_bytes = b"".join(plane_parts)
        fmeta: Dict[str, Any] = {
            "n": n,
            "nb": int(nb),
            "n_const": int(const_h.sum()),
            "nfail": int(fail_idx.numel()),
            "const_len": len(const_bytes),
            "means_len": len(means_bytes),
            "w_len": len(w_bytes),
            "planes_len": len(planes_bytes),
            "device": 1 if stats is not None else 0,  # routing taken
        }
        if fail_idx.numel():
            fmeta["fail_idx"] = to_host(fail_idx).tobytes()
            fmeta["fail_vals"] = to_host(flat[fail_idx]).tobytes()
        return [const_bytes, means_bytes, w_bytes, planes_bytes], fmeta

    # -- decompression (pipeline.decompress dispatch target) ------------------
    @staticmethod
    def _decompress_body(
        blob: bytes, header: Dict[str, Any], body_off: int, device: torch.device
    ) -> torch.Tensor:
        spec = header["spec"]
        pdtype = pl_mod._torch_dtype(header["pdtype"], "pdtype")
        np_pdtype = np.dtype(header["pdtype"])
        bs = guard_count(spec["bs"], 1 << 20, "fast block size")
        if bs < 1:
            raise ContainerError("corrupt fast container: block size < 1")
        fm = header["fast_meta"]
        # header claims are internally over-determined — recompute the
        # derivable ones and reject any inconsistency before allocating
        n = int(fm["n"])
        if n < 0:
            raise ContainerError("corrupt fast container: negative n")
        guard_alloc(n * np_pdtype.itemsize, "fast element count")
        nb = int(fm["nb"])
        if nb != (n + bs - 1) // bs:
            raise ContainerError(
                f"corrupt fast container: nb={nb} inconsistent with "
                f"n={n}, bs={bs}"
            )
        conf = CompressionConfig(
            mode=ErrorBoundMode(header["mode"]),
            eb=header["eb"],
            eb_rel=header.get("eb_rel"),
        )
        if n == 0:
            flat = torch.zeros(0, dtype=pdtype, device=device)
        else:
            const_len, means_len = int(fm["const_len"]), int(fm["means_len"])
            w_len = int(fm["w_len"])
            n_const = guard_count(fm["n_const"], nb, "n_const")
            n_nc = nb - n_const
            if const_len != (nb + 7) // 8 or means_len != nb * np_pdtype.itemsize:
                raise ContainerError(
                    "corrupt fast container: const/means channel lengths "
                    "inconsistent with block count"
                )
            if w_len != n_nc:
                raise ContainerError(
                    "corrupt fast container: width channel length "
                    f"{w_len} != nonconstant block count {n_nc}"
                )
            planes_len = guard_alloc(fm["planes_len"], "planes_len")
            total = const_len + means_len + w_len + planes_len
            with tel.span("inflate", bytes=total):
                body = ll_mod.make(spec["lossless"]).decompress_bounded(
                    container_body(blob, body_off), guard_alloc(total, "fast body")
                )
            if len(body) != total:
                raise ContainerError(
                    f"fast body decompressed to {len(body)} bytes; header "
                    f"declares {total}"
                )
            out_bytes = n * np_pdtype.itemsize
            with tel.span("unpack", bytes=out_bytes):
                pos = 0
                const = np.unpackbits(
                    np.frombuffer(body, np.uint8, count=const_len), count=nb
                ).astype(bool)
                pos += const_len
                if int(const.sum()) != n_const:
                    raise ContainerError(
                        f"corrupt fast container: the constant bitmap marks "
                        f"{int(const.sum())} blocks, the header {n_const}"
                    )
                means = np.frombuffer(body, np_pdtype, count=nb, offset=pos)
                pos += means_len
                w = np.frombuffer(body, np.uint8, count=w_len, offset=pos)
                pos += w_len
                guard_alloc(n_nc * bs * 8, "fast residual grid")
                q = np.zeros((n_nc, bs), np.int64)
                for width in np.unique(w):
                    width = int(width)
                    sel = w == width
                    if width == 0:
                        continue
                    cnt = int(sel.sum())
                    u, used = _unpack_planes(body, pos, cnt * bs, width + 1)
                    pos += used
                    q[sel] = u.astype(np.int64).reshape(cnt, bs) - (1 << width)
            abs_eb = float(header["abs_eb"])
            # reconstruction runs in the STORAGE dtype with the same operation
            # order the encoder verified against
            with tel.span("rebuild", bytes=out_bytes):
                means_t = to_device(means.copy(), device)
                out = means_t[:, None].expand(nb, bs).clone()
                if n_nc:
                    qe = to_device(q, device).to(pdtype) * _scalar(2.0 * abs_eb, means_t)
                    nc = to_device(~const, device)
                    out[nc] = out[nc] + qe
                flat = out.reshape(-1)[:n]
                if fm.get("nfail"):
                    idx = np.frombuffer(fm["fail_idx"], np.int64)
                    # a negative corrupt index would silently wrap, an
                    # out-of-range one raise an untyped error: check both
                    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
                        raise ContainerError(
                            "corrupt fast container: fail-channel index outside "
                            f"[0, {n})"
                        )
                    vals = np.frombuffer(fm["fail_vals"], np_pdtype)
                    if vals.size != idx.size:
                        raise ContainerError(
                            "corrupt fast container: fail-channel index/value "
                            "counts differ"
                        )
                    flat[to_device(idx.copy(), device)] = to_device(vals.copy(), device)
        dtype = pl_mod._torch_dtype(header["dtype"], "dtype")
        shape = guard_shape(header["shape"], dtype.itemsize, "shape")
        pshape = guard_shape(header["pshape"], np_pdtype.itemsize, "pshape")
        if int(np.prod(pshape, dtype=np.int64)) != n or int(np.prod(shape, dtype=np.int64)) != n:
            raise ContainerError(
                f"corrupt fast container: shape {list(shape)} / pshape "
                f"{list(pshape)} do not hold n={n} elements"
            )
        pdata = flat.reshape(pshape)
        data = pre_mod.make(spec["preprocessor"]).inverse(pdata, conf, header["pre_meta"])
        return data.to(dtype).reshape(shape)


def sz3_fast(bs: int = DEFAULT_BS, lossless: str = "none", route: str = "auto", **kw) -> FastModeCompressor:
    """Named factory: the SZx-style ultra-fast fixed-length tier (v6);
    ``kw`` goes to :class:`FastModeCompressor` (``conf``, ``device``,
    ``preprocessor``)."""
    return FastModeCompressor(bs=bs, lossless=ll_mod.make(lossless), route=route, **kw)


# registration (fastmode imports pipeline/transform, never vice versa); the
# fast tier also joins the auto contest — sz3_auto / sz3_quality read
# AUTO_CANDIDATES at call time, so they pick this up
pl_mod.PIPELINES["sz3_fast"] = sz3_fast
if "sz3_fast" not in tr_mod.AUTO_CANDIDATES:
    tr_mod.AUTO_CANDIDATES = tr_mod.AUTO_CANDIDATES + ("sz3_fast",)
