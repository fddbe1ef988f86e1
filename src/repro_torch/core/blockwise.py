"""Block-level multi-predictor hybrid engine (paper §3.2, v5 container).

The chunked engine (chunking.py) contests whole pipelines per CHUNK; this
engine contests predictors per BLOCK (SZ3 §3.2, SZ2's block-granular
Lorenzo/regression contest).  :class:`BlockHybridCompressor` (factory
``sz3_hybrid``) tiles the array into fixed-size blocks (256 for 1-D, 16x16
for 2-D, 8x8x8 for 3-D, 4^d above), scores FOUR candidates per block with
the code-bits criterion and keeps the per-block winner:

  tag 0  zero        — predict 0 on the prequantized grid
  tag 1  lorenzo1    — block-local order-1 dual-quant Lorenzo
  tag 2  lorenzo2    — order-2 Lorenzo
  tag 3  regression  — SZ2 hyperplane fit, quantized coefficients

Every block's quantization indices feed ONE shared stream (a single Huffman
table and a single lossless pass), while a 2-bit/block tag array and the
delta-coded regression-coefficient streams of regression-winning blocks ride
as side channels inside the same lossless body.  The container is the JAX
package's v5 container, byte for byte.

Devices: ``compress`` and the decoder run the array stages — prequantize,
the block filters, the plane fit, the residuals, the gamma costs, the
per-block winner, the per-block cumulative sums and ``recover`` — in torch
on the caller's device; byte coding stays on the host.  Every float64 value
that decides a tag is computed as numpy computes it: block sums in numpy's
pairwise order (``block_sums``), IEEE divides (``true_div``), and the gamma
length ``2*log2(1+|q|)+1`` read from a table numpy fills once (the card's
``log2`` rounds differently), numpy itself above the table.
``estimate_error`` runs the same code on a CPU copy of the sample, so
``sz3_auto``'s picks are the reference's on any device.

Error modes: ABS natively; REL resolves against global finite stats; PW_REL
composes :class:`preprocess.LogTransform` automatically.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import encoders as enc_mod
from . import lossless as ll_mod
from . import pipeline as pl_mod
from . import preprocess as pre_mod
from . import quantizers as quant_mod
from . import telemetry as tel
from . import transform as tr_mod
from .config import CompressionConfig, ErrorBoundMode
from .integrity import ContainerError, guard_alloc, guard_count, guard_shape
from .pipeline import CompressionResult, container_body, pack_container
from .predictors import (
    _host64,
    _int_code_bits,
    _pack_mask,
    _plane,
    _unpack_mask,
    block_coords,
    block_lorenzo_filter,
    block_lorenzo_inverse,
    block_plane_fit,
    block_sums,
    blockify,
    pad_to_blocks,
    unblockify,
)
from .quantizers import to_host, true_div

_VERSION5 = 5

#: block side length by dimensionality: ~256-4096 elements per block
BLOCK_SIDES = {1: 256, 2: 16, 3: 8}

#: side length for ndim >= 4
DEFAULT_SIDE = 4

#: tag values — also the tie-break priority (the lowest tag wins a tie)
TAG_ZERO, TAG_LOR1, TAG_LOR2, TAG_REG = 0, 1, 2, 3
TAG_NAMES = ("zero", "lorenzo1", "lorenzo2", "regression")

#: |q| below this reads its gamma length from a table numpy fills on the host
GAMMA_TABLE_SIZE = 1 << 20


def block_side_for(ndim: int, override: Optional[int] = None) -> int:
    if override:
        return max(2, int(override))
    return BLOCK_SIDES.get(int(ndim), DEFAULT_SIDE)


@functools.lru_cache(maxsize=None)
def _gamma_table(device: torch.device) -> torch.Tensor:
    """``2*log2(1+k)+1`` for k < ``GAMMA_TABLE_SIZE``, by numpy, on ``device``
    (8 MiB, built once per device)."""
    k = np.arange(GAMMA_TABLE_SIZE, dtype=np.float64)
    return torch.from_numpy(2.0 * np.log2(1.0 + k) + 1.0).to(device)


def _gamma_bits(q: torch.Tensor) -> torch.Tensor:
    """Per-code length proxy: Elias-gamma-style ``2*log2(1+|q|) + 1`` in
    float64, rounded as numpy rounds it: integer |q| under
    ``GAMMA_TABLE_SIZE`` from the table, the rest by numpy on a host copy."""
    a = q.to(torch.float64).abs()
    small = (a < GAMMA_TABLE_SIZE) & (a == a.floor())
    out = _gamma_table(a.device)[torch.where(small, a, 0.0).to(torch.int64)]
    if not bool(small.all()):
        big = ~small
        out[big] = torch.from_numpy(2.0 * np.log2(1.0 + to_host(a[big])) + 1.0).to(out.device)
    return out


def _pack_tags(tags: np.ndarray) -> bytes:
    """2 bits per block, 4 blocks per byte (little-endian within the byte)."""
    n = tags.size
    padded = np.zeros(((n + 3) // 4) * 4, np.uint8)
    padded[:n] = tags
    packed = padded[0::4] | (padded[1::4] << 2) | (padded[2::4] << 4) | (padded[3::4] << 6)
    return packed.tobytes()


def _unpack_tags(buf: bytes, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, np.uint8)
    out = np.empty(raw.size * 4, np.uint8)
    out[0::4] = raw & 3
    out[1::4] = (raw >> 2) & 3
    out[2::4] = (raw >> 4) & 3
    out[3::4] = (raw >> 6) & 3
    return out[:n]


def _select_tags(
    qfull: torch.Tensor,
    d1: torch.Tensor,
    d2: torch.Tensor,
    qres: torch.Tensor,
    coef_q: List[torch.Tensor],
    reg_bad: torch.Tensor,
) -> torch.Tensor:
    """Per-block winner (uint8 tags) by estimated coded bits (paper:
    estimate_error): gamma-length bits of each candidate's integer codes;
    regression also pays the cheaper of delta and fresh coding of its
    coefficients.  Blocks whose fit is not finite never win regression.  A
    tie keeps the lowest tag, as ``np.argmin`` does."""
    nb = qfull.shape[0]
    if nb == 0:
        return torch.zeros(0, dtype=torch.uint8, device=qfull.device)
    costs = [block_sums(_gamma_bits(c)) for c in (qfull, d1, d2)]
    reg_cost = block_sums(_gamma_bits(qres))
    for qc in coef_q:
        delta = torch.diff(qc, prepend=qc.new_zeros(1))
        reg_cost = reg_cost + torch.minimum(_gamma_bits(delta), _gamma_bits(qc))
    costs.append(torch.where(reg_bad, float("inf"), reg_cost))
    # costs are finite sums (or +inf): strict less keeps the first minimum
    best, tags = costs[0], torch.zeros(nb, dtype=torch.uint8, device=qfull.device)
    for t in (TAG_LOR1, TAG_LOR2, TAG_REG):
        better = costs[t] < best
        tags = torch.where(better, t, tags).to(torch.uint8)
        best = torch.where(better, costs[t], best)
    return tags


def _candidate_codes(blocks: torch.Tensor, qfull: torch.Tensor, eb: float):
    """All candidate code estimates for a pre-blockified float64 array:
    (d1, d2, qres, coef_q, pred_reg, reg_bad) — the order-1/order-2 Lorenzo
    differences of the prequantized grid, the regression residual bin
    indices, the quantized coefficient streams, the regression prediction
    and the bad-fit block mask."""
    b = blocks.shape[1] if blocks.ndim > 1 else 1
    d1 = block_lorenzo_filter(qfull, 1)
    d2 = block_lorenzo_filter(d1, 1)  # second application == order 2
    coef_q, pred_reg, reg_bad = block_plane_fit(blocks, b, eb)
    qres = torch.round(true_div(blocks - pred_reg, 2.0 * eb))
    qres = torch.where(torch.isfinite(qres), qres, 0.0)
    return d1, d2, qres, coef_q, pred_reg, reg_bad


class BlockHybridCompressor:
    """Block-level multi-predictor hybrid engine (module docstring above).

    Follows the :class:`pipeline.SZ3Compressor` module protocol
    (preprocessor slot, quantizer/encoder/lossless stages,
    ``compress``/``spec``, ``device``), so the chunked engines contest it per
    chunk and compose ``LogTransform`` into it for PW_REL, and
    ``pipeline.decompress`` rebuilds it from the v5 header.
    """

    kind = "hybrid"

    def __init__(
        self,
        preprocessor: Optional[pre_mod.Preprocessor] = None,
        quantizer: Optional[quant_mod.QuantizerBase] = None,
        encoder: Optional[enc_mod.Encoder] = None,
        lossless: Optional[ll_mod.LosslessBackend] = None,
        conf: Optional[CompressionConfig] = None,
        block_side: Optional[int] = None,
        device: pl_mod.Device = "cuda",
    ):
        self.preprocessor = preprocessor or pre_mod.Identity()
        self.quantizer = quantizer or quant_mod.LinearScaleQuantizer()
        self.encoder = encoder or enc_mod.HuffmanEncoder()
        self.lossless = lossless or ll_mod.Zstd()
        self.conf = conf or CompressionConfig()
        self.block_side = block_side
        self.device = device

    # -- spec (self-describing container) ------------------------------------
    def spec(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "preprocessor": self.preprocessor.name,
            "quantizer": self.quantizer.name,
            "quant_radius": self.quantizer.radius,
            "encoder": self.encoder.name,
            "lossless": self.lossless.name,
        }

    # -- selection-contest hook (chunking.select_pipeline) -------------------
    def estimate_error(self, sample, abs_eb: float, conf: CompressionConfig) -> float:
        """Estimated coded bits/element on ``sample`` (tensor or array, scored
        on a CPU copy): the real per-block contest on the sample's estimated
        codes, the winners (plus coefficient and tag side channels) priced
        with the shared ``code_bits`` entropy model and normalized by the
        UNPADDED element count."""
        x = torch.from_numpy(_host64(sample))
        if x.numel() == 0:
            return 0.0
        if x.ndim == 0:
            x = x.reshape(1)
        b = block_side_for(x.ndim, self.block_side)
        xp, _ = pad_to_blocks(x, b)
        blocks = blockify(xp, b)
        nb = blocks.shape[0]
        scaled = true_div(blocks, 2.0 * abs_eb)
        qfull = torch.where(torch.isfinite(scaled), scaled, 0.0)
        qfull = torch.round(torch.clamp(qfull, -(2.0**62), 2.0**62))
        d1, d2, qres, coef_q, _pred, reg_bad = _candidate_codes(blocks, qfull, abs_eb)
        tags = _select_tags(qfull, d1, d2, qres, coef_q, reg_bad)
        cand = torch.stack([c.reshape(nb, -1) for c in (qfull, d1, d2, qres)])
        win = cand.gather(0, tags.to(torch.int64).reshape(1, nb, 1).expand(1, nb, cand.shape[2]))[0]
        pooled = [win.reshape(-1)]
        use_reg = tags == TAG_REG
        for qc in coef_q:
            kept = qc[use_reg]
            pooled.append(torch.diff(kept, prepend=kept.new_zeros(1)).to(torch.float64))
        allq = torch.cat(pooled)
        bits_per_code = _int_code_bits(allq, conf.quant_radius)
        return (bits_per_code * allq.numel() + 2.0 * nb) / x.numel()

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
        self.quantizer.begin(abs_eb, pdata.dtype)
        with tel.span("predict", bytes=pdata.numel() * pdata.element_size()):  # per-block contest
            codes_t, tag_bytes, hmeta = self._compress_blocks(pdata)
        codes = to_host(codes_t).astype(self.quantizer.code_dtype)
        with tel.span("huffman", bytes=codes.nbytes):
            enc_bytes = self.encoder.encode(codes)
        q_bytes = self.quantizer.save()
        spec = self.spec()
        spec["preprocessor"] = pre.name  # the EFFECTIVE preprocessor
        header = {
            "v": _VERSION5,
            "kind": "hybrid",
            "spec": spec,
            "shape": list(data.shape),
            "pshape": list(pdata.shape),
            "dtype": pl_mod._DTYPE_STR[data.dtype],
            "pdtype": pl_mod._DTYPE_STR[pdata.dtype],
            "mode": conf.mode.value,
            "eb": float(conf.eb),
            "abs_eb": float(abs_eb),
            "n_codes": int(codes.size),
            **({"eb_rel": float(conf.eb_rel)} if conf.eb_rel is not None else {}),
            "enc_len": len(enc_bytes),
            "q_len": len(q_bytes),
            "tag_len": len(tag_bytes),
            "pre_meta": pl_mod._clean_meta(pre_meta),
            "hyb_meta": pl_mod._clean_meta(hmeta),
        }
        with tel.span("lossless", bytes=len(enc_bytes) + len(q_bytes) + len(tag_bytes)):
            body = self.lossless.compress(enc_bytes + q_bytes + tag_bytes)
        blob = pack_container(header, body)
        n_bytes = data.numel() * data.element_size()
        if tel.enabled():
            counts = {TAG_NAMES[t]: int(hmeta["counts"][t]) for t in range(4)}
            tel.record_decision(tel.make_decision(
                "sz3_hybrid",
                max(counts, key=counts.get),
                scope="block-summary",
                candidates=list(TAG_NAMES),
                estimates={k: float(v) for k, v in counts.items()},
                realized_bits=8.0 * len(blob) / max(1, data.numel()),
                n_elems=int(data.numel()),
                fallbacks=int(hmeta["nfail"]),
                extra={"counts": counts, "n_reg": int(hmeta["n_reg"]), "nb": int(hmeta["nb"])},
            ))
        meta = None
        if with_stats:
            meta = dict(hmeta)
            meta.pop("fail_mask", None)
            meta.pop("fail_vals", None)
            meta["tag_shares"] = {
                TAG_NAMES[t]: hmeta["counts"][t] / max(1, hmeta["nb"]) for t in range(4)
            }
        return CompressionResult(
            blob=blob,
            ratio=n_bytes / max(1, len(blob)),
            codes=codes if with_stats else None,
            meta=meta,
        )

    def _compress_blocks(self, pdata: torch.Tensor) -> Tuple[torch.Tensor, bytes, Dict[str, Any]]:
        """Tile, contest, and emit the shared code stream + side channels."""
        quantizer = self.quantizer
        x64 = pdata.to(torch.float64)
        if x64.ndim == 0:
            x64 = x64.reshape(1)
        nd = x64.ndim
        b = block_side_for(nd, self.block_side)
        xp, work_shape = pad_to_blocks(x64, b)
        blocks = blockify(xp, b)  # (nb,) + (b,)*nd
        nb = blocks.shape[0]
        eb = quantizer.eb
        # prequantize once for all integer-grid candidates; fail marks points
        # the grid cannot represent in bound (non-finite, cast rounding)
        with tel.span("quantize", bytes=blocks.numel() * blocks.element_size()):
            qfull, _recon, fail = quantizer.prequantize(blocks)
        d1, d2, qres, coef_q, pred_reg, reg_bad = _candidate_codes(blocks, qfull, eb)
        tags = _select_tags(qfull, d1, d2, qres, coef_q, reg_bad)
        use_reg = tags == TAG_REG
        # shared code stream, in decode order: the delta-coded coefficient
        # streams of regression-winning blocks, then the integer-grid data
        # codes grouped by tag (block order within each group), then the
        # float-domain regression residual codes
        parts: List[torch.Tensor] = []
        for qc in coef_q:
            kept = qc[use_reg]
            parts.append(quantizer.quantize_int_diff(torch.diff(kept, prepend=kept.new_zeros(1))))
        for tag, d in ((TAG_ZERO, qfull), (TAG_LOR1, d1), (TAG_LOR2, d2)):
            parts.append(quantizer.quantize_int_diff(d[tags == tag].reshape(-1)))
        dcodes, _ = quantizer.quantize(blocks[use_reg].reshape(-1), pred_reg[use_reg].reshape(-1))
        codes = torch.cat(parts + [dcodes])
        counts = [int(c) for c in torch.bincount(tags.to(torch.int64), minlength=4).tolist()]
        meta: Dict[str, Any] = {
            "bs": int(b),
            "padded_shape": list(xp.shape),
            "work_shape": list(work_shape),
            "nb": int(nb),
            "n_reg": counts[TAG_REG],
            "counts": counts,
        }
        int_fail = fail[~use_reg]
        nfail = int(int_fail.sum())
        meta["nfail"] = nfail
        if nfail:
            meta["fail_mask"] = _pack_mask(int_fail)
            meta["fail_vals"] = to_host(blocks[~use_reg][int_fail]).tobytes()
        return codes, _pack_tags(to_host(tags)), meta

    # -- decompression (pipeline.decompress dispatch target) ------------------
    @staticmethod
    def _decompress_body(blob: bytes, header: Dict[str, Any], body_off: int, device: torch.device) -> torch.Tensor:
        spec = header["spec"]
        quantizer = quant_mod.make(spec["quantizer"], radius=spec["quant_radius"])
        encoder = enc_mod.make(spec["encoder"])
        enc_len = guard_alloc(header["enc_len"], "enc_len")
        q_len = guard_alloc(header["q_len"], "q_len")
        tag_len = guard_alloc(header["tag_len"], "tag_len")
        total = guard_alloc(enc_len + q_len + tag_len, "hybrid body")
        with tel.span("inflate", bytes=total):
            body = ll_mod.make(spec["lossless"]).decompress_bounded(container_body(blob, body_off), total)
        if len(body) != total:
            raise ContainerError(
                f"hybrid body decompressed to {len(body)} bytes; header "
                f"declares {total} (enc+q+tag)"
            )
        enc_bytes = body[:enc_len]
        q_bytes = body[enc_len : enc_len + q_len]
        tag_bytes = body[enc_len + q_len : enc_len + q_len + tag_len]
        dtype = pl_mod._torch_dtype(header["dtype"], "dtype")
        pdtype = pl_mod._torch_dtype(header["pdtype"], "pdtype")
        shape = guard_shape(header["shape"], dtype.itemsize, "shape")
        pshape = guard_shape(header["pshape"], pdtype.itemsize, "pshape")
        quantizer.begin(header["abs_eb"], pdtype)
        quantizer.load(q_bytes)
        hm = header["hyb_meta"]
        b = guard_count(hm["bs"], 1 << 12, "hybrid block side")
        if b < 1:
            raise ContainerError("corrupt hybrid container: block side < 1")
        padded_shape = guard_shape(hm["padded_shape"], 8, "padded_shape")
        work_shape = guard_shape(hm["work_shape"], 8, "work_shape")
        nd = len(padded_shape)
        blk = b**nd
        nb_limit = int(np.prod(padded_shape, dtype=np.int64)) // max(1, blk) + 1
        nb = guard_count(hm["nb"], nb_limit, "hybrid block count")
        n_reg = guard_count(hm["n_reg"], nb, "hybrid regression count")
        guard_alloc(nb * blk * 8, "hybrid block grid")
        n_codes = guard_count(header["n_codes"], 2 * nb * blk + 4096, "n_codes")
        if (
            nd == 0
            or len(work_shape) != nd
            or any(p % b or w > p for p, w in zip(padded_shape, work_shape))
            or nb != int(np.prod(padded_shape, dtype=np.int64)) // blk
            or int(np.prod(work_shape, dtype=np.int64)) != int(np.prod(pshape, dtype=np.int64))
        ):
            raise ContainerError(
                f"corrupt hybrid container: {nb} blocks of side {b}, padded "
                f"shape {list(padded_shape)}, work shape {list(work_shape)} and "
                f"pshape {list(pshape)} do not agree"
            )
        out_bytes = int(np.prod(pshape, dtype=np.int64)) * pdtype.itemsize
        with tel.span("unpack", bytes=out_bytes):
            codes_np = encoder.decode(enc_bytes, n_codes)
        if tag_len != (nb + 3) // 4:
            raise ContainerError(
                f"corrupt hybrid container: tag channel holds {tag_len} "
                f"bytes, {(nb + 3) // 4} expected for {nb} blocks"
            )
        if np.size(codes_np) != (nd + 1) * n_reg + nb * blk:
            raise ContainerError(
                f"corrupt hybrid container: {np.size(codes_np)} codes for {nb} "
                f"blocks of {blk} and {n_reg} regression blocks"
            )
        codes = quant_mod.to_device(np.ascontiguousarray(codes_np), device)
        tags_np = _unpack_tags(tag_bytes, nb)
        if int((tags_np == TAG_REG).sum()) != n_reg:
            raise ContainerError("corrupt hybrid container: tags disagree with the regression count")
        tags = quant_mod.to_device(tags_np.copy(), device)
        with tel.span("rebuild", bytes=out_bytes):
            eb = quantizer.eb
            use_reg = tags == TAG_REG
            pos = 0
            # 1. regression coefficient streams (delta-coded, winning blocks only)
            qhat: List[torch.Tensor] = []
            for k in range(nd + 1):
                dq = quantizer.recover_int_diff(codes[pos : pos + n_reg])
                pos += n_reg
                ceb = eb / 2.0 if k == 0 else eb / (2.0 * b)
                qhat.append(torch.cumsum(dq, 0).to(torch.float64) * (2.0 * ceb))
            # 2. integer-grid groups: zero (identity), lorenzo order 1 / order 2
            n_int = nb - n_reg
            int_blocks = torch.empty((n_int,) + (b,) * nd, dtype=torch.float64, device=device)
            int_tags = tags[~use_reg]
            for tag, order in ((TAG_ZERO, 0), (TAG_LOR1, 1), (TAG_LOR2, 2)):
                sel = int_tags == tag
                cnt = int(np.count_nonzero(tags_np == tag))
                d = quantizer.recover_int_diff(codes[pos : pos + cnt * blk])
                pos += cnt * blk
                d = d.reshape((cnt,) + (b,) * nd)
                q = block_lorenzo_inverse(d, order) if order else d
                int_blocks[sel] = quantizer.dequantize_int(q).to(torch.float64)
            if hm.get("nfail"):
                fl = _unpack_mask(hm["fail_mask"], n_int * blk)
                vals = np.frombuffer(hm["fail_vals"], np.float64)
                if int(fl.sum()) != vals.size:
                    raise ContainerError(
                        f"corrupt hybrid container: fail channel holds {vals.size} "
                        f"values for {int(fl.sum())} masked points"
                    )
                int_blocks.view(-1)[quant_mod.to_device(fl, device)] = quant_mod.to_device(vals.copy(), device)
            # 3. regression residuals against the coefficient-rebuilt planes
            pred = _plane(qhat, block_coords(b, nd, device), n_reg)
            reg_recon = quantizer.recover(pred.reshape(-1), codes[pos:])
            blocks = torch.empty((nb,) + (b,) * nd, dtype=torch.float64, device=device)
            blocks[~use_reg] = int_blocks
            blocks[use_reg] = reg_recon.to(torch.float64).reshape((n_reg,) + (b,) * nd)
            out = unblockify(blocks, padded_shape, b)
            out = out[tuple(slice(0, s) for s in work_shape)]
            pdata = out.to(pdtype).reshape(pshape)
        conf = CompressionConfig(
            mode=ErrorBoundMode(header["mode"]),
            eb=header["eb"],
            quant_radius=spec["quant_radius"],
        )
        data = pre_mod.make(spec["preprocessor"]).inverse(pdata, conf, header["pre_meta"])
        if data.numel() != int(np.prod(shape, dtype=np.int64)):
            raise ContainerError(f"decoded {data.numel()} elements for shape {list(shape)}")
        return data.to(dtype).reshape(shape)


def sz3_hybrid(block_side: Optional[int] = None, **kw) -> BlockHybridCompressor:
    """Named factory: block-level multi-predictor hybrid engine (v5); ``kw``
    goes to :class:`BlockHybridCompressor` (``conf``, ``device``, modules)."""
    return BlockHybridCompressor(block_side=block_side, **kw)


# registration (blockwise imports pipeline/transform, never vice versa); the
# hybrid engine also joins the auto contest — sz3_auto / sz3_quality read
# AUTO_CANDIDATES at call time, so they pick this up
pl_mod.PIPELINES["sz3_hybrid"] = sz3_hybrid
if "sz3_hybrid" not in tr_mod.AUTO_CANDIDATES:
    tr_mod.AUTO_CANDIDATES = tr_mod.AUTO_CANDIDATES + ("sz3_hybrid",)
