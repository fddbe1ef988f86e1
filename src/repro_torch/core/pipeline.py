"""Compression-pipeline composition (paper §3.3, Algorithm 1), in torch.

A compressor is a 5-tuple of module instances.  The driver below is the
paper's Algorithm 1, array-vectorized: it never names a concrete module —
composition is data ("spec").  The container format is the JAX package's v1
container, byte for byte: the header records the module spec, so
``decompress(blob)`` rebuilds the exact pipeline, and blobs move freely
between the two packages.

Array math runs in torch on the compressor's device; byte-level coding
(Huffman, lossless backends, msgpack headers, checksums) runs on the host.
Entry points take a ``device`` and default to ``"cuda"``; without a card they
raise unless the caller asks for ``"cpu"``.

Named factory pipelines ported so far:

  sz3_lr          — composite(Lorenzo+regression) + linear quant + Huffman
                    + zstd (= SZ2 [8])
  sz3_interp      — interpolation + linear quant + Huffman + zstd ([17])
  sz3_lorenzo     — pure dual-quant Lorenzo + linear quant + Huffman + zstd
  sz3_truncation  — byte truncation, all other stages bypassed
  sz3_pastri      — pattern + UNPRED-AWARE quant + Huffman + zstd     (paper §4)
  sz_pastri       — pattern + linear quant + fixed Huffman, no lossless
                    stage                                            (baseline [19])
  sz_pastri_zstd  — sz_pastri + zstd                     (paper Table 1)
  sz3_aps         — error-bound-adaptive APS pipeline                 (paper §5)
  sz3_chunked     — chunked engine, per-chunk pipeline selection (v2,
                    chunking.py)
  sz3_transform   — blockwise 4-point DCT + bitplane coding (v3, transform.py)
  sz3_fast        — SZx-style fixed-length blocks, no entropy stage (v6,
                    fastmode.py)
  sz3_pwr         — pointwise-relative engine: log-composed chunk
                    pipelines, v4 container (chunking.py)
  sz3_auto        — the chunked engine contesting prediction, transform,
                    block-hybrid and fast coders per chunk (transform.py)
  sz3_hybrid      — block-level multi-predictor hybrid engine: per-block
                    zero/Lorenzo-1/Lorenzo-2/regression contest feeding one
                    shared entropy stream (blockwise.py; v5 container)
  sz3_quality     — quality-targeted rate control over the auto contest
                    (PSNR, ratio or bitrate targets; quality.py, v2
                    container)

Pointwise-relative bounds (PW_REL) run through ``preprocess.LogTransform``
in the preprocessor slot, which hands the predictor a float64 log field.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from . import _msgpack
from . import encoders as enc_mod
from . import integrity
from . import lossless as ll_mod
from . import telemetry as tel
from . import predictors as pred_mod
from . import preprocess as pre_mod
from . import quantizers as quant_mod
from .config import CompressionConfig, ErrorBoundMode
from .integrity import (
    ContainerError,
    IntegrityError,
    SalvageReport,
    decode_errors,
    guard_alloc,
    guard_count,
    guard_shape,
)

_MAGIC = b"SZ3J"
_VERSION = 1

#: accepted values for the ``verify=`` policy on the decode entry points
VERIFY_MODES = ("strict", "salvage", "off")

Device = Union[str, torch.device, None]

#: container dtype strings <-> torch dtypes (the JAX package writes numpy's
#: ``dtype.str``; compress turns every other input dtype into float32)
_DTYPES = {"<f4": torch.float32, "<f8": torch.float64}
_DTYPE_STR = {v: k for k, v in _DTYPES.items()}

_MODULES = {
    "preprocessor": pre_mod._REGISTRY,
    "predictor": pred_mod._REGISTRY,
    "quantizer": quant_mod._REGISTRY,
    "encoder": enc_mod._REGISTRY,
    "lossless": ll_mod._REGISTRY,
}


def resolve_device(device: Device) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless told otherwise,
    and an error — never a quiet CPU run — when that device is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def _torch_dtype(s: Any, what: str) -> torch.dtype:
    if s not in _DTYPES:
        raise ContainerError(
            f"container {what} {s!r} is not one repro_torch decodes (have "
            f"{sorted(_DTYPES)})"
        )
    return _DTYPES[s]


def _as_tensor(data, device: torch.device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        a = np.asarray(data)
        # ascontiguousarray returns at least 1-D; keep a 0-d array 0-d
        t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    if t.dtype not in _DTYPE_STR:
        t = t.to(torch.float32)
    return t.to(device).contiguous()


def _finite_stats(data: torch.Tensor) -> Tuple[float, float]:
    """(value range, abs max) over FINITE elements — a stray nan/inf must
    not blow a REL bound up to nan for every other point.  Cheap common
    path: one min/max pass; the masked pass only runs when needed."""
    if not data.numel():
        return 0.0, 0.0
    mn, mx = float(data.min()), float(data.max())
    if not (np.isfinite(mn) and np.isfinite(mx)):
        fin = data[torch.isfinite(data)]
        if not fin.numel():
            return 0.0, 0.0
        mn, mx = float(fin.min()), float(fin.max())
    return mx - mn, max(abs(mn), abs(mx))


def _encode_codes(encoder, codes_t: torch.Tensor, code_dtype) -> Tuple[np.ndarray, bytes]:
    """The codes on the host, cast to ``code_dtype``, and the encoder's
    bytes for them, under the ``huffman`` span (codes in, as ``code_dtype``).
    Codes on the card go to a Huffman encoder as they are: it copies them to
    the host for its table and packs the stream on the card."""
    if codes_t.is_cuda and isinstance(encoder, enc_mod.HuffmanEncoder):
        with tel.span("huffman", bytes=codes_t.numel() * np.dtype(code_dtype).itemsize):
            return encoder.encode_tensor(codes_t, code_dtype)
    codes = quant_mod.to_host(codes_t).astype(code_dtype)
    with tel.span("huffman", bytes=codes.nbytes):
        return codes, encoder.encode(codes)


def _clean_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """Coerce numpy scalars and arrays so msgpack accepts the header."""
    out = {}
    for k, v in meta.items():
        if isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        else:
            out[k] = v
    return out


def pack_container(
    header: Dict[str, Any], body: bytes, chunk_bounds: Optional[Any] = None
) -> bytes:
    """The container wire format: magic + int64 (header, body) lengths +
    msgpack header + body + integrity trailer.

    The trailer (see :mod:`.integrity`) sits BEYOND the declared body length,
    so readers that honour the declared lengths skip it.  ``chunk_bounds``
    lists body-relative ``(off, len)`` of independently decodable chunks for
    per-chunk checksums (the v2 writer passes its chunk table); None
    checksums the whole body as one chunk.  The header gains an ``itg`` flag under the
    header checksum so strict verification can detect a stripped trailer.
    ``integrity.trailers_disabled()`` suppresses both."""
    if integrity.WRITE_TRAILERS:
        header = dict(header)
        header["itg"] = 1
    hbytes = _msgpack.packb(header)
    head = _MAGIC + np.asarray([len(hbytes), len(body)], np.int64).tobytes() + hbytes
    if not integrity.WRITE_TRAILERS:
        return head + body
    with tel.span("integrity", bytes=len(body)):
        trailer = integrity.build_trailer(head, body, chunk_bounds)
    return head + body + trailer


def container_body(blob: bytes, body_off: int) -> bytes:
    """The body slice DECLARED by the prologue — never the raw tail, which
    may carry the integrity trailer (or attacker-appended bytes)."""
    blen = int.from_bytes(blob[12:20], "little", signed=True)
    return blob[body_off : body_off + blen]


@dataclasses.dataclass
class CompressionResult:
    blob: bytes
    ratio: float
    codes: Optional[np.ndarray] = None  # quantization integers (paper Fig 3)
    meta: Optional[Dict[str, Any]] = None


class SZ3Compressor:
    """The general compressor of paper Algorithm 1."""

    kind = "sz3"

    def __init__(
        self,
        preprocessor: pre_mod.Preprocessor = None,
        predictor: pred_mod.Predictor = None,
        quantizer: quant_mod.QuantizerBase = None,
        encoder: enc_mod.Encoder = None,
        lossless: ll_mod.LosslessBackend = None,
        conf: CompressionConfig = None,
        device: Device = "cuda",
    ):
        self.preprocessor = preprocessor or pre_mod.Identity()
        self.predictor = predictor or pred_mod.LorenzoPredictor()
        self.quantizer = quantizer or quant_mod.LinearScaleQuantizer()
        self.encoder = encoder or enc_mod.HuffmanEncoder()
        self.lossless = lossless or ll_mod.Zstd()
        self.conf = conf or CompressionConfig()
        self.device = device

    # -- spec (for the self-describing container) ---------------------------
    def spec(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "preprocessor": self.preprocessor.name,
            "predictor": self.predictor.name,
            "quantizer": self.quantizer.name,
            "quant_radius": self.quantizer.radius,
            "encoder": self.encoder.name,
            "lossless": self.lossless.name,
        }

    @staticmethod
    def from_spec(spec: Dict[str, Any], device: Device = "cuda", route: str = "auto") -> "SZ3Compressor":
        """The compressor a container's spec names, on ``device``; ``route``
        goes to a Lorenzo predictor."""
        for role, registry in _MODULES.items():
            if spec[role] not in registry:
                raise ContainerError(
                    f"unknown container {role} {spec[role]!r}"
                )
        routed = {"route": route} if spec["predictor"] == pred_mod.LorenzoPredictor.name else {}
        return SZ3Compressor(
            preprocessor=pre_mod.make(spec["preprocessor"]),
            predictor=pred_mod.make(spec["predictor"], **routed),
            quantizer=quant_mod.make(spec["quantizer"], radius=spec["quant_radius"]),
            encoder=enc_mod.make(spec["encoder"]),
            lossless=ll_mod.make(spec["lossless"]),
            device=device,
        )

    # -- Algorithm 1 ---------------------------------------------------------
    def compress(
        self, data, conf: CompressionConfig = None, with_stats: bool = False
    ) -> CompressionResult:
        """Compress a numpy array or torch tensor on this compressor's device."""
        conf = conf or self.conf
        data = _as_tensor(data, resolve_device(self.device))
        pdata, conf2, pre_meta = self.preprocessor.forward(data, conf)  # line 1
        rng, absmax = _finite_stats(pdata)
        abs_eb = conf2.resolve_abs_eb(rng, absmax)
        if abs_eb <= 0:
            abs_eb = np.finfo(np.float64).tiny
        self.quantizer.begin(abs_eb, pdata.dtype)
        with tel.span("predict", bytes=pdata.numel() * pdata.element_size()):
            codes_t, pred_meta = self.predictor.compress(pdata, self.quantizer, conf2)  # 2-5
        codes, enc_bytes = _encode_codes(self.encoder, codes_t, self.quantizer.code_dtype)  # lines 9-10
        q_bytes = self.quantizer.save()  # line 8
        header = {
            "v": _VERSION,
            "spec": self.spec(),
            "shape": list(data.shape),
            "pshape": list(pdata.shape),
            "dtype": _DTYPE_STR[data.dtype],
            "pdtype": _DTYPE_STR[pdata.dtype],
            "mode": conf.mode.value,
            "eb": float(conf.eb),
            "abs_eb": float(abs_eb),
            "block_size": int(conf2.block_size),
            **(
                {"eb_rel": float(conf.eb_rel)}
                if conf.eb_rel is not None
                else {}
            ),
            "interp_kind": conf2.interp_kind,
            "lorenzo_order": int(conf2.lorenzo_order),
            "n_codes": int(codes.size),
            "enc_len": len(enc_bytes),
            "q_len": len(q_bytes),
            "pre_meta": dict(pre_meta),
            "pred_meta": dict(pred_meta),
        }
        with tel.span("lossless", bytes=len(enc_bytes) + len(q_bytes)):
            body = self.lossless.compress(enc_bytes + q_bytes)  # line 11
        blob = pack_container(header, body)
        ratio = data.numel() * data.element_size() / max(1, len(blob))
        return CompressionResult(
            blob=blob,
            ratio=ratio,
            codes=codes if with_stats else None,
            meta=pred_meta if with_stats else None,
        )


def parse_header(blob: bytes) -> Tuple[Dict[str, Any], int]:
    """Parse the container prologue; rejects truncated/corrupt blobs with
    :class:`~repro_torch.core.integrity.ContainerError` (a ``ValueError``).
    Every length field is bounded by the actual buffer BEFORE any slice or
    allocation, so a hostile prologue cannot direct reads outside the blob
    or declare absurd sizes."""
    if len(blob) < 20:
        raise ContainerError(
            f"truncated SZ3J container: {len(blob)} bytes, need at least 20"
        )
    if blob[:4] != _MAGIC:
        raise ContainerError("not an SZ3J container")
    lens = np.frombuffer(blob, np.int64, count=2, offset=4)
    hlen, blen = int(lens[0]), int(lens[1])
    if hlen < 0 or blen < 0 or 20 + hlen + blen > len(blob):
        raise ContainerError(
            f"corrupt SZ3J container: header={hlen} body={blen} bytes do not "
            f"fit the {len(blob)}-byte buffer"
        )
    try:
        header = _msgpack.unpackb(blob[20 : 20 + hlen])
    except ValueError as e:
        raise ContainerError(f"corrupt SZ3J container header: {e}") from e
    if not isinstance(header, dict):
        raise ContainerError("corrupt SZ3J container header: not a map")
    return header, 20 + hlen


def decompress(
    blob: bytes,
    workers: Optional[int] = None,
    verify: str = "strict",
    device: Device = None,
    route: str = "auto",
):
    """Self-describing decompression — rebuilds the pipeline from the header
    and runs it on ``device`` (default ``"cuda"``).  Returns a tensor on that
    device.

    ``route`` is the Lorenzo decode's kernel route for blobs the kernel
    route wrote, as for ``LorenzoPredictor``: ``"auto"`` takes the kernel on
    CUDA tensors and the host route on the CPU, ``"force"`` runs the
    kernel's plain version on CPU tensors too (bit for bit the card's
    decode), ``"off"`` never takes it.  The other decoders give the same
    bits on every route.

    Reads v1 single-pipeline containers (the truncation coder's too), v2
    multi-chunk (the quality controller's too), v3 transform, v4
    pointwise-relative multi-chunk, v5 block-hybrid and v6 fast-tier
    containers; a container kind it does not know raises
    :class:`ContainerError` naming it.  ``workers``
    decodes the chunks of a v2/v4 container on that many threads (ignored
    for single-pipeline blobs).

    ``verify`` is the integrity policy (see :mod:`.integrity`):

    * ``"strict"`` (default) — verify the trailer's checksums before decode;
      raise :class:`IntegrityError` naming the damage.  Blobs written before
      the trailer era carry no checksums and pass unverified.
    * ``"salvage"`` — return ``(data, SalvageReport)``: a v2 container
      loses only its damaged chunks (zero-filled); a v1, v3, v5 or v6 body is
      one stream, so damage loses the whole array.
    * ``"off"`` — skip checksum verification (malformed-structure errors
      still raise).

    Every malformed-input failure raises a ``ValueError`` subclass.
    """
    if verify not in VERIFY_MODES:
        raise ValueError(f"verify must be one of {VERIFY_MODES}, got {verify!r}")
    if route not in pred_mod._ROUTES:
        raise ValueError(f"route must be one of {pred_mod._ROUTES}, got {route!r}")
    dev = resolve_device(device)
    blob = bytes(blob)
    with decode_errors("container"):
        header, body_off = parse_header(blob)
        if verify == "salvage":
            return _decompress_salvage(blob, header, body_off, dev, workers)
        if verify == "strict":
            try:
                with tel.span("integrity", bytes=len(blob)):
                    integrity.verify_container(blob, header, body_off)
            except IntegrityError:
                tel.metric_count("sz3_verify_failures_total")
                tel.count("verify_failures")
                raise
        if _is_multichunk(header):
            from .chunking import decompress_chunked  # local: avoids import cycle

            return decompress_chunked(blob, header, body_off, workers, verify, dev, route)
        return _decoder(header, route)(blob, header, body_off, dev)


def _is_multichunk(header: Dict[str, Any]) -> bool:
    """A v2 "chunked" or v4 "pwr" multi-chunk container."""
    return header.get("v", _VERSION) >= 2 and header.get("kind") in ("chunked", "pwr")


def _decoder(header: Dict[str, Any], route: str = "auto"):
    """The body decoder of a parsed single-body container's generation (a v1
    decoder on ``route``); raises :class:`ContainerError` naming a container
    kind this package does not know."""
    spec = header["spec"]
    if not isinstance(spec, dict):
        raise ContainerError("corrupt container: spec is not a map")
    kind = spec.get("kind")
    if kind == "truncation":
        return TruncationCompressor._decompress_body
    if kind == "transform":  # v3 blockwise-transform containers
        from .transform import TransformCompressor  # local: avoids import cycle

        return TransformCompressor._decompress_body
    if kind == "fast":  # v6 SZx-style fixed-length containers
        from .fastmode import FastModeCompressor  # local: avoids import cycle

        return FastModeCompressor._decompress_body
    if kind == "hybrid":  # v5 block-level multi-predictor containers
        from .blockwise import BlockHybridCompressor  # local: avoids import cycle

        return BlockHybridCompressor._decompress_body
    if kind != SZ3Compressor.kind:
        raise ContainerError(
            f"unknown container kind {kind!r}"
        )
    return functools.partial(_decompress_v1, route=route)


def _max_codes(spec: Dict[str, Any], header: Dict[str, Any], pshape: Tuple[int, ...], n_elems: int) -> int:
    """The most codes a v1 body may declare: ``2 n + 4096``, or what the
    composite (``sz3_lr``) predictor writes for ``pshape`` where that is
    more.  It pads every axis to a multiple of the block size ``b`` and
    writes ``b**ndim`` codes per block plus ``ndim + 1`` regression
    coefficients, so a field with an axis of 1 or 2 writes more codes than
    it has elements.  Where that cap is the larger, the padded float64
    blocks the decoder builds must also pass ``guard_alloc``."""
    cap = 2 * n_elems + 4096
    if spec.get("predictor") != "composite" or not pshape:
        return cap
    b = guard_count(header["block_size"], integrity.MAX_OUTPUT_BYTES, "block_size")
    if b == 0:
        raise ContainerError("corrupt container: block_size is 0")
    blocks = 1
    for s in pshape:
        blocks *= -(-s // b)
    need = blocks * (b ** len(pshape) + len(pshape) + 1)
    if need <= cap:
        return cap
    guard_alloc(blocks * b ** len(pshape) * 8, "padded blocks")  # the float64 blocks decoded
    return need


def _decompress_v1(
    blob: bytes, header: Dict[str, Any], body_off: int, device: torch.device, route: str = "auto"
) -> torch.Tensor:
    """The v1 single-pipeline decode path, with every header-declared size
    bounded before allocation."""
    spec = header["spec"]
    comp = SZ3Compressor.from_spec(spec, device=device, route=route)
    dtype = _torch_dtype(header["dtype"], "dtype")
    pdtype = _torch_dtype(header["pdtype"], "pdtype")
    shape = guard_shape(header["shape"], dtype.itemsize, "shape")
    pshape = guard_shape(header["pshape"], pdtype.itemsize, "pshape")
    enc_len = guard_alloc(header["enc_len"], "enc_len")
    q_len = guard_alloc(header["q_len"], "q_len")
    plain_len = guard_alloc(enc_len + q_len, "enc_len+q_len")
    with tel.span("lossless", bytes=plain_len):
        body = comp.lossless.decompress_bounded(
            container_body(blob, body_off), plain_len
        )
    if len(body) != plain_len:
        raise ContainerError(
            f"v1 body decompressed to {len(body)} bytes; header declares "
            f"{plain_len} (enc_len={enc_len} + q_len={q_len})"
        )
    enc_bytes = body[:enc_len]
    q_bytes = body[enc_len:]
    n_elems = int(np.prod(pshape, dtype=np.int64)) if pshape else 1
    n_codes = guard_count(header["n_codes"], _max_codes(spec, header, pshape, n_elems), "n_codes")
    comp.quantizer.begin(header["abs_eb"], pdtype)
    comp.quantizer.load(q_bytes)
    with tel.span("huffman", bytes=len(enc_bytes)):
        codes = comp.encoder.decode(enc_bytes, n_codes)
    conf = CompressionConfig(
        mode=ErrorBoundMode(header["mode"]),
        eb=header["eb"],
        block_size=header["block_size"],
        interp_kind=header["interp_kind"],
        lorenzo_order=header["lorenzo_order"],
        quant_radius=spec["quant_radius"],
    )
    with tel.span("predict", bytes=n_elems * pdtype.itemsize):
        pdata = comp.predictor.decompress(
            quant_mod.to_device(np.ascontiguousarray(codes), device),
            pshape,
            pdtype,
            comp.quantizer,
            conf,
            header["pred_meta"],
        )
    data = comp.preprocessor.inverse(pdata, conf, header["pre_meta"])
    if data.numel() != int(np.prod(shape, dtype=np.int64)):
        raise ContainerError(f"decoded {data.numel()} elements for shape {list(shape)}")
    return data.to(dtype).reshape(shape)


def _decompress_salvage(
    blob: bytes,
    header: Dict[str, Any],
    body_off: int,
    device: torch.device,
    workers: Optional[int] = None,
):
    """``verify="salvage"``: a v2 container recovers every intact chunk and
    zero-fills the damaged ones (see ``chunking.salvage_chunked``); a v1, v3, v5
    or v6 body is one stream, so it is all-or-nothing — a failed checksum or
    decode zero-fills the whole array and records one damage entry.  A
    damaged HEADER is not salvageable and raises :class:`IntegrityError`."""
    res = integrity.inspect(blob, header, body_off)
    if res.has_trailer and not res.header_ok:
        raise IntegrityError(
            "container header bytes fail their checksum — shape, dtype and "
            "chunk table are untrustworthy, nothing can be salvaged",
            region="header",
        )
    if _is_multichunk(header):
        from .chunking import salvage_chunked  # local: avoids import cycle

        return salvage_chunked(blob, header, body_off, workers, res, device)
    decode = _decoder(header)
    dtype = _torch_dtype(header["dtype"], "dtype")
    shape = guard_shape(header["shape"], dtype.itemsize, "shape")
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    report = SalvageReport(total_chunks=1, checksummed=res.has_trailer)
    reason = None
    if res.has_trailer and not res.whole_ok:
        reason = "checksum"
    else:
        try:
            with decode_errors("container"):
                data = decode(blob, header, body_off, device)
            report.recovered.append(0)
            return data, report
        except ValueError:
            reason = "decode-error"
    report.damage.append(integrity.ChunkDamage(0, 0, n, reason))
    return torch.zeros(shape, dtype=dtype, device=device), report


class TruncationCompressor:
    """SZ3-Truncation (paper §6.2): keep the k most-significant bytes of each
    value, bypass every other stage; unbounded absolute error (bounded
    relative error per exponent).  torch has no big-endian dtype, so the
    byte slicing runs on the host in numpy, as all byte coding does.  Takes
    float32/float64 (other dtypes become float32, as at every entry point
    of this package)."""

    kind = "truncation"

    def __init__(self, keep_bytes: int = 2, lossless: str = "none", device: Device = "cuda"):
        self.keep_bytes = keep_bytes
        self.lossless = ll_mod.make(lossless)
        self.device = device

    def compress(self, data, conf=None, with_stats=False) -> CompressionResult:
        host = quant_mod.to_host(_as_tensor(data, resolve_device(self.device)))
        itemsize = host.dtype.itemsize
        k = min(self.keep_bytes, itemsize)
        # big-endian view so byte 0 is the most significant
        raw = host.astype(host.dtype.newbyteorder(">")).view(np.uint8).reshape(-1, itemsize)
        body = self.lossless.compress(np.ascontiguousarray(raw[:, :k]).tobytes())
        header = {
            "v": _VERSION,
            "spec": {"kind": "truncation", "k": k, "lossless": self.lossless.name},
            "shape": list(host.shape),
            "dtype": host.dtype.str,
        }
        blob = pack_container(header, body)
        return CompressionResult(blob=blob, ratio=host.nbytes / max(1, len(blob)))

    @staticmethod
    def _decompress_body(blob, header, body_off, device: torch.device) -> torch.Tensor:
        spec = header["spec"]
        _torch_dtype(header["dtype"], "dtype")  # a dtype this package's tensors take
        dt = np.dtype(header["dtype"])
        k = guard_count(spec["k"], dt.itemsize, "truncation keep_bytes")
        if k < 1:
            raise ContainerError("corrupt container: truncation keep_bytes < 1")
        shape = guard_shape(header["shape"], dt.itemsize, "shape")
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        kept = ll_mod.make(spec["lossless"]).decompress_bounded(container_body(blob, body_off), n * k)
        if len(kept) != n * k:
            raise ContainerError(
                f"truncation body holds {len(kept)} bytes; header declares {n}x{k}"
            )
        raw = np.zeros((n, dt.itemsize), np.uint8)
        raw[:, :k] = np.frombuffer(kept, np.uint8).reshape(n, k)
        out = raw.reshape(-1).view(dt.newbyteorder(">")).astype(dt).reshape(shape)
        return quant_mod.to_device(out, device)


class AdaptiveAPSCompressor:
    """The APS adaptive pipeline (paper §5.2, Fig 5).

    error bound >= threshold : 3-D multialgorithm (Lorenzo+regression) pipeline
    error bound <  threshold : transpose so time is innermost, 1-D Lorenzo,
                               unpred-aware quantizer with the restricted bin
                               (eb clamped to 0.5 => exact for integer counts),
                               fixed Huffman, zstd.

    ``route`` goes to the low branch's ``LorenzoPredictor``: on the card the
    flattened float32 stack takes its 1-D kernel route.
    """

    kind = "aps"

    def __init__(self, threshold: float = 0.5, time_axis: int = 0, route: str = "auto", device: Device = "cuda"):
        self.threshold = threshold
        self.time_axis = time_axis
        self.route = route
        self.device = device

    def _low_pipeline(self, ndim: int) -> SZ3Compressor:
        perm = tuple(i for i in range(ndim) if i != self.time_axis) + (self.time_axis,)
        return SZ3Compressor(
            preprocessor=pre_mod.Transpose(perm=perm, flatten=True),
            predictor=pred_mod.LorenzoPredictor(order=1, route=self.route),
            quantizer=quant_mod.UnpredAwareQuantizer(),
            encoder=enc_mod.FixedHuffmanEncoder(),
            lossless=ll_mod.Zstd(),
            device=self.device,
        )

    def _high_pipeline(self) -> SZ3Compressor:
        return SZ3Compressor(
            predictor=pred_mod.CompositePredictor(),
            quantizer=quant_mod.LinearScaleQuantizer(),
            encoder=enc_mod.HuffmanEncoder(),
            lossless=ll_mod.Zstd(),
            device=self.device,
        )

    def compress(self, data, conf: CompressionConfig = None, with_stats=False) -> CompressionResult:
        conf = conf or CompressionConfig()
        data = _as_tensor(data, resolve_device(self.device))
        rng, absmax = _finite_stats(data)
        abs_eb = conf.resolve_abs_eb(rng, absmax)
        if abs_eb < self.threshold:
            # restricted quantization bin: integer-valued data becomes
            # lossless (paper: "SZ3-APS turns out to be lossless in this case")
            is_integral = bool((torch.round(data) == data).all())
            eff = conf.replace(mode=ErrorBoundMode.ABS, eb=0.5 if is_integral else abs_eb)
            return self._low_pipeline(data.ndim).compress(data, eff, with_stats)
        eff = conf.replace(mode=ErrorBoundMode.ABS, eb=abs_eb)
        return self._high_pipeline().compress(data, eff, with_stats)


# ---------------------------------------------------------------------------
# named pipeline factories
# ---------------------------------------------------------------------------

def sz3_lr(**kw) -> SZ3Compressor:
    """Composite (Lorenzo + regression) + linear quantizer + Huffman + zstd
    (SZ2); ``kw`` goes to :class:`SZ3Compressor` (``conf``, ``device``)."""
    return SZ3Compressor(
        predictor=pred_mod.CompositePredictor(),
        quantizer=quant_mod.LinearScaleQuantizer(),
        encoder=enc_mod.HuffmanEncoder(),
        lossless=ll_mod.Zstd(),
        **kw,
    )


def sz3_interp(kind: str = "cubic", **kw) -> SZ3Compressor:
    """Multi-level interpolation (``kind`` "linear" or "cubic") + linear
    quantizer + Huffman + zstd; ``kw`` goes to :class:`SZ3Compressor`."""
    return SZ3Compressor(
        predictor=pred_mod.InterpolationPredictor(kind=kind),
        quantizer=quant_mod.LinearScaleQuantizer(),
        encoder=enc_mod.HuffmanEncoder(),
        lossless=ll_mod.Zstd(),
        **kw,
    )


def sz3_lorenzo(order: int = 1, route: str = "auto", **kw) -> SZ3Compressor:
    """Dual-quant Lorenzo + linear quantizer + Huffman + zstd.  ``route``
    picks the predictor's kernel route (see ``LorenzoPredictor``); ``kw``
    goes to :class:`SZ3Compressor` (``conf``, ``device``)."""
    return SZ3Compressor(
        predictor=pred_mod.LorenzoPredictor(order=order, route=route),
        quantizer=quant_mod.LinearScaleQuantizer(),
        encoder=enc_mod.HuffmanEncoder(),
        lossless=ll_mod.Zstd(),
        **kw,
    )


def sz3_truncation(keep_bytes: int = 2, **kw) -> TruncationCompressor:
    """Byte truncation; ``kw`` goes to :class:`TruncationCompressor`
    (``lossless``, ``device``)."""
    return TruncationCompressor(keep_bytes=keep_bytes, **kw)


def sz_pastri(pattern_size: int = None, **kw) -> SZ3Compressor:
    """Baseline SZ-Pastri [19]: linear quantizer (raw unpredictables), fixed
    Huffman, NO lossless stage; ``kw`` goes to :class:`SZ3Compressor`."""
    return SZ3Compressor(
        predictor=pred_mod.PatternPredictor(pattern_size=pattern_size),
        quantizer=quant_mod.LinearScaleQuantizer(),
        encoder=enc_mod.FixedHuffmanEncoder(),
        lossless=ll_mod.Passthrough(),
        **kw,
    )


def sz_pastri_zstd(pattern_size: int = None, **kw) -> SZ3Compressor:
    """SZ-Pastri with zstd (paper Table 1 middle rows)."""
    return SZ3Compressor(
        predictor=pred_mod.PatternPredictor(pattern_size=pattern_size),
        quantizer=quant_mod.LinearScaleQuantizer(),
        encoder=enc_mod.FixedHuffmanEncoder(),
        lossless=ll_mod.Zstd(),
        **kw,
    )


def sz3_pastri(pattern_size: int = None, **kw) -> SZ3Compressor:
    """SZ3-Pastri (paper §4.2): unpred-aware quantizer + lossless stage."""
    return SZ3Compressor(
        predictor=pred_mod.PatternPredictor(pattern_size=pattern_size),
        quantizer=quant_mod.UnpredAwareQuantizer(),
        encoder=enc_mod.HuffmanEncoder(),
        lossless=ll_mod.Zstd(),
        **kw,
    )


def sz3_aps(threshold: float = 0.5, time_axis: int = 0, route: str = "auto", **kw) -> AdaptiveAPSCompressor:
    """The APS adaptive pipeline; ``route`` as for ``sz3_lorenzo``, ``kw``
    goes to :class:`AdaptiveAPSCompressor` (``device``)."""
    return AdaptiveAPSCompressor(threshold=threshold, time_axis=time_axis, route=route, **kw)


PIPELINES = {
    "sz3_lr": sz3_lr,
    "sz3_interp": sz3_interp,
    "sz3_lorenzo": sz3_lorenzo,
    "sz3_truncation": sz3_truncation,
    "sz_pastri": sz_pastri,
    "sz_pastri_zstd": sz_pastri_zstd,
    "sz3_pastri": sz3_pastri,
    "sz3_aps": sz3_aps,
}
