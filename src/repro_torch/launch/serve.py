"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> --kv int8``.

Batched greedy decode with the (optionally int8-quantized) KV cache —
the paper's quantizer on the serving path, through the kvquant kernels on
the card.  ``--offload-kv chunked`` additionally streams the finished cache
through the chunked compression engine frame by frame — the
bounded-memory offload path for evicting sequences to host or disk under
heavy traffic.  The command line is the JAX package's
(``python -m repro.launch.serve``) plus ``--device`` (default ``cuda``;
``--device cpu`` runs on the CPU).  :func:`serve` is the body of
:func:`main` for a caller that brings its own config or model.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .. import configs, models
from .. import tree as tree_util
from ..core import telemetry
from ..core.pipeline import resolve_device
from ..models.common import ModelConfig, float32_bf16_reductions
from ..parallel import ParallelPlan
from ..serve.step import make_serve_step

log = telemetry.get_logger("serve")

_OFFLOAD_MODES = ("none", "chunked", "auto", "hybrid", "quality", "fast")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=configs.ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--kv", default="bf16", choices=["bf16", "int8"])
    ap.add_argument(
        "--offload-kv",
        default="none",
        choices=_OFFLOAD_MODES,
        help="'chunked': prediction-pipeline candidates only; 'auto': adds "
        "the sz3_transform and sz3_hybrid candidates (KV channels are often "
        "oscillatory, and mixed hot/cold sequences suit per-block "
        "selection); 'hybrid': the block-hybrid engine only (per-block "
        "predictor selection inside every chunk); 'quality': closed-loop "
        "rate control to --offload-psnr dB instead of a hand-picked error "
        "bound; 'fast': the SZx-style fixed-length tier only — lowest "
        "latency on the eviction path, trading ratio for speed",
    )
    ap.add_argument("--offload-eb", type=float, default=1e-3)
    ap.add_argument("--offload-psnr", type=float, default=60.0, help="PSNR target (dB) for --offload-kv quality")
    ap.add_argument("--offload-workers", type=int, default=1, help="chunk-compression threads for the KV offload stream")
    ap.add_argument(
        "--offload-async",
        action=argparse.BooleanOptionalAction,
        default=False,
        help="route the offload through the async multi-tenant service "
        "(repro_torch.serve.offload): leaves compress concurrently on the "
        "worker pool and verification reads go through the coalescing "
        "per-chunk fetch path instead of full-container decodes",
    )
    ap.add_argument("--offload-executor", default="thread", choices=["thread", "process"],
                    help="worker pool flavor for --offload-async")
    ap.add_argument(
        "--offload-verify",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="strict-decode every offloaded frame on read-back (checksum "
        "trailers verified) before counting it evicted; --no-offload-verify "
        "skips the read-back pass",
    )
    ap.add_argument(
        "--metrics",
        action=argparse.BooleanOptionalAction,
        default=False,
        help="dump the Prometheus-style metrics page (decode-step and "
        "offload-frame latency percentiles, verify-failure counters) and the "
        "per-stage offload trace summary before exiting",
    )
    ap.add_argument("--device", default="cuda", help="where the model runs and the cache compresses (cuda or cpu)")
    args = ap.parse_args(argv)

    serve(
        configs.get_smoke(args.arch),
        ParallelPlan(kv_cache_dtype=args.kv),
        args.batch,
        args.tokens,
        arch=args.arch,
        device=args.device,
        offload_kv=args.offload_kv,
        offload_eb=args.offload_eb,
        offload_psnr=args.offload_psnr,
        offload_workers=args.offload_workers,
        offload_async=args.offload_async,
        offload_executor=args.offload_executor,
        offload_verify=args.offload_verify,
        metrics=args.metrics,
    )


@dataclasses.dataclass
class ServeResult:
    """What one :func:`serve` run leaves: the model, the finished cache, the
    token ids (B, tokens + 1) with the prompt token first, the last step's
    logits, the decode seconds, and the offload's ``(n_in, n_out)`` (None
    without an offload)."""

    params: models.Model
    cache: Union[models.DecodeCache, models.EncDecCache]
    sequences: np.ndarray
    logits: torch.Tensor
    seconds: float
    tok_per_s: float
    offload: Optional[Tuple[int, int]] = None


def serve(
    cfg: ModelConfig,
    plan: ParallelPlan,
    batch: int = 4,
    tokens: int = 16,
    *,
    arch: Optional[str] = None,
    device=None,
    seed: int = 0,
    params: Optional[models.Model] = None,
    offload_kv: str = "none",
    offload_eb: float = 1e-3,
    offload_psnr: float = 60.0,
    offload_workers: int = 1,
    offload_async: bool = False,
    offload_executor: str = "thread",
    offload_verify: bool = True,
    metrics: bool = False,
) -> ServeResult:
    """Greedy decode of ``tokens`` steps for ``batch`` sequences from one
    random prompt token each, then the optional KV offload.

    The model is drawn from ``seed`` on ``device`` (default ``"cuda"``)
    unless ``params`` brings one; an encoder-decoder's frame embeddings
    (B, enc_seq, d) are normal draws from ``seed + 1`` and the prompt tokens
    come from ``seed + 2`` (the reference draws its params from key 0, its
    frames from key 1 and its tokens from key 2).
    The cache holds ``tokens + 8`` positions.  Each step's host seconds,
    ending in a device sync, go to ``sz3_decode_step_seconds``.  bf16 weight
    products accumulate in float32 for the run (cuBLAS's reduced-precision
    bf16 reductions are turned off, then restored)."""
    if offload_kv not in _OFFLOAD_MODES:
        raise ValueError(f"offload_kv must be one of {_OFFLOAD_MODES}, got {offload_kv!r}")
    dev = resolve_device(device) if params is None else _model_device(params)
    with float32_bf16_reductions():
        if params is None:
            params = models.init_params(seed, cfg, plan, device=dev)
        enc_frames = stub_frames(cfg, batch, seed, dev) if cfg.family == "encdec" else None
        cache = models.init_cache(params, cfg, plan, batch, tokens + 8, enc_frames=enc_frames)
        step = make_serve_step(cfg, plan)
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev, dtype=torch.int32)
        out = [tok]
        logits = None
        t0 = time.perf_counter()
        for _ in range(tokens):
            ts = time.perf_counter()
            logits, cache = step(params, cache, tok)
            tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            telemetry.metric_observe("sz3_decode_step_seconds", time.perf_counter() - ts)
            out.append(tok)
        dt = time.perf_counter() - t0
    seqs = torch.cat(out, dim=1).cpu().numpy()
    tok_per_s = tokens * batch / dt
    log.info(
        "decode_done", arch=arch or cfg.name, kv=plan.kv_cache_dtype,
        tok_per_s=tok_per_s,
        sample=str(seqs[0][:12].tolist()),
    )
    tr = None
    offload = None
    if offload_kv != "none":
        candidates = None
        if offload_kv == "auto":
            candidates = "auto"
        elif offload_kv == "hybrid":
            candidates = ("sz3_hybrid",)
        elif offload_kv == "fast":
            candidates = ("sz3_fast",)
        scope = telemetry.trace("kv_offload") if metrics else _NullScope()
        with scope as tr:
            if offload_async and offload_kv != "quality":
                offload = offload_cache_async(
                    cache, eb=offload_eb, workers=offload_workers, candidates=candidates,
                    verify=offload_verify, executor=offload_executor, device=dev,
                )
            else:
                offload = offload_cache(
                    cache, eb=offload_eb, workers=offload_workers, candidates=candidates,
                    target_psnr=offload_psnr if offload_kv == "quality" else None,
                    verify=offload_verify, device=dev,
                )
    if metrics:
        print(telemetry.prometheus_text(), end="")
        if tr is not None:
            print(telemetry.trace_summary(tr))
    return ServeResult(params, cache, seqs, logits, dt, tok_per_s, offload)


def stub_frames(cfg: ModelConfig, batch: int, seed: int, device) -> torch.Tensor:
    """The stubbed audio frontend's output that :func:`serve` feeds an
    encoder-decoder: normal frame embeddings (batch, enc_seq, d_model) drawn
    from ``seed + 1`` in float32, cast to the model's dtype."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=gen, device=device, dtype=torch.float32)
    return x.to(cfg.param_dtype)


def _model_device(params) -> torch.device:
    return models.lm.param_tree(params)["embed"].device


class _NullScope:
    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


def _iter_kv_leaves(cache) -> Iterator[Tuple[Optional[torch.Tensor], Optional[str], int]]:
    """Yield ``(arr, src_dtype_name, src_itemsize)`` per cache leaf.

    Leaves come in the reference's order (:meth:`DecodeCache.leaves` and
    :meth:`EncDecCache.leaves`: k, v, the int8 scales, pos, the SSM states,
    length, then the cross K/V; or a tree's leaves with dict keys sorted).  ``arr`` is the 2-D float32
    working copy the compressor consumes, on the leaf's device, or ``None``
    for leaves rejected by the size/dtype filter (not floating point, or
    under 1024 elements; callers count those as skipped).
    ``src_itemsize`` is the itemsize of the leaf's OWN dtype — bf16 pages
    are 2 B/elem at rest, and offload accounting must charge what eviction
    actually frees, not the float32 working copy.
    """
    is_cache = isinstance(cache, (models.DecodeCache, models.EncDecCache))
    leaves = cache.leaves() if is_cache else tree_util.flatten(cache)[0]
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point() or leaf.numel() < 1024:
            yield None, None, 0
            continue
        a = leaf.detach().to(torch.float32)
        arr = (a.reshape(a.shape[0], -1) if a.ndim > 1 else a).contiguous()
        yield arr, str(leaf.dtype).removeprefix("torch."), leaf.element_size()


def offload_cache(
    cache,
    eb: float = 1e-3,
    chunk_bytes: int = 1 << 20,
    workers: int = 1,
    candidates=None,
    target_psnr: float = None,
    verify: bool = True,
    device=None,
) -> Tuple[int, int]:
    """Stream every float cache leaf through the chunked engine; report totals.

    Frames are produced (and could be written to host/disk) one chunk at a
    time — working memory stays bounded by one chunk regardless of cache size.
    ``candidates="auto"`` (or an explicit name tuple) widens the per-chunk
    contest to the transform coder family.  ``target_psnr`` switches to the
    closed-loop quality-targeted controller: instead of a hand-picked error
    bound, each chunk is compressed at whatever bound hits the PSNR floor,
    and the achieved PSNR is reported alongside the ratio.

    ``verify=True`` strict-decodes every frame on read-back (checksum
    trailers verified) before the bytes are counted as safely evicted — the
    eviction path never trades a live KV page for a silently corrupt one.
    Verification time is reported separately so the cost of the read-back
    pass is visible.  Chunks compress and decode on ``device`` (default
    ``"cuda"``).
    """
    from ..core import AUTO_CANDIDATES, CompressionConfig, ErrorBoundMode, QualityCompressor
    from ..core import decompress as sz3_decompress
    from ..core.chunking import DEFAULT_CANDIDATES, compress_stream

    dev = resolve_device(device)
    if candidates is None:
        candidates = DEFAULT_CANDIDATES
    elif candidates == "auto":
        candidates = AUTO_CANDIDATES
    conf = CompressionConfig(mode=ErrorBoundMode.REL, eb=eb)
    quality = (
        QualityCompressor(
            target_psnr=target_psnr, candidates=candidates, chunk_bytes=chunk_bytes, workers=workers, device=dev,
        )
        if target_psnr is not None
        else None
    )
    n_in = n_out = n_leaves = n_frames = n_skipped = 0
    worst_psnr = None  # None until a leaf actually qualifies
    src_dtypes = set()
    t_verify = 0.0

    def _verify_frame(frame: bytes) -> float:
        """Strict read-back decode, timed into the request-latency histogram;
        failures are counted (globally and in any active trace) and re-raised."""
        tv = time.perf_counter()
        try:
            sz3_decompress(frame, verify="strict", device=dev)
        except Exception:
            telemetry.metric_count("sz3_offload_verify_failures_total")
            raise
        dv = time.perf_counter() - tv
        telemetry.metric_observe("sz3_offload_verify_seconds", dv)
        return dv

    t0 = time.perf_counter()
    for arr, src_name, src_itemsize in _iter_kv_leaves(cache):
        if arr is None:
            n_skipped += 1
            continue
        tl = time.perf_counter()
        if quality is not None:
            res = quality.compress(arr)
            n_out += len(res.blob)
            psnr = res.meta["quality"]["achieved_psnr"]
            worst_psnr = psnr if worst_psnr is None else min(worst_psnr, psnr)
            if verify:
                t_verify += _verify_frame(res.blob)
                n_frames += 1
        else:
            for frame in compress_stream(
                arr, conf, candidates=candidates, chunk_bytes=chunk_bytes, workers=workers, device=dev,
            ):
                n_out += len(frame)
                # payload frames only: the stream prologue is not a container
                if verify and frame[:4] == b"SZ3J":
                    t_verify += _verify_frame(frame)
                    n_frames += 1
        telemetry.metric_observe("sz3_offload_leaf_seconds", time.perf_counter() - tl)
        # source-dtype bytes: eviction frees the leaf AT REST (bf16 = 2
        # B/elem), not the float32 working copy the compressor consumed
        n_in += arr.numel() * src_itemsize
        src_dtypes.add(src_name)
        n_leaves += 1
    dt = time.perf_counter() - t0
    telemetry.metric_count("sz3_offload_leaves_total", n_leaves)
    if n_skipped:
        telemetry.metric_count("sz3_offload_leaves_skipped_total", n_skipped)
    telemetry.metric_count("sz3_offload_bytes_in_total", n_in)
    telemetry.metric_count("sz3_offload_bytes_out_total", n_out)
    fields = dict(
        leaves=n_leaves,
        skipped=n_skipped,
        src_dtype=",".join(sorted(src_dtypes)) if src_dtypes else None,
        ratio=n_in / max(1, n_out),
        MB_per_s=n_in / 1e6 / max(dt, 1e-9),
    )
    if verify:
        fields.update(verified_frames=n_frames, verify_seconds=t_verify)
    if quality is not None:
        psnr_field = {} if worst_psnr is None else {"worst_leaf_psnr_db": worst_psnr}
        log.info("kv_offload", mode="quality", target_psnr_db=target_psnr, **psnr_field, **fields)
    else:
        log.info("kv_offload", mode="chunked_stream", rel_eb=eb, **fields)
    return n_in, n_out


def offload_cache_async(
    cache,
    eb: float = 1e-3,
    chunk_bytes: int = 1 << 20,
    workers: int = 4,
    candidates=None,
    verify: bool = True,
    executor: str = "thread",
    device=None,
) -> Tuple[int, int]:
    """Offload every qualifying cache leaf through the async service.

    Leaves become pages of one ``kv`` tenant and compress concurrently on
    the service's worker pool; with ``verify`` each page's chunk 0 is
    fetched back through the coalescing read path (strict per-chunk CRC
    validation) before the bytes count as evicted.  Accounting matches
    :func:`offload_cache`: source-dtype bytes in, container bytes out.
    """
    import asyncio

    from ..core import ErrorBoundMode
    from ..serve.offload import OffloadService

    dev = resolve_device(device)

    async def _run():
        svc = OffloadService(
            workers=workers,
            executor=executor,
            eb=eb,
            mode=ErrorBoundMode.REL,
            candidates=candidates,
            chunk_bytes=chunk_bytes,
            verify="strict" if verify else "off",
            device=dev,
        )
        n_in = n_out = n_leaves = n_skipped = 0
        src_dtypes = set()
        t0 = time.perf_counter()
        try:
            puts = []
            for i, (arr, src_name, src_itemsize) in enumerate(_iter_kv_leaves(cache)):
                if arr is None:
                    n_skipped += 1
                    continue
                n_in += arr.numel() * src_itemsize
                src_dtypes.add(src_name)
                puts.append(svc.put("kv", f"leaf{i}", arr))
            reports = await asyncio.gather(*puts)
            n_leaves = len(reports)
            n_out = sum(r["n_out"] for r in reports)
            if verify:
                await asyncio.gather(*[svc.fetch("kv", r["page"], 0) for r in reports])
        finally:
            await svc.close()
        dt = time.perf_counter() - t0
        telemetry.metric_count("sz3_offload_leaves_total", n_leaves)
        if n_skipped:
            telemetry.metric_count("sz3_offload_leaves_skipped_total", n_skipped)
        telemetry.metric_count("sz3_offload_bytes_in_total", n_in)
        telemetry.metric_count("sz3_offload_bytes_out_total", n_out)
        log.info(
            "kv_offload", mode="async_service", rel_eb=eb, leaves=n_leaves,
            skipped=n_skipped,
            src_dtype=",".join(sorted(src_dtypes)) if src_dtypes else None,
            ratio=n_in / max(1, n_out), MB_per_s=n_in / 1e6 / max(dt, 1e-9),
            workers=workers, executor=executor,
        )
        return n_in, n_out

    return asyncio.run(_run())


if __name__ == "__main__":
    main()
