"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

1. environment: the card, torch and CUDA versions, which host packages
   import (they decide the container's lossless backend and checksum);
2. build: compile the six CUDA sources under
   ``src/repro_torch/kernels/*/csrc`` and the transform's baseline (one
   ``nvcc`` each, all at once);
3. kernels: each kernel against its plain version on the card, bit for bit
   (NaN equal to NaN), at the main paths' shapes and ragged ones, with its
   time, the plain version's time, a PyTorch library call's time and its
   bound: the four Lorenzo kernels (``decode_1d`` also at the chunked
   engine's chunk (1, 2^20), on rows that start unaligned (5, 8197) and on
   sums that wrap int32; ``decode_2d`` also at the chunk shapes (291, 3600)
   and (54, 3600), on (1, 5000), (5000, 1), (2, 4099), (65, 129) and on
   wrapping sums (3, 70001) and (300, 1000); chunk shapes timed over
   ``CHUNK_REPS`` calls), the transform rotation (``fwd``/``inv``,
   1d and 2d modes; also, over 101 calls, at the ``checkpoint`` phase's
   chunks (1024, 1024) and 1-row chunks padded to (4, 2^20) and
   (4, 2883584); bit for bit for every pair of float32 and float64 input
   and output at those shapes, 1800x3600 and (1, 2^24+4), where it is also
   timed in turns against the kernel it replaced (``tools/baseline/``,
   built beside the port's sources), and the coder's float64 stage, one
   launch, against the cast, kernel, cast sequence it replaced), the
   float64 transform axis product (against numpy's
   product on the host), the fast tier's ``block_stats`` (bs 128, 256;
   also at the throughput tier's chunk 4096x256, on 1 and 8003 blocks and
   on NaN and +-inf inside blocks and as whole blocks) and
   the four KV-quantization kernels (``absmax`` and
   ``quantize_with_scale`` bit for bit, NaN and all-zero columns included;
   ``dequant_matmul`` within ``(K+2) * 2**-24 * (|a| @ |deq|)`` of a
   float64 product, as its plain version is, also on rows near 2^-100 and
   2^100, on rows with NaN and infinities, whose non-finite outputs
   must sit where the plain version's do, and at 2048x32768x1024, where
   all of K runs in one split; its sums on rows built to expose the
   tensor cores' truncating accumulator must equal
   ``ref.tensor_core_dequant_matmul``, the model its worst case is counted
   on; its bound counts three bf16
   products per multiply-add at the tensor cores' rate) at one layer's V
   cache of Qwen1.5-0.5B at a 32K-token prompt, (32768, 1024), and ragged
   shapes; the fused int8 decode append ``quantize_append`` timed at
   granite-3-8b's append shape (B, 1, KV, hd) = (4, 1, 8, 128) in bf16,
   and bit for bit with its plain version, untimed, on NaN, +-inf,
   all-zero, subnormal, floored and rint-tie rows, float32 and bf16
   inputs, hd 64, 112 and 128, slots 0 and W - 1, every other slot of the
   caches left as it was;
   and the bitplane transpose (``encode``/``decode``) on the 6,480,000
   integers the v3 coder hands its host bitplane codec for the 1800x3600
   field, on 2^24+3 uniform uint32 and on n = 0, 5, 16385, with its planes
   held against the host codec's, and, untimed, on R = 130, 1003, 4099 and
   2^20+3 groups, on views 1 and 2 elements past an aligned base and on
   all-ones and one-bit-per-plane values; the encodes ``encode_1d`` and
   ``encode_2d`` are timed at the chunk shapes as the decodes are, and held
   bit for bit, untimed, on widths 1 and 3, rows one past a warp's span
   ((3, 257), (2, 4097), (2, 4099), (33, 129), (65, 129)), rows that end
   inside a strip ((17, 132)), single rows and columns, views 4, 8 and 12
   bytes past an aligned base (the kernels' 4-byte variant) and tie values
   (x * f32(1/(2eb)) exactly k + 1/2, magnitudes just under 2^22 * 2eb,
   diffs of INT32_MIN);
3b. Huffman pack (``huffman``): the stream pack kernel against its plain
   version and the host coder's ``_encode_stream``, byte for byte, on
   ``hacc.lorenzo``'s 70,238,467 particles and on a 4 MiB chunk (291 x
   3600) of a CESM-ATM-shaped field, each through its Lorenzo encode at REL
   1e-4; the coder's tensor path against its numpy path, blob for blob;
   timed with the L2 flushed beside its bytes bound (codes in, stream
   out) and the plain version, with the host numpy pack's and the whole
   coder's seconds both ways; and ``sz3_lorenzo`` on the 70.2 M series,
   one pack launch a compress (the pack replaces host numpy, no TPU kernel);
4. main paths, each on a smooth 1800x3600 float32 field (the shape of an
   SDRBench CESM-ATM 2-D field) and on a 2^24+3-element series (HACC-like
   particle data, cut from HACC's 280,953,867 elements so the host coding
   stages fit the run), REL 1e-4, compress and decompress on the card:
   ``sz3_lorenzo``, ``sz3_transform`` and ``sz3_fast``; then the bitplane
   transpose's own entry point on the v3 coder's integers; then the v2
   chunked engine ``sz3_chunked`` on both inputs (4 MiB chunks: 7 of the
   field, 17 of the series; per-chunk picks among ``sz3_lorenzo``,
   ``sz3_lr`` and ``sz3_interp``) and with ``speed_tier="throughput"`` on
   the series (``sz3_fast`` joins the contest), each also at ``workers=4``;
   then ``sz3_lr`` and ``sz3_interp`` alone on the field;
5. host route: small 3-D fields compressed on the card and on the CPU give
   the same bytes (``sz3_lorenzo``, ``sz3_transform``), and so do
   ``sz3_transform`` fields with an axis that pads to exactly 4;
6. pointwise-relative bounds (``pw_rel``): the field with a band of
   negative rows, scattered negatives, zeros, NaN, +-inf and float32
   subnormals written in, PW_REL 1e-3, through v1
   ``SZ3Compressor(preprocessor=LogTransform(), predictor=LorenzoPredictor())``,
   ``sz3_pwr`` (4 MiB chunks, also at ``workers=4``) and ``sz3_fast``
   (``block_stats`` once, on the float64 log field's float32 cast; the
   float64 Lorenzo paths launch no kernel): the pointwise bound, exact
   zeros, bit-exact non-finite values and subnormals, the plain route's
   bytes; and the count of elements where ``torch.log2`` on the card
   differs from ``numpy.log2`` (a finding; nothing switches on it);
7. GAMESS (``gamess``): an ERI-like stream of 70,000 blocks of a
   96-value pattern (53.76 MB of float64, 15% non-conforming blocks) made
   on the card, through ``sz_pastri``, ``sz_pastri_zstd`` and
   ``sz3_pastri`` at ABS 1e-10 (pattern 96, as the repository's GAMESS
   benchmark passes it): the bound, the plain route's bytes, the ratio
   with the lossless backend that really ran, and the paper's Table 1
   ratio order as observed (not a gate);
8. APS (``aps``): a 256x256x256 float32 photon-count stack made on the
   card, through ``sz3_aps`` at ABS 0.25 (the low branch: one 1-D row
   through ``encode_1d`` once and ``decode_1d`` twice, counts decoded
   exactly), at ABS 2.0 (the 3-D composite, within the bound) and
   ``sz3_truncation(keep_bytes=2)`` (the top two bytes of every value):
   the plain route's bytes each;
9. block hybrid (``hybrid``): ``sz3_hybrid`` compressing and decompressing
   on the card, on the field at REL 1e-4 and at ABS 1e-3 of its range, on
   the series at REL 1e-4, on a 100x500x500 float32 field (the shape of an
   SDRBench Hurricane-ISABEL field) with regime tiles written in so each of
   the four tags wins somewhere, at ABS 2^-8, and on the ``pw_rel`` field
   at PW_REL 1e-3: no launches, the plain route's bytes, the bound
   (pointwise under PW_REL, non-finite values and subnormals bit-exact),
   and every gamma length the card computed equal to numpy's on the host
   copy; tag shares and stage seconds;
10. ``sz3_auto`` (``auto``) on the field and the series at REL 1e-4, with
   the chunked engine's checks: per-chunk picks among the six candidates,
   the ``workers=4`` blob, launches equal to the chunks routed to each
   kernel (the transform's too), the plain route's bytes chunk by chunk;
11. quality controller (``quality``): ``sz3_quality(target_psnr=60)`` and
   ``sz3_quality(target_ratio=10)`` on the field: the achieved PSNR at or
   above the target (the record's, and the decode's within 1e-9 dB), the
   plain route's bytes, launches equal to those of the full-chunk
   compressions that ran on the card, per-chunk eb, iterations,
   confirmations and picks, and the share of the MSE stage (numpy on host
   copies);
12. telemetry (``telemetry``): a traced ``sz3_chunked`` compress and
   decode of the field at REL 1e-4, at ``workers=1`` and ``workers=4``: the
   traced blobs (their chunk tables carry ``sel`` entries) equal each other
   and the plain route's traced blob, ``explain`` and the live decision
   records read the same from both, launches equal the routed chunks; the
   trace's stage seconds (its spans synchronise the card at exit) beside
   the wrapped stages, ``trace_summary`` and the Prometheus page's lines;
13. checkpoint (``checkpoint``): Qwen1.5-0.5B's train state at full width
   (d_model 1024, d_ff 2816, vocab 151936, QKV bias, tied embedding) with
   its stacked blocks cut from 24 layers to 2, laid out as the JAX
   package's ``init_train_state`` lays it out: bf16 ``params``, float32
   ``opt/m`` and ``opt/v`` from two steps of ``adamw.update`` on gradients
   made on the card, ``opt/step``; saved under the default
   ``CheckpointPolicy`` sync and async (every param ``add_(1)`` in place
   after the async ``save()`` returns: the two checkpoints must be equal),
   restored onto the card from a meta-device template: lossless leaves bit
   for bit, lossy leaves within their recorded bound, a sample of leaf
   blobs (one per whole-leaf codec, 4 chunks of each ``sz3_auto_rel`` leaf)
   equal to the plain route's on the host, launches of a save and a
   restore equal to the chunks routed to each kernel;
14. KV offload (``offload``): one ``OffloadService`` on the card (thread
   executor, ABS 1e-3, 64 KiB chunks, strict verify) with one sequence's K
   and V pages of (4096, 1024) float32 made by ``v_cache`` (on these every chunk
   picks ``sz3_interp``, so no kernel runs), one chunk of one page
   corrupted through ``faults.corrupt_chunk``, 256 fetches (whole pages and
   chunks, half at two hot pages): exactly the requests that read the
   damaged chunk fail
   with ``OffloadError``, every fetched value keeps the bound and equals
   the plain route's decode of the same blob, ``encode_2d`` launches equal
   the chunks routed to ``sz3_lorenzo`` and ``decode_2d`` launches the
   chunk decodes that missed the cache (plus the whole-page decodes);
   request latency p50/p99 from the port's ``StreamingHistogram``; a put
   of a quarter page under ``cProfile`` (where a put's host time goes);
15. compressed DP step: a seeded gradient tree with Qwen1.5-0.5B's full
   shapes (463,987,712 parameters) through ``compressed_reduce_tree``
   (``int8:bs=512`` and ``int4:bs=512``) on a one-rank NCCL group opened
   through a ``FileStore`` in a temporary directory, every block within its
   bound and the card's codes equal to ``encode_host`` on the host copy;
   then three ``adamw.update`` steps with compressed moments
   (``int8:bs=256``);
16. KV prefill: ``quantize_prefill``/``dequantize_prefill`` on one layer's K
   and V, (1, 32768, 16, 64), within the per-token bound and equal to
   ``encode_host``; then ``kv_quantize`` on the V cache as (32768, 1024) and
   ``kv_dequant_matmul`` with 128 rows of attention weights — the
   KV-quantization kernels' main path;
17. serving (``serve``): the launcher's ``serve`` at granite-3-8b's full
   width and depth (40 layers, d_model 4096, 32 query and 8 KV heads of
   128, d_ff 12800, vocab 49155 padded to 49408, bf16: 8.37 B parameters
   drawn from the seed on the card) with the launcher's defaults, batch 4
   and 16 greedy tokens: at ``--kv bf16`` every logit finite, no kernel
   launched, ``prefill_logits`` over the 16 consumed tokens within 10% of
   the largest |logit| of the last step's (bf16 drift over 40 layers);
   ``offload_cache`` of the finished cache (chunked, REL 1e-3, strict
   verify): per-leaf ratio and picks, ``encode_2d``/``decode_2d``
   launches equal to the chunks routed to ``sz3_lorenzo``, the ``k``
   leaf's blob equal to the plain route's on the host, and the same
   offload traced for its stage seconds; at ``--kv int8``:
   ``quantize_append`` launched exactly 40 x 16 times (the int8 append,
   one launch per layer a step) and ``absmax`` and ``quantize_with_scale``
   never, the log-probability drift from bf16 on the same tokens
   under the reference's 0.3, ``_quantize_token`` of the bf16 cache's K
   and V on the card equal bit for bit to its plain version on the host,
   the fused append of every layer's K and V into the int8 cache equal bit
   for bit (whole caches and scales) to the sequence it replaced (two
   ``_quantize_token`` calls and four ``index_copy_``), the host
   microseconds of one layer's append both ways, and the int8 cache's
   offload (the scales only: the codes are not float); tokens/s and step
   p50/p99 from ``sz3_decode_step_seconds``; the fused append and the
   standalone pair timed at the decode shape ((4, 1, 8, 128); the pair at
   (128, 32)); then the weight-stationary decode (``decode_feature_shard``
   with FSDP over ``data``) of the same weights on a one-card NCCL mesh
   through ``jit_serve_step``, bf16 and int8, 16 greedy tokens from the
   same prompt: tokens and last logits equal to the plain runs' bit for
   bit, ``quantize_append`` 40 x 16 more times, step p50/p99 beside the
   plain runs';
18. training (``train``): the launcher's ``train`` (``launch/train.py``)
   at Qwen1.5-0.5B's full width and depth (24 layers, d_model 1024, 16/16
   heads, d_ff 2816, vocab 151936 padded to 152064, tied embedding, QKV
   bias, bf16: 464,118,784 parameters drawn on the card) at the
   ``train_4k`` cell's sequence of 4096, the global batch cut from 256 to
   8, in ``launch/plans.py``'s 2 microbatches, remat ``full``: 6 plain
   steps, then 6 with ``--mesh data=1 --compress-grads int8 --compress-opt
   int8:bs=256`` on a one-rank NCCL mesh; losses and grad norms, step
   p50/p99 (host clock, each step ending in a sync), tokens/s, the
   model-FLOPs share (6 N tokens a step, N = ``n_flop_params``, over the
   step and 989 TFLOP/s), peak memory, one more step under
   ``torch.profiler`` (device time by kernel and kind, the busy share); no
   kernel launched in a step, the first loss within 0.5 of ln(vocab), and
   a ``microbatches=1`` step on the first batch within 1e-3 of its loss;
   then on the smoke config in float32: 3 steps on the card against the
   CPU from one state (losses within 1e-5 relative, parameters within
   Adam's sign bound), the loss falling more than 1.0 in 25 steps on one
   repeated batch, and save and resume through the launcher (the default
   policy: ``encode_2d``/``decode_2d`` launches equal to the lossy leaves
   routed to them, each within its recorded bound; a lossless policy: the
   resumed step bit for bit against the same step from the saved state in
   memory);
19. model families (``families``): the launcher's ``serve`` at the full
   configs of deepseek-moe-16b (16.4 B bf16 parameters: 64 routed experts
   at top-6, 2 shared, layer 0 dense), qwen3-moe-30b-a3b (GQA, 128 experts
   at top-8, no shared expert; depth cut from 48 layers to 8),
   mamba2-2.7b (64 Mamba2 layers), zamba2-7b (81 Mamba2 layers and one
   shared attention block applied 13 times) and whisper-small (12 encoder
   layers over 1500 frames, 12 decoder layers), batch 4 and 16 greedy
   tokens each, drawn on the card from the seed: at ``--kv bf16`` no
   kernel launched, tokens/s, step p50/p99 and peak memory; prefill over
   the consumed tokens against the last step within 10% of the largest
   |logit| (not MoE: the reference drops different assignments at prefill
   and at decode); for MoE the share of assignments dropped at each step,
   one step from one cache run twice to the same bits, and, at full width
   in float32 with 2 layers, 4 steps and a 16-token prefill on the card
   and on the CPU from one set of weights with every call's top-k ids and
   kept slots identical; at ``--kv int8`` ``quantize_append`` launched
   exactly (attention layers) x 16 times (448, 128, 0, 208, 192) and the
   standalone pair never, the drift from bf16 under 0.3
   (MoE: the reference itself drifts past 0.3 at full width as tokens'
   top-k sets flip under the int8 noise, so the full-depth drift and the
   flipped assignments are reported, and the drift is held against the
   reference's own reading from ``tools/moe_int8_drift.py``: the same
   weights, tokens and depth on the card, the reference's top-k ids
   pinned, within a stated tolerance of the reference's drift),
   ``_quantize_token`` on the bf16 cache bit for bit against its plain
   version, the fused append against the sequence it replaced as in
   ``serve``, the fused append and the standalone pair timed at each
   family's append shape and the append's host time both ways, and
   mamba2-2.7b's int8 run equal to its bf16 run; the bf16 cache's first
   64 MB in the reference's leaf order (the leaf that does not fit cut to
   its leading layers) through ``offload_cache`` (chunked, strict verify),
   launches equal to the chunks routed to each kernel, every leaf decoded
   on the card within its bound;
20. elastic restore (``elastic``, run right after ``checkpoint``): that
   phase's sync checkpoint restored through ``ft.elastic.restore_resharded``
   onto the card's elastic mesh ((1, 1), ``make_elastic_mesh``) under a plan
   without FSDP, where the embedding's spec is (model, None): every leaf
   bit-equal to the plain restore placed in its spec, every chunked leaf
   whose spec shards nothing past dim 0 read by chunk range, decode-kernel
   launches equal to the chunks routed to ``decode_1d``, ``decode_2d`` and
   the transform's ``inv``, the rest as the plain restore's, seconds beside
   the plain restore's; then ``ChunkRangeReader.rows`` over rows [n/4, n/2)
   of the largest chunked leaf (an embedding moment, 151,936 x 1,024),
   equal to the full decode's rows, reading about a quarter of its
   container;
21. dry run (``dryrun``): ``launch/dryrun.py`` in two CPU-only
   subprocesses started before ``train`` and read after it, the CLI's
   Qwen1.5-0.5B ``train_4k`` cell on a fake 16 x 16 group and the train
   phase's own shapes (batch 8, seq 4096) on a fake (1, 1) mesh, whose
   counted dot FLOPs must be within 1% of ``torch.profiler``'s
   (``with_flops``) over one real step of ``train`` (the calls that
   launched a kernel), its counted peak beside that phase's
   ``max_memory_allocated`` and its compute term beside the step p50.

Each main path must launch its kernels (the launch counters are zeroed just
before the path and read just after; the chunked engine exactly once per
chunk routed to a kernel), keep the error bound, write the same bytes as
the plain versions on the CPU (``device="cpu", route="force"``), and decode
on the CPU within the bound.

The last three lines are the ``{"kernels": [...]}`` summary (with
``chunk_*`` and ``row_chunk_*`` fields where a kernel was also timed at a
chunk shape, ``parent_ms``, ``stage_ms``, ``old_stage_ms`` and
``stage_bound_ms`` (and their ``chunk_``/``row_chunk_`` forms) for the
transform rotation's turns against the kernel and the stage it replaced,
``serve_*`` fields for the kvquant append kernels at the decode
shape, whose ``launches`` include the serve phase's, and ``families_*``
fields with their launches and times per family), the card's name
and power limit as ``nvidia-smi`` prints them, and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before them.
Without a CUDA device, or without the repository's ``src/`` beside it, the
script fails.  Full results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import importlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: device memory rate by card name (NVIDIA data sheets), bytes/s
_BANDWIDTH = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))
#: float32 rate outside the tensor cores, H100 SXM data sheet; the kernels'
#: integer and float32 ALU work is counted against it
_ALU_RATE = 67e12
#: float64 rate outside the tensor cores, H100 SXM data sheet
_F64_RATE = 34e12
#: dense bf16 rate of the tensor cores, H100 SXM data sheet
_BF16_TC_RATE = 989e12
_LORENZO_SRC = "src/repro_torch/kernels/lorenzo/csrc/lorenzo.cu"
_TRANSFORM_SRC = "src/repro_torch/kernels/transform/csrc/transform.cu"
_FASTMODE_SRC = "src/repro_torch/kernels/fastmode/csrc/fastmode.cu"
_KVQUANT_SRC = "src/repro_torch/kernels/kvquant/csrc/kvquant.cu"
_BITPLANE_SRC = "src/repro_torch/kernels/bitplane/csrc/bitplane.cu"
_HUFFMAN_SRC = "src/repro_torch/kernels/huffman/csrc/huffman.cu"
#: the transform rotation's first design, the yardstick of its turns
_TRANSFORM_BASELINE_SRC = "tools/baseline/transform_baseline.cu"
#: summary name -> (source, the TPU kernel or host code it replaces)
_KERNELS = {
    "encode_1d": (_LORENZO_SRC, "src/repro/kernels/lorenzo/kernel.py:107"),
    "encode_2d": (_LORENZO_SRC, "src/repro/kernels/lorenzo/kernel.py:131"),
    "decode_1d": (_LORENZO_SRC, "src/repro/kernels/lorenzo/kernel.py:155"),
    "decode_2d": (_LORENZO_SRC, "src/repro/kernels/lorenzo/kernel.py:171"),
    "transform_fwd_2d": (_TRANSFORM_SRC, "src/repro/kernels/transform/kernel.py:60 (fwd :78)"),
    "transform_inv_2d": (_TRANSFORM_SRC, "src/repro/kernels/transform/kernel.py:60 (inv :83)"),
    "transform_fwd_1d": (_TRANSFORM_SRC, "src/repro/kernels/transform/kernel.py:60 (fwd :78)"),
    "transform_inv_1d": (_TRANSFORM_SRC, "src/repro/kernels/transform/kernel.py:60 (inv :83)"),
    "transform_axis_f64": (_TRANSFORM_SRC, "src/repro/core/transform.py:92 (_apply_axis, numpy on the host; no TPU kernel)"),
    "block_stats": (_FASTMODE_SRC, "src/repro/kernels/fastmode/kernel.py:35"),
    "absmax": (_KVQUANT_SRC, "src/repro/kernels/kvquant/kernel.py:56"),
    "quantize_with_scale": (_KVQUANT_SRC, "src/repro/kernels/kvquant/kernel.py:70"),
    "dequant_matmul": (_KVQUANT_SRC, "src/repro/kernels/kvquant/kernel.py:106"),
    "quantize_append": (_KVQUANT_SRC,
                        "src/repro/kernels/kvquant/kernel.py:56 + :70 (fused for the int8 decode append)"),
    "bitplane_encode": (_BITPLANE_SRC, "src/repro/kernels/bitplane/kernel.py:36"),
    "bitplane_decode": (_BITPLANE_SRC, "src/repro/kernels/bitplane/kernel.py:49"),
    "huffman_pack": (_HUFFMAN_SRC, "src/repro_torch/core/encoders.py _encode_stream (numpy on the host; no TPU kernel)"),
}
#: bytes each kernel must move per element (inputs read once, outputs
#: written once) and the ALU operations it does per element
_BYTES_PER_ELEM = {"encode_1d": 12, "encode_2d": 12, "decode_1d": 8, "decode_2d": 8}
_OPS_PER_ELEM = {"encode_1d": 6, "encode_2d": 9, "decode_1d": 3, "decode_2d": 4}
N1D = (1 << 24) + 3
SHAPE2D = (1800, 3600)
#: Qwen1.5-0.5B (src/repro/configs/qwen1_5_0_5b.py): 24 layers, d_model
#: 1024, 16 heads of 64 (16 KV heads), d_ff 2816, vocab 151936, 32K context
QWEN = {"layers": 24, "d": 1024, "ff": 2816, "vocab": 151936, "kv_heads": 16, "hd": 64, "context": 32768}
#: rows of attention weights read against the quantized V cache
KV_QUERIES = 128

RESULTS: dict = {}


def emit(phase: str, **fields) -> None:
    RESULTS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bandwidth(name: str) -> float:
    for key, rate in _BANDWIDTH:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


class Timer:
    """Median CUDA-event time of one call.  A large buffer is zeroed before
    each timed call: that evicts the 50 MB L2, as a caller that just touched
    other data would find it, and keeps the GPU busy while the host enqueues
    the call, so host overhead does not land inside the timed window."""

    def __init__(self, reps: int = 15, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def smooth_field(shape, seed: int) -> torch.Tensor:
    """A smooth float32 field made on the card: a few random plane waves
    plus small noise, the character of a climate-model 2-D variable."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows, cols = shape
    yy = torch.linspace(0, 1, rows, device="cuda", dtype=torch.float64)[:, None]
    xx = torch.linspace(0, 1, cols, device="cuda", dtype=torch.float64)[None, :]
    f = torch.zeros(shape, device="cuda", dtype=torch.float64)
    for _ in range(6):
        ky, kx, ph, amp = torch.rand(4, generator=g, device="cuda", dtype=torch.float64)
        f += (1 + 9 * amp) * torch.sin(2 * math.pi * (1 + 7 * ky) * yy + 2 * math.pi * (1 + 7 * kx) * xx + 6.3 * ph)
    f += 0.01 * torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)
    return (250.0 + f).to(torch.float32)


def particle_series(n: int, seed: int) -> torch.Tensor:
    """A float32 series like one HACC particle coordinate: positions in a
    256-unit box that drift smoothly along the particle ordering."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    steps = 0.02 * torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    walk = torch.cumsum(steps, 0)
    t = torch.arange(n, device="cuda", dtype=torch.float64) / n
    return (128.0 + 100.0 * torch.sin(2 * math.pi * 3 * t) + walk).to(torch.float32)


def host_crc32c_rate(nbytes: int = 64 << 20) -> float:
    """MB/s of the port's numpy CRC32C (what verifies CRC32C trailers where
    ``google_crc32c`` is missing) over ``nbytes`` random bytes, on this host's
    CPU; needs no card (``python3 -c "import chip_smoke;
    print(chip_smoke.host_crc32c_rate())"`` from the repository root)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import integrity

    data = np.random.default_rng(3).integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    integrity.crc32c_numpy(data)
    return nbytes / (time.perf_counter() - t0) / 1e6


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    importlib.import_module("repro_torch.core")  # fails outside the repository
    line = smi_line()
    host = {}
    for mod in ("msgpack", "zstandard", "google_crc32c"):
        try:
            importlib.import_module(mod)
            host[mod] = True
        except ImportError:
            host[mod] = False
    from repro_torch.core import quantizers

    quantizers.check_numpy_sum_order()  # raises where blobs would not be the JAX package's
    emit(
        "environment",
        nvidia_smi=line,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        python=sys.version.split()[0],
        numpy=np.__version__,
        host_packages=host,
        numpy_sum_order="pairwise (probed)",
        host_crc32c_numpy_MBps=host_crc32c_rate(),
    )
    return line


def _kernel_modules():
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.fastmode import kernel as FK
    from repro_torch.kernels.huffman import kernel as HK
    from repro_torch.kernels.kvquant import kernel as KK
    from repro_torch.kernels.lorenzo import kernel as LK
    from repro_torch.kernels.transform import kernel as TK

    return {"lorenzo": LK, "transform": TK, "fastmode": FK, "kvquant": KK, "bitplane": BK, "huffman": HK}


def _declare_transform_baseline(lib) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.transform_f32.argtypes = [p, p, i64, i64, p, i32, p]
    lib.transform_f32.restype = ctypes.c_int


@functools.cache
def transform_baseline():
    """The transform rotation's first design (float32 only), built like the
    port's sources into ``tools/build/``; no path of the port calls it."""
    from repro_torch.kernels._build import CudaLibrary

    return CudaLibrary(ROOT / _TRANSFORM_BASELINE_SRC, "transform_baseline", _declare_transform_baseline)


def phase_build() -> None:
    """Build the six CUDA sources and the transform's baseline at once: one
    nvcc process each."""
    mods = dict(_kernel_modules(), transform_baseline=transform_baseline())
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        paths = dict(zip(mods, pool.map(lambda m: m.build(), mods.values())))
    for m in mods.values():
        m.load()
    emit(
        "build",
        seconds=time.perf_counter() - t0,
        libraries={k: str(v.relative_to(ROOT)) for k, v in paths.items()},
    )


def reset_all_launches() -> None:
    for m in _kernel_modules().values():
        m.reset_launches()


def all_launches() -> dict:
    """Launch counts under the summary's kernel names: the kernels that
    replace TPU kernels.  The Huffman pack, which every path coding its
    codes on the card launches, is counted in its own phase."""
    mods = _kernel_modules()
    out = dict(mods["lorenzo"].LAUNCHES)
    out.update({f"transform_{k}": v for k, v in mods["transform"].LAUNCHES.items()})
    out.update(mods["fastmode"].LAUNCHES)
    out.update(mods["kvquant"].LAUNCHES)
    out.update({f"bitplane_{k}": v for k, v in mods["bitplane"].LAUNCHES.items()})
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit identity, with any NaN equal to any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    both_nan = torch.isnan(a) & torch.isnan(b)
    return bool((both_nan | (a.view(ints) == b.view(ints))).all())


def max_abs_diff(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        d = (a.double() - b.double()).abs()
        d = d[torch.isfinite(d)]
        if d.numel():
            err = max(err, float(d.max()))
    return err


def bound(n_bytes: float, n_ops: float, bw: float, rate: float = _ALU_RATE) -> dict:
    bytes_ms = n_bytes / bw * 1e3
    ops_ms = n_ops / rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _kernel_case(timer, name, shape, x_or_d, eb, bw):
    from repro_torch.kernels.lorenzo import kernel as K
    from repro_torch.kernels.lorenzo import ref as R

    kfn, rfn = getattr(K, name), getattr(R, name)
    args = (x_or_d, eb, 32768) if name.startswith("encode") else (x_or_d, eb)
    got = kfn(*args)
    torch.cuda.synchronize()
    want = rfn(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    if name == "decode_1d":
        lib = lambda: torch.cumsum(x_or_d, dim=1, dtype=torch.int32)  # noqa: E731
    elif name == "decode_2d":
        lib = lambda: torch.cumsum(torch.cumsum(x_or_d, dim=1, dtype=torch.int32), dim=0, dtype=torch.int32)  # noqa: E731
    else:
        lib = None
    n = x_or_d.numel()
    return {
        "name": name,
        "shape": list(shape),
        "eb": eb,
        "bit_identical": equal,
        "max_abs_err": err,
        "kernel_ms": timer(lambda: kfn(*args)),
        "plain_ms": timer(lambda: rfn(*args)),
        "library_ms": timer(lib) if lib is not None else None,
        **bound(_BYTES_PER_ELEM[name] * n, _OPS_PER_ELEM[name] * n, bw),
    }


#: the chunked engine's chunk shapes: 4 MiB chunks cut the 1800x3600 field
#: into six (291, 3600) and one (54, 3600), the series into (1, 2^20)
CHUNK_2D = [(291, 3600), (54, 3600)]
CHUNK_1D = (1, 1 << 20)
#: repetitions of a chunk-shape timing: at ~15 us a call the spread of 15
#: is as large as the differences sought
CHUNK_REPS = 101
#: the transform's chunk shapes in the ``checkpoint`` phase (Qwen1.5-0.5B's
#: moments): a 4 MiB chunk of the embedding's (151936, 1024), and the 1-row
#: chunks of the stacked blocks, padded to 4 rows (attention, MLP)
TRANSFORM_CHUNKS = {"chunk": (1024, 1024), "row_chunk_attn": (4, 1 << 20), "row_chunk": (4, 1024 * 2816)}


def _chunk_fields(case: dict) -> dict:
    """A chunk-shape case's numbers, as fields beside the main case's."""
    return {
        "chunk_shape": case["shape"],
        "chunk_ms": case["kernel_ms"],
        "chunk_plain_ms": case["plain_ms"],
        "chunk_library_ms": case["library_ms"],
        "chunk_bound_ms": case["bound_ms"],
    }


def _decode_equal(name: str, d: torch.Tensor, eb: float) -> None:
    """One decode kernel against its plain version, bit for bit, untimed."""
    from repro_torch.kernels.lorenzo import kernel as K
    from repro_torch.kernels.lorenzo import ref as R

    got = getattr(K, name)(d, eb)
    torch.cuda.synchronize()
    if not torch.equal(got, getattr(R, name)(d, eb)):
        raise AssertionError(f"{name} at {tuple(d.shape)} differs from its plain version")


def _encode_equal(name: str, x: torch.Tensor, eb: float, radius: int = 32768) -> None:
    """One encode kernel against its plain version, bit for bit, untimed."""
    from repro_torch.kernels.lorenzo import kernel as K
    from repro_torch.kernels.lorenzo import ref as R

    got = getattr(K, name)(x, eb, radius)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, getattr(R, name)(x, eb, radius))):
        raise AssertionError(f"{name} at {tuple(x.shape)} (eb {eb}, radius {radius}) differs from its plain version")


#: the encodes' edge shapes: widths under 4 (4-byte accesses), rows one past
#: a warp's span (256 elements in 1d, 128 columns in 2d), rows that end
#: inside a strip, one row or column in 2d mode
ENCODE_EDGES = [(5000, 1), (5000, 3), (40, 1), (40, 3), (3, 257), (2, 4097), (2, 4099), (17, 132), (33, 129),
                (65, 129), (1, 4099), (1, 5000)]


def tie_field(shape, eb: float, g) -> torch.Tensor:
    """Values whose x * f32(1/(2eb)) is exactly k + 1/2 (rint rounds them to
    even), magnitudes just under 2^22 * 2eb (the pipeline's safe limit),
    and +-2^30 neighbours whose diffs are INT32_MIN; eb is a power of two."""
    inv = 1.0 / (2.0 * eb)
    q = torch.randint(-1000, 1000, shape, generator=g, device="cuda", dtype=torch.float64) + 0.5
    q[0, :8] = torch.tensor([2**22 - 0.5, -(2**22 - 0.5), 2**22 - 1.5, 2.0**30, -(2.0**30), 2.0**30, 2.5, -3.5],
                            dtype=torch.float64)
    return (q / inv).to(torch.float32)


def encode_edges(g) -> None:
    """Both encodes, untimed, on the edge shapes, on contiguous views 4, 8
    and 12 bytes past an aligned base (the 4-byte variant) and on tie values."""
    checked = {"shapes": [], "misaligned": [], "ties": []}
    for name in ("encode_1d", "encode_2d"):
        for shape in ENCODE_EDGES:
            _encode_equal(name, torch.cumsum(torch.randn(shape, generator=g, device="cuda"), dim=1), 1e-3)
            checked["shapes"].append([name, *shape])
        for shape, off in (((300, 400), 1), ((1, 40000), 1), ((33, 129), 2), ((291, 3600), 3)):
            n = shape[0] * shape[1]
            base = torch.cumsum(torch.randn(n + off, generator=g, device="cuda"), dim=0)
            x = base[off:].reshape(shape)
            if x.data_ptr() % 16 == 0:
                raise AssertionError("the misaligned view is aligned")
            _encode_equal(name, x, 1e-3)
            checked["misaligned"].append([name, *shape, 4 * off])
        for eb in (0.5, 2.0**-11):
            for radius in (32768, 2**31 - 1):
                _encode_equal(name, tie_field((9, 261), eb, g), eb, radius)
            checked["ties"].append([name, eb])
    emit("kernel encode checks", bit_identical=True, **checked)


def wrapping_diffs(shape) -> torch.Tensor:
    """Raw diffs whose running sums wrap int32 many times over."""
    d = torch.full(shape, 2**30, dtype=torch.int32, device="cuda")
    d[1::2] = -(2**30) - 7
    d[2::3, ::3] = 2**31 - 1
    return d


def lorenzo_kernels(timer, g, bw: float) -> dict:
    from repro_torch.kernels.lorenzo import ref as R

    chunk_timer = Timer(reps=CHUNK_REPS, warmup=5)
    cases = {}
    # 1d: the series, rows, the chunked engine's chunk (1, 2^20) and rows
    # whose starts are not 16-byte aligned (the scan's 4-byte loads)
    shapes = {"2d": [SHAPE2D, (1801, 3599), *CHUNK_2D], "1d": [(1, N1D), (300, 1000), CHUNK_1D, (5, 8197)]}
    eb = 1e-3
    for mode, mode_shapes in shapes.items():
        for shape in mode_shapes:
            x = torch.cumsum(torch.randn(shape, generator=g, device="cuda"), dim=1)
            _, d = getattr(R, f"encode_{mode}")(x, eb, 32768)
            for name, arg in ((f"encode_{mode}", x), (f"decode_{mode}", d)):
                chunk = shape in CHUNK_2D or shape == CHUNK_1D
                case = _kernel_case(chunk_timer if chunk else timer, name, shape, arg, eb, bw)
                emit(f"kernel {name} {shape[0]}x{shape[1]}", **case)
                if not case["bit_identical"]:
                    raise AssertionError(f"{name} at {shape} differs from its plain version")
                cases.setdefault(name, case)  # first shape is the main path's
                if chunk and "chunk_ms" not in cases[name]:
                    cases[name].update(_chunk_fields(case))
    # decode_2d on a single row or column, two rows, ragged tiles
    for shape in ((1, 5000), (5000, 1), (2, 4099), (65, 129)):
        _decode_equal("decode_2d", torch.randint(-5000, 5000, shape, generator=g, device="cuda",
                                                 dtype=torch.int32), eb)
    # running sums that wrap int32 many times over
    case = _kernel_case(timer, "decode_1d", (3, 70001), wrapping_diffs((3, 70001)), 0.5, bw)
    emit("kernel decode_1d int32-wrapping sums 3x70001", **case)
    if not case["bit_identical"]:
        raise AssertionError("decode_1d on wrapping sums differs from its plain version")
    for shape in ((3, 70001), (300, 1000)):
        _decode_equal("decode_2d", wrapping_diffs(shape), 0.5)
    emit("kernel decode_2d checks", shapes=[[1, 5000], [5000, 1], [2, 4099], [65, 129]],
         wrapping=[[3, 70001], [300, 1000]], bit_identical=True)
    encode_edges(g)
    return cases


def _check_case(label: str, case: dict) -> dict:
    emit(f"kernel {label}", **case)
    if not case["bit_identical"]:
        raise AssertionError(f"{label} differs from its plain version")
    return case


def transform_kernels(timer, bw: float, x2d: torch.Tensor, x1d: torch.Tensor) -> dict:
    """fwd/inv at the main paths' padded shapes (the 2-D field in 2d mode,
    the series as one (1, N) row in 1d mode) and at ragged whole-block
    shapes, then the float64 axis product on the main paths' fields."""
    from repro_torch.kernels.transform import kernel as K
    from repro_torch.kernels.transform import ref as R

    torch.backends.cuda.matmul.allow_tf32 = False  # library yardsticks in full float32
    mat32 = torch.tensor(R.MAT, dtype=torch.float32, device="cuda")
    cases = {}
    rows1d = x1d.reshape(1, -1)
    g = torch.Generator(device="cuda").manual_seed(5)
    ragged = {"2d": (1804, 3596), "1d": (3, 44)}
    for mode, main in (("2d", x2d), ("1d", rows1d)):
        for which, x in (("main", main), ("ragged", torch.randn(ragged[mode], generator=g, device="cuda") * 100)):
            c_plain = R.fwd(x, mode)
            for name, kfn, rfn, arg, m in (
                ("fwd", K.fwd, R.fwd, x, mat32), ("inv", K.inv, R.inv, c_plain, mat32.T.contiguous()),
            ):
                got = kfn(arg, mode)
                torch.cuda.synchronize()
                want = rfn(arg, mode)
                n = arg.numel()
                if mode == "1d":
                    lib = lambda a=arg, m=m: torch.matmul(a.reshape(-1, 4), m.T)  # noqa: E731
                else:
                    rows, cols = arg.shape
                    lib = lambda a=arg, m=m, r=rows, c=cols: torch.einsum(  # noqa: E731
                        "kj,pjql,ml->pkqm", m, a.reshape(r // 4, 4, c // 4, 4), m)
                case = {
                    "name": f"transform_{name}_{mode}",
                    "shape": list(arg.shape),
                    "bit_identical": same_bits(got, want),
                    "max_abs_err": max_abs_diff([(got, want)]),
                    "kernel_ms": timer(lambda: kfn(arg, mode)),
                    "plain_ms": timer(lambda: rfn(arg, mode)),
                    "library_ms": timer(lib),
                    **bound(8 * n, (14 if mode == "2d" else 7) * n, bw),
                }
                _check_case(f"transform_{name}_{mode} {which} {arg.shape[0]}x{arg.shape[1]}", case)
                if which == "main":
                    cases[f"transform_{name}_{mode}"] = case
    # the checkpoint's chunk shapes, where nearly all of the transform's
    # launches are: 4 MiB chunks (1024, 1024) of a (rows, 1024) moment, and
    # 1-row chunks of a stacked two-layer moment, which the coder pads to 4
    # rows (one layer's attention and MLP weights: 1024x1024, 1024x2816)
    chunk_timer = Timer(reps=CHUNK_REPS, warmup=5)
    for label, shape in TRANSFORM_CHUNKS.items():
        x = torch.randn(shape, generator=g, device="cuda") * 100
        rows, cols = shape
        for name, kfn, rfn, arg, m in (
            ("fwd", K.fwd, R.fwd, x, mat32), ("inv", K.inv, R.inv, R.fwd(x, "2d"), mat32.T.contiguous()),
        ):
            got = kfn(arg, "2d")
            torch.cuda.synchronize()
            want = rfn(arg, "2d")
            n = arg.numel()
            case = {
                "name": f"transform_{name}_2d",
                "shape": list(shape),
                "bit_identical": same_bits(got, want),
                "max_abs_err": max_abs_diff([(got, want)]),
                "kernel_ms": chunk_timer(lambda: kfn(arg, "2d")),
                "plain_ms": chunk_timer(lambda: rfn(arg, "2d")),
                "library_ms": chunk_timer(lambda a=arg, m=m: torch.einsum(
                    "kj,pjql,ml->pkqm", m, a.reshape(rows // 4, 4, cols // 4, 4), m)),
                **bound(8 * n, 14 * n, bw),
            }
            _check_case(f"transform_{name}_2d {label} {rows}x{cols}", case)
            if label in ("chunk", "row_chunk"):  # chunk_* and row_chunk_* fields of the summary
                prefix = "" if label == "chunk" else "row_"
                cases[f"transform_{name}_2d"].update({prefix + k: v for k, v in _chunk_fields(case).items()})
    # the float64 product: the kernel on the card against numpy on the host,
    # along every axis of the main paths' padded fields and of fields with an
    # axis of exactly 4 (numpy's BLAS dgemv orders), both matrices
    g64 = torch.Generator(device="cuda").manual_seed(6)
    fields = [("2-D", x2d.double()), ("1-D", x1d.double())] + [
        ("x".join(map(str, s)), torch.randn(s, generator=g64, device="cuda", dtype=torch.float64) * 100)
        for s in ((4, 5000), (5000, 4), (8, 4, 16))
    ]
    for label, x in fields:
        for ax in range(x.ndim - 1, -1, -1):
            for mname, m in (("MAT", R.MAT), ("MAT^T", R.MAT.T)):
                order = R.numpy_rounding(tuple(x.shape), ax, m)
                if order is None:
                    raise AssertionError(f"numpy's float64 product along axis {ax} of {label} ({mname}) is in none of {R.ORDERS}")
                got = K.axis_f64(x, m, ax)
                torch.cuda.synchronize()
                x_host = x.cpu()
                t0 = time.perf_counter()
                want = R.apply_axis_f64(x_host, m, ax)
                plain_ms = (time.perf_counter() - t0) * 1e3
                mt = torch.tensor(m, device="cuda")
                n = x.numel()
                moved = x.movedim(ax, -1).contiguous()
                case = {
                    "name": "transform_axis_f64",
                    "shape": list(x.shape),
                    "axis": ax,
                    "matrix": mname,
                    "order": order,
                    "bit_identical": same_bits(got.cpu(), want),
                    "max_abs_err": max_abs_diff([(got.cpu(), want)]),
                    "kernel_ms": timer(lambda: K.axis_f64(x, m, ax)),
                    "plain_ms": plain_ms,
                    "plain_runs_on": "host (numpy)",
                    "library_ms": timer(lambda: torch.matmul(moved.reshape(-1, 4), mt.T)),
                    **bound(16 * n, 7 * n, bw, _F64_RATE),
                }
                _check_case(f"transform_axis_f64 {label} axis {ax} {mname}", case)
                if label == "2-D" and ax == 1 and mname == "MAT^T":
                    cases["transform_axis_f64"] = case
    for name, turns in transform_turns(bw).items():
        cases[name].update(turns)
    return cases


#: where the rotation is timed in turns: (label, mode, shape), the
#: checkpoint's chunks and the main paths' padded shapes
TRANSFORM_TURNS = (
    ("chunk", "2d", TRANSFORM_CHUNKS["chunk"]),
    ("row_chunk_attn", "2d", TRANSFORM_CHUNKS["row_chunk_attn"]),
    ("row_chunk", "2d", TRANSFORM_CHUNKS["row_chunk"]),
    ("main", "2d", SHAPE2D),
    ("main", "1d", (1, N1D + 1)),
)
#: summary-field prefix of each label's turns
_TURN_PREFIX = {"main": "", "chunk": "chunk_", "row_chunk": "row_chunk_"}


def baseline_rotate(x: torch.Tensor, mat: np.ndarray, mode: str) -> torch.Tensor:
    """The baseline kernel on a contiguous float32 CUDA tensor."""
    from repro_torch.kernels._build import check_launch, stream

    lib = transform_baseline().load()
    out = torch.empty_like(x)
    rows, cols = x.shape
    err = lib.transform_f32(x.data_ptr(), out.data_ptr(), rows, cols, mat.ctypes.data, int(mode == "2d"), stream())
    check_launch(err, "transform baseline")
    return out


def in_turns(timer, old, new) -> tuple:
    """Median times of ``old`` and ``new``, each taken twice, in the order
    old, new, new, old."""
    first, n1, n2, last = timer(old), timer(new), timer(new), timer(old)
    return [first, last], [n1, n2]


def transform_turns(bw: float) -> dict:
    """At each of ``TRANSFORM_TURNS``: the rotation bit for bit against its
    plain version for every pair of float32 and float64 input and output
    (float64 values that float32 does not hold), the baseline kernel's
    float32 result bit for bit too; then, L2 flushed, the rotation against
    the baseline (float32 in and out) and the coder's float64 stage, one
    launch, against the stage it replaced (cast to float32, the baseline,
    cast back), each in turns.  Returns summary fields by case name."""
    from repro_torch.kernels.transform import kernel as K
    from repro_torch.kernels.transform import ref as R

    timer = Timer(reps=CHUNK_REPS, warmup=5)
    g = torch.Generator(device="cuda").manual_seed(7)
    f32, f64 = torch.float32, torch.float64
    fields: dict = {}
    for label, mode, shape in TRANSFORM_TURNS:
        x64 = torch.randn(shape, generator=g, device="cuda", dtype=f64) * (100 / 3)
        x32 = x64.to(f32)
        rows, cols = shape
        n = x64.numel()
        ops = (14 if mode == "2d" else 7) * n
        for name, kfn, rfn, mat in (("fwd", K.fwd, R.fwd, K._FWD), ("inv", K.inv, R.inv, K._INV)):
            what = f"transform_{name}_{mode} {label} {rows}x{cols}"
            for src in (x32, x64):
                for dst in (f32, f64):
                    got = kfn(src, mode, out_dtype=dst)
                    torch.cuda.synchronize()
                    if not same_bits(got, rfn(src, mode, out_dtype=dst)):
                        raise AssertionError(f"{what}: {src.dtype} in, {dst} out differs from the plain version")
            if not same_bits(baseline_rotate(x32, mat, mode), kfn(x32, mode)):
                raise AssertionError(f"{what}: the baseline kernel's bits differ")
            parent_ms, ms = in_turns(timer, lambda: baseline_rotate(x32, mat, mode), lambda: kfn(x32, mode))
            old_stage_ms, stage_ms = in_turns(
                timer, lambda: baseline_rotate(x64.to(f32), mat, mode).to(f64), lambda: kfn(x64, mode, out_dtype=f64))
            kb, sb = bound(8 * n, ops, bw), bound(16 * n, ops, bw)
            line = {
                "shape": [rows, cols], "mode": mode, "dtype_pairs_bit_identical": True,
                "parent_ms": parent_ms, "ms": ms, "bound_ms": kb["bound_ms"], "bound_by": kb["bound_by"],
                "old_stage_ms": old_stage_ms, "stage_ms": stage_ms, "stage_bound_ms": sb["bound_ms"],
                "stage_bound_by": sb["bound_by"],
                "bound_share": kb["bound_ms"] / statistics.mean(ms),
                "parent_bound_share": kb["bound_ms"] / statistics.mean(parent_ms),
                "stage_bound_share": sb["bound_ms"] / statistics.mean(stage_ms),
                "old_stage_bound_share": sb["bound_ms"] / statistics.mean(old_stage_ms),
            }
            emit(f"transform turns {what}", **line)
            if label in _TURN_PREFIX:
                pre = _TURN_PREFIX[label]
                fields.setdefault(f"transform_{name}_{mode}", {}).update({
                    pre + "parent_ms": statistics.mean(parent_ms),
                    pre + "stage_ms": statistics.mean(stage_ms),
                    pre + "old_stage_ms": statistics.mean(old_stage_ms),
                    pre + "stage_bound_ms": sb["bound_ms"],
                })
    return fields


def block_stats_kernels(timer, bw: float, x2d: torch.Tensor, x1d: torch.Tensor) -> dict:
    from repro_torch.core import fastmode as FM
    from repro_torch.kernels.fastmode import kernel as K
    from repro_torch.kernels.fastmode import ref as R

    cases = {}
    for label, x in (("2-D", x2d), ("1-D", x1d)):
        for bs in (256, 128):
            xb = FM._pad_blocks_1d(x.reshape(-1), bs)[0]
            got = K.block_stats(xb)
            torch.cuda.synchronize()
            want = R.block_stats(xb)
            nb = xb.shape[0]
            case = {
                "name": "block_stats",
                "shape": list(xb.shape),
                "bit_identical": all(same_bits(a, b) for a, b in zip(got, want)),
                "max_abs_err": max_abs_diff(zip(got, want)),
                "kernel_ms": timer(lambda: K.block_stats(xb)),
                "plain_ms": timer(lambda: R.block_stats(xb)),
                "library_ms": None,
                **bound(4 * xb.numel() + 8 * nb, 4 * xb.numel(), bw),
            }
            _check_case(f"block_stats {label} {nb}x{bs}", case)
            if label == "2-D" and bs == 256:
                cases["block_stats"] = case
    # the throughput tier's 2^20-element chunks, timed over more repetitions
    chunk_timer = Timer(reps=CHUNK_REPS, warmup=5)
    xb = FM._pad_blocks_1d(x1d[: 1 << 20], 256)[0]
    got, want = K.block_stats(xb), R.block_stats(xb)
    chunk = {
        "shape": list(xb.shape),
        "bit_identical": all(same_bits(a, b) for a, b in zip(got, want)),
        "kernel_ms": chunk_timer(lambda: K.block_stats(xb)),
        "plain_ms": chunk_timer(lambda: R.block_stats(xb)),
        "library_ms": None,
        **bound(4 * xb.numel() + 8 * xb.shape[0], 4 * xb.numel(), bw),
    }
    emit(f"kernel block_stats chunk {xb.shape[0]}x256", **chunk)
    if not chunk["bit_identical"]:
        raise AssertionError("block_stats at the chunk shape differs from its plain version")
    cases["block_stats"].update(_chunk_fields(chunk))
    # one block, 8k + 3 blocks, and NaN, +inf, -inf inside blocks and as
    # whole blocks: the kernel and its plain version agree
    gen = torch.Generator(device="cuda").manual_seed(16)
    for nb, bs in ((1, 256), (1, 128), (8003, 256), (8003, 128), (4096, 256)):
        xb = torch.randn((nb, bs), generator=gen, device="cuda")
        xb[nb // 2, 3] = float("nan")
        if nb > 3:
            xb[7, 3], xb[100 % nb, 5], xb[200 % nb, :] = float("nan"), float("inf"), 3.0
            xb[nb - 1, 9], xb[nb - 2, :], xb[nb - 3, :] = float("-inf"), float("nan"), float("-inf")
        got, want = K.block_stats(xb), R.block_stats(xb)
        if not all(same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"block_stats {nb}x{bs} with nan/inf differs from its plain version")
    emit("kernel block_stats checks", shapes=[[1, 256], [1, 128], [8003, 256], [8003, 128], [4096, 256]],
         non_finite=True, bit_identical=True)
    return cases


def v_cache(shape, seed: int) -> torch.Tensor:
    """A float32 stand-in for a V cache made on the card: unit-normal values
    with a per-channel scale spread over e^-2..e^2, as projected heads have."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    spread = torch.exp(4 * torch.rand((1, shape[-1]), generator=g, device="cuda") - 2)
    return torch.randn(shape, generator=g, device="cuda") * spread


def attention_rows(rows: int, keys: int, seed: int) -> torch.Tensor:
    """Softmax rows over ``keys`` positions: what reads the V cache."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.softmax(2 * torch.randn((rows, keys), generator=g, device="cuda"), dim=-1)


def f64_matmul_check(out: torch.Tensor, a: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> float:
    """max |out - A @ deq| / ((K+2) 2^-24 (|A| @ |deq|)) against a float64
    product on the card: the textbook bound of a float32 dot product of K
    terms in any order; above 1 the product is wrong."""
    deq = q.double() * s.double()[None, :]
    a64 = a.double()
    tol = (a.shape[1] + 2) * 2.0**-24 * (a64.abs() @ deq.abs())
    ratio = (out.double() - a64 @ deq).abs() / tol.clamp_min(torch.finfo(torch.float64).tiny)
    return float(ratio.max())


def dequant_matmul_edges(K, R, a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, label: str) -> None:
    """The tensor-core matmul on rows with NaN and infinities (non-finite
    outputs where the plain version's are, the finite rows within the
    float64 bound) and on rows near 2^-100 and 2^100 (within the bound)."""
    M, Kd = a.shape
    bad = a.clone()
    bad[0, Kd // 2] = float("nan")
    bad[1, 0] = float("inf")
    bad[2, Kd - 1] = float("-inf")
    bad[3, 0], bad[3, Kd - 1] = float("inf"), float("-inf")
    bad[4, Kd // 3] = torch.tensor([0x7F800001], dtype=torch.int32).view(torch.float32)[0]  # NaN, low payload
    out, plain = K.dequant_matmul(bad, q, scale), R.dequant_matmul(bad, q, scale)
    torch.cuda.synchronize()
    same_pattern = all(torch.equal(f(out), f(plain)) for f in (
        torch.isfinite, torch.isnan, lambda t: torch.isinf(t) & (t > 0)))
    finite_ratio = f64_matmul_check(out[5:], bad[5:], q, scale)
    emit(f"kernel dequant_matmul non-finite rows {label} {M}x{Kd}x{q.shape[1]}",
         nonfinite_pattern_equal=same_pattern, finite_rows_err_over_f64_bound=finite_ratio)
    if not (same_pattern and finite_ratio <= 1):
        raise AssertionError(f"dequant_matmul at {M}x{Kd}: non-finite rows differ from the plain "
                             f"version's ({same_pattern}) or the finite rows miss the bound ({finite_ratio})")
    rows = torch.arange(M, device=a.device)[:, None]
    ext = a * Kd * torch.where(rows % 2 == 0, 2.0**-100, 2.0**100)  # around 2^-100 and 2^100
    out = K.dequant_matmul(ext, q, scale)
    torch.cuda.synchronize()
    ratio = f64_matmul_check(out, ext, q, scale)
    finite = bool(torch.isfinite(out).all())
    emit(f"kernel dequant_matmul 2^-100/2^100 rows {label} {M}x{Kd}x{q.shape[1]}",
         err_over_f64_bound=ratio, finite=finite)
    if not (finite and ratio <= 1):
        raise AssertionError(f"dequant_matmul at {M}x{Kd}: tiny and large rows give {ratio} of the bound")


#: rows against q = 1 (K = 32, N = 16) and what the tensor cores sum minus
#: 2^24: each step aligns its addends to the largest, keeps 2 bits below its
#: ulp and cuts toward zero (round to nearest would give 12, 2, 12, 0, 4)
ACC_ROWS = (
    ([2.0**24] + [0.0] * 15 + [0.75] * 16, 8.0),
    ([2.0**24] + [0.0] * 15 + [1.5] + [0.0] * 15, 0.0),
    ([2.0**24] + [0.75] * 15 + [0.0] * 16, 6.0),
    ([2.0**24, -0.25] + [0.0] * 30, 0.0),
    ([2.0**24] + [0.0] * 15 + [0.25] * 16, 0.0),
)


def dequant_matmul_accumulation(K, R, q_kv: torch.Tensor, s_kv: torch.Tensor, seed: int) -> None:
    """The tensor cores' accumulator on the probe rows and on softmax rows,
    bit for bit against the model the source note counts its worst case
    on; then 2048 rows of
    softmax weights at K = 32768, which ``split_k`` runs in one split (one
    pair of accumulators, promoted every 128 of K), against positive codes
    and the V cache's, within the float64 bound."""
    a = torch.tensor([r for r, _ in ACC_ROWS], device="cuda")
    q, s = torch.ones((32, 16), dtype=torch.int8, device="cuda"), torch.ones(16, device="cuda")
    got = K.dequant_matmul(a, q, s)
    model = R.tensor_core_dequant_matmul(a, q, s, *K.split_k(*a.shape, 16))
    sums = (got[:, 0].double() - 2.0**24).tolist()
    emit("kernel dequant_matmul accumulator rows", sums_minus_2_24=sums, model_equal=torch.equal(got, model))
    if not (torch.equal(got, model) and sums == [v for _, v in ACC_ROWS]):
        raise AssertionError(f"dequant_matmul: the accumulator summed {sums}, not as the model does")
    a = attention_rows(KV_QUERIES, 4096, seed + 3)  # 16 splits, each promoted once
    q, s = q_kv[:4096].contiguous(), s_kv
    got = K.dequant_matmul(a, q, s)
    model = R.tensor_core_dequant_matmul(a, q, s, *K.split_k(*a.shape, q.shape[1]))
    emit(f"kernel dequant_matmul against the accumulator model {KV_QUERIES}x4096x{q.shape[1]}",
         split_k=list(K.split_k(*a.shape, q.shape[1])), differing=int((got != model).sum()))
    if not torch.equal(got, model):
        raise AssertionError("dequant_matmul: softmax rows sum otherwise than the accumulator model")
    M, (Kd, N) = 2048, q_kv.shape
    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    a = attention_rows(M, Kd, seed + 2)
    q_pos = torch.randint(1, 128, (Kd, N), generator=g, device="cuda", dtype=torch.int8)
    for codes, qq, ss in (("positive", q_pos, s_kv), ("v cache", q_kv, s_kv)):
        out = K.dequant_matmul(a, qq, ss)
        torch.cuda.synchronize()
        ratio = f64_matmul_check(out, a, qq, ss)
        emit(f"kernel dequant_matmul one split {codes} codes {M}x{Kd}x{N}",
             split_k=list(K.split_k(M, Kd, N)), err_over_f64_bound=ratio)
        if not (K.split_k(M, Kd, N)[1] == 1 and ratio <= 1):
            raise AssertionError(f"dequant_matmul in one split at {M}x{Kd}x{N}: {ratio} of the bound")
        del out


def kvquant_kernels(timer, bw: float, seed: int) -> dict:
    """absmax and quantize_with_scale bit for bit, dequant_matmul within the
    float64 bound, at the KV path's shapes and ragged ones."""
    from repro_torch.kernels.kvquant import kernel as K
    from repro_torch.kernels.kvquant import ref as R

    torch.backends.cuda.matmul.allow_tf32 = False  # library yardstick in full float32
    cases = {}
    T, C = QWEN["context"], QWEN["kv_heads"] * QWEN["hd"]
    for label, shape in (("main", (T, C)), ("ragged", (300, 96)), ("ragged", (33, 200))):
        x = v_cache(shape, seed + shape[0])
        n = x.numel()
        amax = K.absmax(x)
        torch.cuda.synchronize()
        want = R.absmax(x)
        case = {
            "name": "absmax",
            "shape": list(shape),
            "bit_identical": same_bits(amax, want),
            "max_abs_err": max_abs_diff([(amax, want)]),
            "kernel_ms": timer(lambda: K.absmax(x)),
            "plain_ms": timer(lambda: R.absmax(x)),
            "library_ms": timer(lambda: torch.amax(x.abs(), 0)),
            **bound(4 * n + 4 * shape[1], 2 * n, bw),
        }
        _check_case(f"absmax {label} {shape[0]}x{shape[1]}", case)
        scale = R.scale_from_absmax(amax)
        q = K.quantize_with_scale(x, scale)
        torch.cuda.synchronize()
        want_q = R.quantize_with_scale(x, scale)
        qcase = {
            "name": "quantize_with_scale",
            "shape": list(shape),
            "bit_identical": torch.equal(q, want_q),
            "max_abs_err": max_abs_diff([(q, want_q)]),
            "kernel_ms": timer(lambda: K.quantize_with_scale(x, scale)),
            "plain_ms": timer(lambda: R.quantize_with_scale(x, scale)),
            "library_ms": None,
            **bound(5 * n + 4 * shape[1], 4 * n, bw),
        }
        _check_case(f"quantize_with_scale {label} {shape[0]}x{shape[1]}", qcase)
        rows = KV_QUERIES if label == "main" else 48
        a = attention_rows(rows, shape[0], seed + 1)
        out = K.dequant_matmul(a, q, scale)
        torch.cuda.synchronize()
        plain = R.dequant_matmul(a, q, scale)
        kernel_ratio, plain_ratio = f64_matmul_check(out, a, q, scale), f64_matmul_check(plain, a, q, scale)
        M, Kd, N = rows, shape[0], shape[1]
        mcase = {
            "name": "dequant_matmul",
            "shape": [M, Kd, N],
            "split_k": list(K.split_k(M, Kd, N)),
            "err_over_f64_bound": kernel_ratio,
            "plain_err_over_f64_bound": plain_ratio,
            "max_abs_err": max_abs_diff([(out, plain)]),
            "kernel_ms": timer(lambda: K.dequant_matmul(a, q, scale)),
            "plain_ms": timer(lambda: R.dequant_matmul(a, q, scale)),
            "library_ms": timer(lambda: torch.matmul(a, q.float() * scale)),
            # three bf16 products per multiply-add, on the tensor cores
            **bound(4 * M * Kd + Kd * N + 4 * N + 4 * M * N, 3 * 2 * M * N * Kd, bw, _BF16_TC_RATE),
            "bound_rate": "bf16 tensor cores, 989 TFLOP/s",
            "f32_alu_bound_ms": 2 * M * N * Kd / _ALU_RATE * 1e3,
        }
        emit(f"kernel dequant_matmul {label} {M}x{Kd}x{N}", **mcase)
        if not (kernel_ratio <= 1 and plain_ratio <= 1):
            raise AssertionError(f"dequant_matmul at {M}x{Kd}x{N}: error over the float64 bound "
                                 f"{kernel_ratio} (kernel), {plain_ratio} (plain)")
        dequant_matmul_edges(K, R, a, q, scale, label)
        if label == "main":
            dequant_matmul_accumulation(K, R, q, scale, seed)
            cases.update({"absmax": case, "quantize_with_scale": qcase, "dequant_matmul": mcase})
    # NaN, inf and all-zero columns: bit for bit with the plain versions
    x = v_cache((4096, 256), seed + 9)
    x[:, 1] = 0.0
    x[100, 2] = float("nan")
    x[:, 3] = float("nan")
    x[7, 4] = float("inf")
    amax, want = K.absmax(x), R.absmax(x)
    scale = R.scale_from_absmax(amax)
    if not (same_bits(amax, want) and torch.equal(K.quantize_with_scale(x, scale), R.quantize_with_scale(x, scale))):
        raise AssertionError("absmax/quantize_with_scale with nan, inf or zero columns differ from their plain versions")
    emit("kernel kvquant nan/inf/zero columns", shape=[4096, 256], bit_identical=True,
         nan_scale=bool(torch.isnan(scale[2]) and torch.isnan(scale[3])), zero_column_scale=float(scale[1]))
    cases["quantize_append"] = append_kernels(bw, seed)
    return cases


#: granite-3-8b's int8 append at the serve phase's batch: (B, KV, hd), and
#: the ring of its 16 tokens + 8
APPEND_MAIN, APPEND_W = (4, 8, 128), 24
#: untimed shapes of the append: every head size the configs use (whisper
#: 64, zamba2 112, the rest 128), odd ones, and 2 x 64 x 8 rows
APPEND_EDGES = [(4, 12, 64), (4, 32, 112), (2, 4, 128), (1, 1, 128), (3, 5, 33), (64, 8, 128)]


def append_bound(B: int, KV: int, hd: int, elem: int, bw: float) -> dict:
    """K and V read once (``elem`` bytes a value) with the slot, codes and
    scales written once; per value |x|, max, divide, rint and clamp."""
    n, rows = 2 * B * KV * hd, 2 * B * KV
    return bound(n * elem + 8 + n + 4 * rows, 5 * n + rows, bw)


def append_edge_rows(x: torch.Tensor, g) -> None:
    """Rows of x (..., hd), in place: NaN, all zero (with -0.0), rint ties
    (scale 0.125 exactly), +inf, -inf, subnormal, floored at 1e-8."""
    rows = x.view(-1, x.shape[-1])
    hd = rows.shape[1]
    n = torch.arange(hd, device=x.device) % 127
    sign = 1 - 2 * (torch.arange(hd, device=x.device) % 2)
    edges = {
        0: lambda r: r.fill_(1.0).index_fill_(0, torch.tensor([hd // 2], device=x.device), float("nan")),
        1: lambda r: r.fill_(0.0)[1::2].fill_(-0.0),
        2: lambda r: r.copy_((2 * n + 1) / 16 * sign)[:1].fill_(254 / 16),
        3: lambda r: r[hd // 3 : hd // 3 + 1].fill_(float("inf")),
        4: lambda r: r[-1:].fill_(float("-inf")),
        5: lambda r: r.copy_(torch.randint(-60, 60, (hd,), generator=g, device=x.device) * 2.0**-133),
        6: lambda r: r.copy_(torch.randn(hd, generator=g, device=x.device) * 1e-7),
    }
    for i, fn in edges.items():
        if i < rows.shape[0]:
            fn(rows[i])


def append_inputs(B: int, KV: int, hd: int, W: int, dtype, g, edges: bool = False):
    """k, v (B, 1, KV, hd) over 16 octaves, and random prior int8 caches
    (B, W, KV, hd) and scales (B, W, KV), on the card."""
    k, v = (torch.randn((B, 1, KV, hd), generator=g, device="cuda")
            * torch.exp2(torch.randint(-8, 8, (B, 1, KV, 1), generator=g, device="cuda").float()) for _ in range(2))
    if edges:
        append_edge_rows(k, g)
        v.view(-1, hd)[-1, 3] = float("nan")
    caches = [torch.randint(-127, 128, (B, W, KV, hd), generator=g, device="cuda", dtype=torch.int8)
              for _ in range(2)]
    scales = [torch.rand((B, W, KV), generator=g, device="cuda") + 0.1 for _ in range(2)]
    return k.to(dtype), v.to(dtype), caches + scales


def append_equal(got, want) -> bool:
    return all(same_bits(a, b) for a, b in zip(got, want))


def append_check(k, v, prior, slot: int, label: str) -> None:
    """The kernel against the plain version on copies of ``prior`` (k_cache,
    v_cache, k_scale, v_scale), bit for bit, every other slot untouched."""
    from repro_torch.kernels.kvquant import kernel as KK
    from repro_torch.kernels.kvquant import ref as KR

    s = torch.tensor([slot], device="cuda")
    got, want = [t.clone() for t in prior], [t.clone() for t in prior]
    KK.quantize_append(k, v, *got, s)
    torch.cuda.synchronize()
    KR.quantize_append(k, v, *want, s)
    keep = torch.ones(prior[0].shape[1], dtype=torch.bool, device="cuda")
    keep[slot] = False
    if not append_equal(got, want) or not append_equal([t[:, keep] for t in got], [t[:, keep] for t in prior]):
        raise AssertionError(f"quantize_append {label} at slot {slot} differs from its plain version or wrote "
                             f"outside its slot")


def append_kernels(bw: float, seed: int) -> dict:
    """``quantize_append`` timed at granite-3-8b's append shape in bf16 (as
    served) against its plain version; bit for bit, untimed, on the edge
    rows, float32 and bf16, every head size, slots 0 and W - 1."""
    g = torch.Generator(device="cuda").manual_seed(seed + 25)
    B, KV, hd = APPEND_MAIN
    k, v, prior = append_inputs(B, KV, hd, APPEND_W, torch.bfloat16, g)
    case = _check_case(f"quantize_append main {B}x1x{KV}x{hd}", {
        "name": "quantize_append", "dtype": "bfloat16", "ring": APPEND_W,
        **append_timings(k, v, prior, Timer(reps=CHUNK_REPS, warmup=5), bw)})
    checked = 0
    for B, KV, hd in [APPEND_MAIN] + APPEND_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            k, v, prior = append_inputs(B, KV, hd, APPEND_W, dtype, g, edges=True)
            for slot in (0, APPEND_W - 1):
                append_check(k, v, prior, slot, f"{B}x1x{KV}x{hd} {dtype}")
                checked += 1
    emit("kernel quantize_append edges", cases=checked, shapes=[list(e) for e in [APPEND_MAIN] + APPEND_EDGES],
         rows="nan, zero, rint ties, +inf, -inf, subnormal, floored", dtypes=["float32", "bfloat16"],
         slots=[0, APPEND_W - 1], bit_identical=True, other_slots_untouched=True)
    return case


def append_old_sequence(k, v, k_c, v_c, ks_c, vs_c, slot) -> None:
    """The int8 append the fused kernel replaced: two ``_quantize_token``
    calls and four ``index_copy_`` (``absmax`` and ``quantize_with_scale``
    twice, and the host glue around them)."""
    from repro_torch.models import lm

    kq, ks = lm._quantize_token(k)
    vq, vs = lm._quantize_token(v)
    k_c.index_copy_(1, slot, kq)
    v_c.index_copy_(1, slot, vq)
    ks_c.index_copy_(1, slot, ks)
    vs_c.index_copy_(1, slot, vs)


def append_against_old_sequence(src, cache, label: str) -> dict:
    """Every attention layer's token of the bf16 cache ``src`` appended into
    copies of the int8 cache ``cache`` by the fused kernel and by the old
    sequence, at slots 0 and W - 1: whole caches and scales bit for bit."""
    from repro_torch.kernels.kvquant import ops as kvops

    W = cache.k.shape[2]
    for src_slot, slot in ((5, 0), (0, W - 1)):
        s = torch.tensor([slot], device="cuda")
        fused = [t.clone() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)]
        old = [t.clone() for t in fused]
        for i in range(cache.k.shape[0]):
            k = src.k[i][:, src_slot : src_slot + 1].contiguous()
            v = src.v[i][:, src_slot : src_slot + 1].contiguous()
            kvops.kv_quantize_append(k, v, *(t[i] for t in fused), s)
            append_old_sequence(k, v, *(t[i] for t in old), s)
        torch.cuda.synchronize()
        if not append_equal(fused, old):
            raise AssertionError(f"{label}: the fused int8 append into slot {slot} differs from two "
                                 f"_quantize_token calls and four index_copy_")
    return {"layers": cache.k.shape[0], "slots": [0, W - 1], "bit_identical": True}


def append_host_us(k, v, caches, calls: int = 200) -> dict:
    """Host microseconds of one layer's int8 append, old sequence and fused,
    each over ``calls`` calls ending in one sync."""
    from repro_torch.kernels.kvquant import ops as kvops

    s = torch.tensor([0], device="cuda")
    out = {}
    for name, fn in (("old", append_old_sequence), ("fused", kvops.kv_quantize_append),
                     ("old_again", append_old_sequence), ("fused_again", kvops.kv_quantize_append)):
        fn(k, v, *caches, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(k, v, *caches, s)
        torch.cuda.synchronize()
        out[f"{name}_us"] = (time.perf_counter() - t0) / calls * 1e6
    return out


def append_timings(k, v, caches, timer, bw: float) -> dict:
    """The fused append at slot 0 of copies of ``caches`` against its plain
    version, bit for bit, timed, with the host time both ways."""
    from repro_torch.kernels.kvquant import kernel as KK
    from repro_torch.kernels.kvquant import ref as KR

    s = torch.tensor([0], device="cuda")
    got, want = [t.clone() for t in caches], [t.clone() for t in caches]
    KK.quantize_append(k, v, *got, s)
    torch.cuda.synchronize()
    KR.quantize_append(k, v, *want, s)
    B, _, KV, hd = k.shape
    return {"shape": list(k.shape), "bit_identical": append_equal(got, want),
            "max_abs_err": max_abs_diff(zip(got, want)), "kernel_ms": timer(lambda: KK.quantize_append(k, v, *got, s)),
            "plain_ms": timer(lambda: KR.quantize_append(k, v, *want, s)), "library_ms": None,
            **append_bound(B, KV, hd, k.element_size(), bw), "host": append_host_us(k, v, got)}


def v3_coder_integers(x2d: torch.Tensor) -> torch.Tensor:
    """|integers| the v3 coder hands its host bitplane codec for ``x2d`` at
    REL 1e-4 (the bands, the DC band delta-coded), as uint32 on the card."""
    import repro_torch.core as tc
    from repro_torch.core import transform

    seen = []
    host_encode = transform.bitplane_encode

    def capture(vals):
        seen.append(np.asarray(vals, np.int64))
        return host_encode(vals)

    transform.bitplane_encode = capture
    try:
        tc.sz3_transform().compress(x2d, tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4))
    finally:
        transform.bitplane_encode = host_encode
    mags = np.abs(np.concatenate(seen))
    if mags.size != x2d.numel() or int(mags.max()) >= 1 << 32:
        raise AssertionError(f"the v3 coder's integers: {mags.size} values, max {int(mags.max())}")
    return torch.from_numpy(mags.astype(np.uint32)).cuda()


def _u32_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| of two uint32 tensors, as integers."""
    wide = [t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF for t in (a, b)]
    return float((wide[0] - wide[1]).abs().max())


def _host_planes_match(words: torch.Tensor, vals: torch.Tensor) -> int:
    """The transpose's plane content against the host codec's planes
    (MSB-first), as ``tests/test_kernels.py`` holds the JAX codecs; returns
    the planes compared."""
    from repro_torch.core import quantizers

    v = vals.cpu().numpy()
    n = v.size
    blob = quantizers.bitplane_encode(v.astype(np.int64))
    nplanes = int(np.frombuffer(blob, np.int64, count=2)[1])
    nbytes_plane = (n + 7) // 8
    pos = 16 + nbytes_plane  # header + sign bitmap (all zero)
    w = words.cpu().view(torch.int32).numpy().view(np.uint32)
    for i, p in enumerate(range(nplanes - 1, -1, -1)):
        host = np.frombuffer(blob, np.uint8, count=nbytes_plane, offset=pos + i * nbytes_plane)
        kern = np.packbits(np.unpackbits(w[p].view(np.uint8), bitorder="little")[:n])
        if not np.array_equal(host, kern):
            raise AssertionError(f"bitplane plane {p} differs from the host codec's")
    if w[nplanes:].any():
        raise AssertionError("bitplane planes above the host codec's are not zero")
    return nplanes


def _bitplane_edges(g) -> dict:
    """encode/decode against their plain versions, bit for bit, untimed, on
    the redesign's edges: R off the 128 groups of a thread block and off a
    multiple of 4; R = 2^20+3, more tiles than the card holds warps at once
    (132 SMs x at most 32 blocks of 4 warps); views 1 and 2 elements past an
    aligned base (encode's values take the kernel's 4-byte path, decode
    reads planes at the same offset); all-ones and one-bit-per-plane values,
    whose planes are known."""
    from repro_torch.kernels.bitplane import kernel as K
    from repro_torch.kernels.bitplane import ref as R

    def rand(n):
        return torch.randint(-(1 << 31), 1 << 31, (n,), generator=g, device="cuda", dtype=torch.int32)

    def equal(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    def check(label, v, planes=None):
        w = K.encode(v)
        torch.cuda.synchronize()
        if not equal(w, R.encode(v)) or (planes is not None and not equal(w, planes)):
            raise AssertionError(f"bitplane_encode on {label} differs from its plain version")
        back = K.decode(w)
        torch.cuda.synchronize()
        if not (equal(back, v) and equal(back, R.decode(w))):
            raise AssertionError(f"bitplane_decode on {label} differs from its plain version")
        return w

    ragged = [130, 1003, 4099, (1 << 20) + 3]
    for rows in ragged:
        check(f"R={rows}", rand(32 * rows).view(torch.uint32).view(rows, 32))
    rows = 1003
    for off in (1, 2):
        v = rand(32 * rows + off)[off:].view(torch.uint32).view(rows, 32)
        w_view = torch.zeros(32 * rows + off, dtype=torch.int32, device="cuda")[off:].view(torch.uint32).view(32, rows)
        if v.data_ptr() % 16 == 0 or w_view.data_ptr() % 16 == 0:
            raise AssertionError("bitplane offset views are 16-byte aligned: the 4-byte path is not reached")
        w_view.view(torch.int32).copy_(check(f"values at offset {off}", v).view(torch.int32))
        back = K.decode(w_view)
        torch.cuda.synchronize()
        if not equal(back, v):
            raise AssertionError(f"bitplane_decode of planes at offset {off} differs from its plain version")
    rows = 4099
    ones = torch.full((rows, 32), -1, dtype=torch.int32, device="cuda").view(torch.uint32)
    check("all-ones", ones, ones.reshape(32, rows))
    # v[r, k] = 1 << ((k - r) % 32): plane word w[p, r] = 1 << ((p + r) % 32)
    r = torch.arange(rows, device="cuda")
    k = torch.arange(32, device="cuda")
    check("one bit per plane", R.as_u32(1 << ((k[None, :] - r[:, None]) % 32)),
          R.as_u32(1 << ((k[:, None] + r[None, :]) % 32)))
    return {"ragged_R": ragged, "offsets": [1, 2], "patterns": ["all-ones", "one-bit-per-plane"],
            "bit_identical": True}


def bitplane_kernels(timer, bw: float, coder_ints: torch.Tensor, seed: int) -> dict:
    """encode/decode against their plain versions, bit for bit: (a) the v3
    coder's integers, (b) 2^24+3 uniform uint32 (all 32 planes live),
    (c) n = 0, 5, 16385 (padding and an empty input), timed; then the
    redesign's edges, untimed (:func:`_bitplane_edges`)."""
    from repro_torch.kernels.bitplane import kernel as K
    from repro_torch.kernels.bitplane import ops as O
    from repro_torch.kernels.bitplane import ref as R

    g = torch.Generator(device="cuda").manual_seed(seed + 50)
    uniform = torch.randint(0, 1 << 32, (N1D,), generator=g, device="cuda", dtype=torch.int64)
    small = {n: torch.randint(0, 1 << 32, (n,), generator=g, device="cuda", dtype=torch.int64) for n in (0, 5, 16385)}
    cases = {}
    for label, vals in [("v3 coder integers", coder_ints), ("uniform", uniform)] + [
        (f"n={n}", v) for n, v in small.items()
    ]:
        v = O._padded_groups(vals, 32 * O.TILE_GROUPS)  # (R, 32) uint32, as the public encode pads
        w = K.encode(v)
        torch.cuda.synchronize()
        w_plain = R.encode(v)
        back = K.decode(w)
        torch.cuda.synchronize()
        back_plain = R.decode(w)
        n_pad = v.numel()
        enc_equal = torch.equal(w.view(torch.int32), w_plain.view(torch.int32))
        dec_equal = torch.equal(back.view(torch.int32), back_plain.view(torch.int32)) and torch.equal(
            back.view(torch.int32), v.view(torch.int32)
        )
        for name, kfn, rfn, arg, got, want, equal in (
            ("bitplane_encode", K.encode, R.encode, v, w, w_plain, enc_equal),
            ("bitplane_decode", K.decode, R.decode, w, back, back_plain, dec_equal),
        ):
            case = {
                "name": name,
                "n": vals.numel(),
                "shape": list(arg.shape),
                "bit_identical": bool(equal),
                "max_abs_err": _u32_err(got, want),
                "kernel_ms": timer(lambda: kfn(arg)),
                "plain_ms": timer(lambda: rfn(arg)),
                "library_ms": None,
                # 4 B read and 4 B written per value; per bit a shift, a mask,
                # a shift into place and an add (the definition's arithmetic)
                **bound(8 * n_pad, 128 * n_pad, bw),
            }
            _check_case(f"{name} {label}", case)
            if label == "v3 coder integers":
                cases[name] = case
        if label in ("v3 coder integers", "uniform"):
            planes = _host_planes_match(w, vals)
            emit(f"bitplane planes {label}", n=vals.numel(), planes_equal_to_host_codec=planes)
    emit("kernel bitplane checks", **_bitplane_edges(g))
    return cases


def phase_kernels(seed: int, bw: float, x2d: torch.Tensor, x1d: torch.Tensor, coder_ints: torch.Tensor) -> dict:
    timer = Timer()
    # what the timer reads for the least work the card can be given: every
    # kernel time below includes this floor (event records and the launch)
    one = torch.empty(1, device="cuda")
    emit("timer floor", op="one-element fill_", ms=Timer(reps=CHUNK_REPS, warmup=5)(lambda: one.fill_(1.0)))
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = lorenzo_kernels(timer, g, bw)
    cases.update(transform_kernels(timer, bw, x2d, torch.cat([x1d, x1d[-1:]])))  # 2^24+4
    cases.update(block_stats_kernels(timer, bw, x2d, x1d))
    cases.update(kvquant_kernels(timer, bw, seed))
    cases.update(bitplane_kernels(timer, bw, coder_ints, seed))
    return cases


#: ``hacc.lorenzo``'s field: a quarter of HACC's 280,953,867 particles
HACC_N = 70_238_467


def _pack_launcher(values: torch.Tensor, table: torch.Tensor):
    """The pack kernel's launch alone (its zeroing memsets and the kernel),
    on buffers made once: the wrapper's read-back of the bit count waits
    for the card, which a timed call must not."""
    from repro_torch.kernels._build import check_launch, stream
    from repro_torch.kernels.huffman import kernel as K

    lib = K.load()
    n = values.numel()
    n_words = -(-n // 4)
    words = torch.empty(n_words, dtype=torch.int64, device="cuda")
    sync = torch.empty(-(-n // 1024), dtype=torch.int64, device="cuda")
    scratch = torch.empty(lib.huffman_pack_scratch_words(n), dtype=torch.int64, device="cuda")

    def launch():
        check_launch(lib.huffman_pack(values.data_ptr(), values.element_size(), n, table.data_ptr(), table.numel(),
                                      words.data_ptr(), n_words, sync.data_ptr(), scratch.data_ptr(), stream()),
                     "huffman pack")
    return launch


def huffman_case(timer, label: str, codes: torch.Tensor, bw: float) -> dict:
    """The pack kernel on one input of int32 codes on the card: against its
    plain version and the host coder's stream byte for byte, the coder's
    tensor path against its numpy path blob for blob, then timed."""
    from repro_torch.core import encoders as E
    from repro_torch.kernels.huffman import kernel as K
    from repro_torch.kernels.huffman import ref as R

    flat = codes.reshape(-1)
    host = flat.cpu().numpy().astype(np.uint16)
    vals, freqs, inv = E._alphabet_of(host)
    lens, _ = E._huffman_code_lengths(freqs)
    table = E._cached_table(lens)
    host_stream, host_pack_s = _timed(lambda: E._encode_stream(inv, table, 2))
    dense = torch.from_numpy(E._pack_table(vals, table)).cuda()
    got = K.pack(flat, dense)
    torch.cuda.synchronize()
    want = R.pack(flat, dense)
    n, total, sync, pos = E._parse_stream_head(host_stream, 0)
    if not (got[2] == want[2] == total and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and got[0].cpu().numpy().tobytes() == host_stream[pos:] and np.array_equal(got[1].cpu().numpy(), sync)):
        raise AssertionError(f"huffman {label}: the pack kernel's stream differs from the plain version's or the host's")
    (_, blob), tensor_s = _timed(lambda: E.HuffmanEncoder().encode_tensor(flat, np.uint16))
    host_blob, host_s = _timed(lambda: E.HuffmanEncoder().encode(host))
    if blob != host_blob:
        raise AssertionError(f"huffman {label}: the coder's tensor path wrote another blob than its numpy path")
    stream_bytes = (total + 7) // 8
    return {
        "name": "huffman_pack",
        "label": label,
        "shape": list(codes.shape),
        "symbols": int(vals.size),
        "max_len": int(lens.max()),
        "stream_bytes": stream_bytes,
        "bit_identical": True,
        "max_abs_err": 0.0,
        "kernel_ms": timer(_pack_launcher(flat, dense)),
        "plain_ms": timer(lambda: R.pack(flat, dense)),
        "library_ms": None,
        "host_numpy_pack_ms": host_pack_s * 1e3,
        "coder_tensor_path_ms": tensor_s * 1e3,
        "coder_numpy_path_ms": host_s * 1e3,
        **bound(flat.numel() * flat.element_size() + stream_bytes, 0, bw),
    }


def phase_huffman(seed: int, bw: float, launches_total: dict) -> dict:
    """The Huffman stream pack at ``hacc.lorenzo``'s field and at a CESM-ATM
    chunk, then ``sz3_lorenzo`` on that field: one pack launch a compress,
    within the bound.  Returns the summary's ``huffman_pack`` case."""
    import repro_torch.core as tc
    from repro_torch.kernels.huffman import kernel as K
    from repro_torch.kernels.lorenzo import ops as LO

    timer = Timer()
    x = particle_series(HACC_N, seed + 90)
    eb = 1e-4 * float(x.max() - x.min())
    case = huffman_case(timer, "hacc", LO.encode_pipeline(x, eb=eb, radius=32768)[0], bw)
    field = smooth_field(SHAPE2D, seed + 91)
    chunk = field[: CHUNK_2D[0][0]].contiguous()
    eb2 = 1e-4 * float(field.max() - field.min())
    chunk_case = huffman_case(Timer(reps=CHUNK_REPS, warmup=5), "cesm chunk",
                              LO.encode_pipeline(chunk, eb=eb2, radius=32768)[0], bw)
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    comp = tc.sz3_lorenzo()
    comp.compress(x[: 1 << 17], conf)  # warm-up
    K.reset_launches()
    res, t_c = _timed(lambda: comp.compress(x, conf))
    if K.LAUNCHES["pack"] != 1:
        raise AssertionError(f"huffman: sz3_lorenzo launched the pack {K.LAUNCHES['pack']} times, expected 1")
    out, t_d = _timed(lambda: tc.decompress(res.blob))
    abs_eb = tc.parse_header(res.blob)[0]["abs_eb"]
    err = float((out.double() - x.double()).abs().max())
    if err > abs_eb:
        raise AssertionError(f"huffman: sz3_lorenzo's max error {err} breaks the bound {abs_eb}")
    launches_total["huffman_pack"] = launches_total.get("huffman_pack", 0) + 1
    emit("huffman", hacc=case, cesm_chunk=chunk_case, sz3_lorenzo_hacc={
        "n": HACC_N, "compress_s": t_c, "decompress_s": t_d, "ratio": res.ratio, "max_abs_err": err,
        "abs_eb": abs_eb, "pack_launches": 1})
    return {"huffman_pack": {**case, "chunk_shape": chunk_case["shape"], "chunk_ms": chunk_case["kernel_ms"],
                             "chunk_plain_ms": chunk_case["plain_ms"], "chunk_library_ms": None,
                             "chunk_bound_ms": chunk_case["bound_ms"]}}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


#: main path -> (factory name, its kernels' expected launches per compress +
#: decompress, by the input's ndim); None means "at least once"
PATHS = {
    "sz3_lorenzo": {2: {"encode_2d": None, "decode_2d": None}, 1: {"encode_1d": None, "decode_1d": None}},
    "sz3_transform": {
        2: {"transform_fwd_2d": 1, "transform_inv_2d": 2, "transform_axis_f64": 2},
        1: {"transform_fwd_1d": 1, "transform_inv_1d": 2, "transform_axis_f64": 1},
    },
    "sz3_fast": {2: {"block_stats": 1}, 1: {"block_stats": 1}},
}


def _nfail(header) -> int:
    for key in ("pred_meta", "meta", "fast_meta"):
        if key in header:
            return header[key]["nfail"]
    raise KeyError("no fail-channel count in the header")


@contextlib.contextmanager
def recorded_rotations():
    """(input dtype, output dtype) of each transform rotation launched inside."""
    from repro_torch.kernels.transform import kernel as TK

    seen = []
    rotate = TK._rotate

    def spy(name, x, mat, mode, out_dtype):
        seen.append((str(x.dtype), str(out_dtype)))
        return rotate(name, x, mat, mode, out_dtype)

    TK._rotate = spy
    try:
        yield seen
    finally:
        TK._rotate = rotate


def phase_main_path(pipeline: str, label: str, x: torch.Tensor, launches_total) -> None:
    import repro_torch.core as tc

    factory = tc.PIPELINES[pipeline]
    expected = PATHS[pipeline][x.ndim]
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    comp = factory()
    comp.compress(x[:64].contiguous() if x.ndim == 2 else x[: 1 << 17], conf)  # warm-up
    reset_all_launches()
    with recorded_rotations() as rotations:
        res, t_c = _timed(lambda: comp.compress(x, conf))
        out, t_d = _timed(lambda: tc.decompress(res.blob))
    launches = all_launches()
    # the coder hands the rotation its float64 grids: no cast pass around it
    if any(src != "torch.float64" for src, _ in rotations):
        raise AssertionError(f"{pipeline} {label}: a transform rotation was given {rotations}, not float64 grids")
    for name, want in expected.items():
        if launches[name] == 0 or (want is not None and launches[name] != want):
            raise AssertionError(
                f"{pipeline} {label}: kernel {name} launched {launches[name]} times on the main path"
                + ("" if want is None else f", expected {want}")
            )
        launches_total[name] += launches[name]
    header, _ = tc.parse_header(res.blob)
    abs_eb = header["abs_eb"]
    if out.shape != x.shape or out.dtype != x.dtype or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{pipeline} {label}: decoded {tuple(out.shape)} {out.dtype}, not finite or not {tuple(x.shape)}")
    err = float((out.double() - x.double()).abs().max())
    if err > abs_eb:
        raise AssertionError(f"{pipeline} {label}: max error {err} breaks the bound {abs_eb}")
    x_cpu = x.cpu()
    plain = factory(device="cpu", route="force").compress(x_cpu, conf).blob
    if plain != res.blob:
        raise AssertionError(f"{pipeline} {label}: the card's blob differs from the plain versions' blob")
    host = tc.decompress(res.blob, device="cpu")
    host_err = float((host.double() - x_cpu.double()).abs().max())
    if host_err > abs_eb:
        raise AssertionError(f"{pipeline} {label}: CPU decode error {host_err} breaks the bound {abs_eb}")
    mb = x.numel() * x.element_size() / 1e6
    emit(
        f"main path {pipeline} {label}",
        shape=list(x.shape),
        mode="rel",
        eb=1e-4,
        abs_eb=abs_eb,
        ratio=res.ratio,
        blob_bytes=len(res.blob),
        compress_s=t_c,
        decompress_s=t_d,
        compress_MBps=mb / t_c,
        decompress_MBps=mb / t_d,
        max_abs_err=err,
        cpu_decode_max_abs_err=host_err,
        nfail=_nfail(header),
        lossless=header["spec"]["lossless"],
        same_bytes_as_plain=True,
        launches={k: v for k, v in launches.items() if v},
        rotation_dtypes=rotations,
        stages=stage_breakdown(pipeline, x, conf),
    )


def phase_bitplane_path(coder_ints: torch.Tensor, launches_total: dict) -> None:
    """The transpose's own entry point (``bitplane_encode`` then
    ``bitplane_decode``) on the integers the v3 coder stores."""
    from repro_torch.kernels.bitplane import ops as O

    n = coder_ints.numel()
    torch.cuda.synchronize()
    reset_all_launches()
    (words, back), seconds = _timed(lambda: (lambda w: (w, O.bitplane_decode(w, n)))(O.bitplane_encode(coder_ints)))
    launches = all_launches()
    for name in ("bitplane_encode", "bitplane_decode"):
        if launches[name] != 1:
            raise AssertionError(f"bitplane path: kernel {name} launched {launches[name]} times, expected 1")
        launches_total[name] += launches[name]
    if not torch.equal(back.view(torch.int32), coder_ints.view(torch.int32)):
        raise AssertionError("bitplane path: decode does not return the coder's integers")
    if words.shape[1] % 512 or words.shape[1] * 32 < n:
        raise AssertionError(f"bitplane path: words of shape {tuple(words.shape)} for {n} values")
    planes = int((words.view(torch.int32) != 0).any(dim=1).sum())
    emit("main path bitplane", n=n, words_shape=list(words.shape), seconds=seconds,
         nonzero_planes=planes, round_trip=True, launches={k: v for k, v in launches.items() if v})


#: kernels a chunk's pipeline launches per compress + decompress, when the
#: chunk takes the kernel route: Lorenzo encodes once and decodes twice (the
#: compress-side verification, then the decode), the fast tier classifies
#: once, the transform runs its main path's launches (``PATHS``); the block
#: hybrid launches none
_CHUNK_KERNELS = {
    "sz3_lorenzo": {1: {"encode_1d": 1, "decode_1d": 2}, 2: {"encode_2d": 1, "decode_2d": 2}},
    "sz3_fast": {1: {"block_stats": 1}, 2: {"block_stats": 1}},
    "sz3_transform": PATHS["sz3_transform"],
}
#: the kernels a chunked path can launch (the counts checked per chunk)
_CHUNK_KERNEL_NAMES = sorted({k for by_nd in _CHUNK_KERNELS.values() for ks in by_nd.values() for k in ks})


def _chunk_blobs(blob: bytes) -> list:
    """The v1 blobs of a v2 container's chunks, in order."""
    import repro_torch.core as tc

    header, body_off = tc.parse_header(blob)
    return [blob[body_off + c["off"] : body_off + c["off"] + c["len"]] for c in header["chunks"]]


def _takes_kernel_route(pipeline: str, n: int) -> bool:
    """Does a chunk of ``n`` elements take its pipeline's kernel route?  The
    pipelines' own size floors: smaller chunks take the host route."""
    from repro_torch.core import fastmode, predictors, transform

    if pipeline == "sz3_lorenzo":
        return n >= predictors.LorenzoPredictor._KERNEL_MIN_SIZE
    if pipeline == "sz3_fast":  # the floor counts the blocks, padded
        bs = fastmode.DEFAULT_BS
        return -(-n // bs) * bs >= fastmode._KERNEL_MIN_SIZE
    if pipeline == "sz3_transform":
        return n >= transform.TransformCompressor._KERNEL_MIN_SIZE
    return False


def _expected_chunk_launches(picks, ndim: int) -> dict:
    """Launches a chunked path must make: ``picks`` are the (pipeline,
    elements) of each chunk compressed and decoded once on the card."""
    expected = {name: 0 for name in _CHUNK_KERNEL_NAMES}
    for pipeline, n in picks:
        if _takes_kernel_route(pipeline, n):
            for name, k in _CHUNK_KERNELS[pipeline][ndim].items():
                expected[name] += k
    return expected


def phase_chunked(label: str, x: torch.Tensor, launches_total: dict, speed_tier: str = "ratio",
                  engine: str = "sz3_chunked") -> None:
    """``engine`` (``sz3_chunked`` or ``sz3_auto``) at REL 1e-4 with 4 MiB
    chunks: compress and decompress on the card, then every check of a main
    path, per-chunk picks, the ``workers=4`` blob and exact launch counts per
    routed chunk."""
    import repro_torch.core as tc

    make = tc.PIPELINES[engine]
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    comp = make(speed_tier=speed_tier)
    reset_all_launches()
    res, t_c = _timed(lambda: comp.compress(x, conf, with_stats=True))
    out, t_d = _timed(lambda: tc.decompress(res.blob))
    launches = all_launches()
    chunks = res.meta["chunks"]
    inner = math.prod(x.shape[1:])
    expected = _expected_chunk_launches([(c["pipeline"], c["n0"] * inner) for c in chunks], x.ndim)
    for name, want in expected.items():
        if launches[name] != want:
            raise AssertionError(f"{engine} {label}: kernel {name} launched {launches[name]} times, "
                                 f"expected {want} for the chunks routed to it")
        launches_total[name] += launches[name]
    body_off = tc.parse_header(res.blob)[1]
    abs_eb = tc.parse_header(res.blob[body_off : body_off + chunks[0]["len"]])[0]["abs_eb"]  # resolved once
    if out.shape != x.shape or out.dtype != x.dtype or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{engine} {label}: decoded {tuple(out.shape)} {out.dtype}, not finite or not {tuple(x.shape)}")
    err = float((out.double() - x.double()).abs().max())
    if err > abs_eb:
        raise AssertionError(f"{engine} {label}: max error {err} breaks the bound {abs_eb}")
    x_cpu = x.cpu()
    plain, t_plain = _timed(lambda: make(speed_tier=speed_tier, device="cpu", route="force").compress(x_cpu, conf).blob)
    same_as = "plain versions"
    if plain != res.blob:
        # route="force" takes the fast tier's kernel route below its size
        # floor too, as the JAX package's device="force" does; the card
        # takes the host route there.  Chunk by chunk, the card's bytes are
        # the plain versions' where it launched a kernel, the CPU host
        # route's elsewhere.
        host_blob = make(speed_tier=speed_tier, device="cpu").compress(x_cpu, conf).blob
        want = [
            f if _takes_kernel_route(c["pipeline"], c["n0"] * inner) else h
            for c, f, h in zip(chunks, _chunk_blobs(plain), _chunk_blobs(host_blob))
        ]
        picks = [(c["pipeline"], c["n0"]) for c in tc.parse_header(plain)[0]["chunks"]]
        if _chunk_blobs(res.blob) != want or picks != [(c["pipeline"], c["n0"]) for c in chunks]:
            raise AssertionError(f"{engine} {label}: the card's blob differs from the plain versions' blob")
        same_as = "plain versions on kernel-routed chunks, CPU host route on the rest"
    host = tc.decompress(res.blob, device="cpu")
    host_err = float((host.double() - x_cpu.double()).abs().max())
    if host_err > abs_eb:
        raise AssertionError(f"{engine} {label}: CPU decode error {host_err} breaks the bound {abs_eb}")
    par, t_par = _timed(lambda: make(speed_tier=speed_tier, workers=4).compress(x, conf).blob)
    if par != res.blob:
        raise AssertionError(f"{engine} {label}: the workers=4 blob differs from the serial one")
    out4, t_d4 = _timed(lambda: tc.decompress(res.blob, workers=4))
    if not same_bits(out4, out):
        raise AssertionError(f"{engine} {label}: the workers=4 decode differs from the serial one")
    mb = x.numel() * x.element_size() / 1e6
    emit(
        f"main path {engine} {label}" + ("" if speed_tier == "ratio" else f" {speed_tier}"),
        shape=list(x.shape),
        speed_tier=speed_tier,
        mode="rel",
        eb=1e-4,
        abs_eb=abs_eb,
        chunks=len(chunks),
        picks=[c["pipeline"] for c in chunks],
        chunk_rows=[c["n0"] for c in chunks],
        ratio=res.ratio,
        blob_bytes=len(res.blob),
        compress_s=t_c,
        decompress_s=t_d,
        compress_MBps=mb / t_c,
        decompress_MBps=mb / t_d,
        workers4_compress_s=t_par,
        workers4_decompress_s=t_d4,
        plain_cpu_compress_s=t_plain,
        max_abs_err=err,
        cpu_decode_max_abs_err=host_err,
        same_bytes_as=same_as,
        workers4_same_bytes=True,
        launches={k: v for k, v in launches.items() if v},
        expected_launches={k: v for k, v in expected.items() if v},
        stages=stage_breakdown("sz3_chunked", x, conf, lambda: make(speed_tier=speed_tier)),
    )


def phase_paper_pipeline(pipeline: str, x: torch.Tensor) -> None:
    """``sz3_lr`` or ``sz3_interp`` alone on the field: no kernels; the card
    writes the CPU's bytes and both decodes keep the bound."""
    import repro_torch.core as tc

    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    res, t_c = _timed(lambda: tc.PIPELINES[pipeline]().compress(x, conf))
    out, t_d = _timed(lambda: tc.decompress(res.blob))
    abs_eb = tc.parse_header(res.blob)[0]["abs_eb"]
    err = float((out.double() - x.double()).abs().max())
    if out.shape != x.shape or err > abs_eb:
        raise AssertionError(f"{pipeline}: max error {err} breaks the bound {abs_eb}")
    x_cpu = x.cpu()
    cpu, t_cpu = _timed(lambda: tc.PIPELINES[pipeline](device="cpu").compress(x_cpu, conf).blob)
    if cpu != res.blob:
        raise AssertionError(f"{pipeline}: the card's blob differs from the CPU's")
    host_err = float((tc.decompress(res.blob, device="cpu").double() - x_cpu.double()).abs().max())
    if host_err > abs_eb:
        raise AssertionError(f"{pipeline}: CPU decode error {host_err} breaks the bound {abs_eb}")
    mb = x.numel() * x.element_size() / 1e6
    emit(f"main path {pipeline} 2-D", shape=list(x.shape), mode="rel", eb=1e-4, abs_eb=abs_eb,
         ratio=res.ratio, blob_bytes=len(res.blob), compress_s=t_c, decompress_s=t_d,
         compress_MBps=mb / t_c, decompress_MBps=mb / t_d, cpu_compress_s=t_cpu,
         max_abs_err=err, cpu_decode_max_abs_err=host_err, same_bytes_as_cpu=True,
         stages=stage_breakdown(pipeline, x, conf))


def _stage_patches(pipeline: str):
    """(owner, attribute, label) of the stage functions each pipeline runs;
    a function used by both directions is timed in both."""
    from repro_torch.core import encoders, fastmode, lossless, predictors, transform
    from repro_torch.kernels.fastmode import ops as fops
    from repro_torch.kernels.transform import ops as tops

    # without zstandard, Zstd writes zlib and the blob names "gzip", which
    # decodes through Gzip
    host_lossless = [
        (lossless.Zstd, "compress", "lossless compress (host)"),
        (lossless.Zstd, "decompress_bounded", "lossless decompress (host)"),
        (lossless.Gzip, "decompress_bounded", "lossless decompress (host)"),
    ]
    if pipeline == "sz3_lorenzo":
        return host_lossless + [
            (predictors.LorenzoPredictor, "compress", "predict (device)"),
            (predictors.LorenzoPredictor, "decompress", "inverse (device)"),
            (encoders.HuffmanEncoder, "encode", "huffman encode (host)"),
            (encoders.HuffmanEncoder, "decode", "huffman decode (host)"),
        ]
    if pipeline == "sz3_hybrid":
        from repro_torch.core import blockwise, preprocess

        return host_lossless + [
            (blockwise.BlockHybridCompressor, "_compress_blocks", "contest (device)"),
            (preprocess.LogTransform, "forward", "log2 and side channels (host numpy)"),
            (preprocess.LogTransform, "inverse", "exp2 and side channels (host numpy)"),
            (encoders.HuffmanEncoder, "encode", "huffman encode (host)"),
            (encoders.HuffmanEncoder, "decode", "huffman decode (host)"),
        ]
    if pipeline in ("sz3_lr", "sz3_interp", "sz3_chunked"):
        from repro_torch.core import blockwise, chunking

        return host_lossless + [
            (chunking, "select_pipeline", "select (host sample)"),
            (blockwise.BlockHybridCompressor, "_compress_blocks", "predict (device)"),
            (tops, "fwd_pipeline", "predict (device)"),
            (transform, "_encode_bands", "bitplane encode (host)"),
            (transform, "_decode_bands", "bitplane decode (host)"),
            (predictors.LorenzoPredictor, "compress", "predict (device)"),
            (predictors.CompositePredictor, "compress", "predict (device)"),
            (predictors.InterpolationPredictor, "compress", "predict (device)"),
            (predictors.LorenzoPredictor, "decompress", "inverse (device)"),
            (predictors.CompositePredictor, "decompress", "inverse (device)"),
            (predictors.InterpolationPredictor, "decompress", "inverse (device)"),
            (fastmode.FastModeCompressor, "_encode_blocks", "fast-tier blocks (device + host packing)"),
            (encoders.HuffmanEncoder, "encode", "huffman encode (host)"),
            (encoders.HuffmanEncoder, "decode", "huffman decode (host)"),
        ]
    if pipeline == "sz3_transform":
        return host_lossless + [
            (tops, "fwd_pipeline", "forward transform (device)"),
            (transform, "_quantize_coeffs", "quantize (device)"),
            (transform, "_inv_host", "float64 inverse (device)"),
            (tops, "inv_pipeline", "float32 inverse kernel (device)"),
            (transform, "_encode_bands", "bitplane encode (host)"),
            (transform, "_decode_bands", "bitplane decode (host)"),
            (transform, "to_host", "copies to the host"),
        ]
    if pipeline in ("sz3_v1_log", "sz3_pwr", "sz3_fast_pwrel"):
        from repro_torch.core import chunking, preprocess

        return host_lossless + [
            (preprocess.LogTransform, "forward", "log2 and side channels (host numpy)"),
            (preprocess.LogTransform, "inverse", "exp2 and side channels (host numpy)"),
            (chunking, "select_pipeline", "select (host sample)"),
            (predictors.LorenzoPredictor, "compress", "predict (device)"),
            (predictors.CompositePredictor, "compress", "predict (device)"),
            (predictors.InterpolationPredictor, "compress", "predict (device)"),
            (predictors.LorenzoPredictor, "decompress", "inverse (device)"),
            (predictors.CompositePredictor, "decompress", "inverse (device)"),
            (predictors.InterpolationPredictor, "decompress", "inverse (device)"),
            (fastmode.FastModeCompressor, "_encode_blocks", "fast-tier blocks (device + host packing)"),
            (fastmode, "_unpack_planes", "unpack planes (host)"),
            (encoders.HuffmanEncoder, "encode", "huffman encode (host)"),
            (encoders.HuffmanEncoder, "decode", "huffman decode (host)"),
        ]
    if pipeline in ("pastri", "sz3_aps_low", "sz3_aps_high"):
        from repro_torch.core import preprocess, quantizers

        return host_lossless + [
            (predictors.PatternPredictor, "compress", "pattern predict + quantize (device, host dgemv)"),
            (predictors.PatternPredictor, "decompress", "pattern inverse (device)"),
            (preprocess.Transpose, "forward", "transpose (device)"),
            (preprocess.Transpose, "inverse", "transpose (device)"),
            (predictors.LorenzoPredictor, "compress", "predict (device)"),
            (predictors.LorenzoPredictor, "decompress", "inverse (device)"),
            (predictors.CompositePredictor, "compress", "predict (device)"),
            (predictors.CompositePredictor, "decompress", "inverse (device)"),
            (encoders.FixedHuffmanEncoder, "encode", "fixed huffman encode (host)"),
            (encoders.FixedHuffmanEncoder, "decode", "fixed huffman decode (host)"),
            (encoders.HuffmanEncoder, "encode", "huffman encode (host)"),
            (encoders.HuffmanEncoder, "decode", "huffman decode (host)"),
            (quantizers.QuantizerBase, "save", "unpredictable streams (host)"),
            (quantizers.QuantizerBase, "load", "unpredictable streams (host)"),
        ]
    if pipeline == "sz3_truncation":
        from repro_torch.core import pipeline as pl, quantizers

        return [
            (quantizers, "to_host", "copy to the host"),
            (pl.TruncationCompressor, "_decompress_body", "byte reassembly (host) + copy to the card"),
        ]
    return [
        (fops, "block_stats", "block stats (device)"),
        (fastmode, "to_host", "copies to the host"),
        (fastmode.FastModeCompressor, "_encode_blocks", "encode blocks (device + host packing)"),
        (fastmode, "_pack_planes", "pack planes (host)"),
        (fastmode, "_unpack_planes", "unpack planes (host)"),
    ]


#: pipelines whose stages nest (the chunk contest's trial compressions run
#: the same predictors, Huffman and lossless stages): only the outermost
#: wrapped call is timed, so the stages add up to at most the total
_OUTERMOST_ONLY = {"sz3_chunked", "sz3_lr", "sz3_interp", "sz3_v1_log", "sz3_pwr", "sz3_fast_pwrel",
                   "pastri", "sz3_aps_low", "sz3_aps_high", "sz3_truncation"}


def stage_breakdown(pipeline: str, x: torch.Tensor, conf, make=None) -> dict:
    """Seconds per stage in one more compress and one more decompress: the
    stage functions are wrapped for this run only (synchronising around
    each), and the two directions are reported apart.  ``make`` builds the
    compressor (default: the pipeline's factory)."""
    import repro_torch.core as tc

    make = make or tc.PIPELINES[pipeline]
    spent: dict = {}
    saved = []
    depth = [0]

    def wrap(fn, label):
        def timed(*a, **k):
            if depth[0] and pipeline in _OUTERMOST_ONLY:
                return fn(*a, **k)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                depth[0] -= 1
            spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for owner, attr, label in _stage_patches(pipeline):
        fn = owner.__dict__[attr]
        saved.append((owner, attr, fn))
        wrapped = wrap(fn.__func__ if isinstance(fn, staticmethod) else fn, label)
        setattr(owner, attr, staticmethod(wrapped) if isinstance(fn, staticmethod) else wrapped)
    try:
        blob, t_c = _timed(lambda: make().compress(x, conf).blob)
        compress = dict(spent, total=t_c)
        spent.clear()
        _, t_d = _timed(lambda: tc.decompress(blob))
        decompress = dict(spent, total=t_d)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return {"compress": compress, "decompress": decompress}


def phase_host_route(seed: int) -> None:
    """Small 3-D fields take the host routes on the card: the same bytes as
    on the CPU (for sz3_transform, through the float64 axis kernel along a
    middle axis too)."""
    import repro_torch.core as tc

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.cumsum(torch.randn((16, 40, 60), generator=g, device="cuda"), dim=2)
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=1e-3)
    for pipeline in ("sz3_lorenzo", "sz3_transform"):
        factory = tc.PIPELINES[pipeline]
        card = factory().compress(x, conf).blob
        cpu = factory(device="cpu").compress(x.cpu(), conf).blob
        if card != cpu:
            raise AssertionError(f"host route: {pipeline}'s blob on the card differs from the CPU's")
        out = tc.decompress(card)
        err = float((out.double() - x.double()).abs().max())
        if err > 1e-3:
            raise AssertionError(f"host route: {pipeline} max error {err} breaks the bound 1e-3")
        emit(f"host route 3-D {pipeline}", shape=list(x.shape), same_bytes_as_cpu=True, max_abs_err=err)
    # an axis that pads to exactly 4 (numpy's BLAS dgemv orders): the float64
    # product still runs on the card, on the kernel route (3x5000) and on the
    # host route (16x3x60), and the blob is the CPU's
    from repro_torch.kernels.transform import kernel as TK

    for shape, route in (((3, 5000), "force"), ((16, 3, 60), "auto")):
        y = torch.cumsum(torch.randn(shape, generator=g, device="cuda"), dim=-1)
        TK.reset_launches()
        card = tc.sz3_transform().compress(y, conf).blob
        if TK.LAUNCHES["axis_f64"] == 0:
            raise AssertionError(f"sz3_transform at {shape}: the float64 product did not run on the card")
        if card != tc.sz3_transform(device="cpu", route=route).compress(y.cpu(), conf).blob:
            raise AssertionError(f"sz3_transform at {shape}: the card's blob differs from the CPU's")
        err = float((tc.decompress(card).double() - y.double()).abs().max())
        if err > 1e-3:
            raise AssertionError(f"sz3_transform at {shape}: max error {err} breaks the bound 1e-3")
        emit("axis of 4 sz3_transform", shape=list(shape), same_bytes_as_cpu=True, max_abs_err=err)


def qwen_tree(seed: int, scale: float, layers: int = QWEN["layers"]) -> dict:
    """A tree with Qwen1.5-0.5B's full parameter shapes, as the JAX
    package's ``init_lm`` lays it out (layers stacked under ``blocks``),
    filled on the card from ``seed``: 463,987,712 float32 values at the full
    24 layers."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    L, d, ff = layers, QWEN["d"], QWEN["ff"]

    def leaf(*shape):
        return torch.randn(shape, generator=g, device="cuda") * scale

    return {
        "embed": leaf(QWEN["vocab"], d),
        "final_norm": {"w": leaf(d)},
        "blocks": {
            "ln1": {"w": leaf(L, d)},
            "ln2": {"w": leaf(L, d)},
            "attn": {"wq": leaf(L, d, d), "wk": leaf(L, d, d), "wv": leaf(L, d, d), "wo": leaf(L, d, d),
                     "bq": leaf(L, d), "bk": leaf(L, d), "bv": leaf(L, d)},
            "mlp": {"w1": leaf(L, d, ff), "w3": leaf(L, d, ff), "w2": leaf(L, ff, d)},
        },
    }


def codes_equal_host(c, x: torch.Tensor, pol, chunk: int = 1 << 26) -> int:
    """The card's fixed-tier codes of flat ``x`` against the numpy mirror
    ``encode_host`` on the host copy, chunk by chunk (block-aligned chunks:
    each block is encoded on its own, and the last chunk ends where ``x``
    ends, so its edge padding is the whole vector's).  Returns the blocks
    compared; raises on the first difference."""
    from repro_torch.core import jitmode as J

    host = x.cpu().numpy()
    chunk -= chunk % pol.bs
    fields = {f: getattr(c, f).cpu() for f in ("codes", "scale", "tags", "base")}
    blocks = 0
    for start in range(0, host.size, chunk):
        h = J.encode_host(host[start : start + chunk], pol)
        b0 = start // pol.bs
        for f, card in fields.items():
            want = getattr(h, f)
            if not same_bits(card[b0 : b0 + want.shape[0]], want):
                raise AssertionError(f"{f} of blocks {b0}..{b0 + want.shape[0]} differ from encode_host")
        blocks += h.scale.shape[0]
    if blocks != c.scale.shape[0]:
        raise AssertionError(f"compared {blocks} blocks of {c.scale.shape[0]}")
    return blocks


def block_error_over_bound(c, x: torch.Tensor) -> float:
    """max over blocks of max |decode - x| / bound()."""
    from repro_torch.core import jitmode as J

    err = (J.decode(c) - x).abs()
    nb = c.scale.shape[0]
    err = torch.nn.functional.pad(err, (0, nb * c.bs - c.n)).reshape(nb, c.bs).amax(dim=1)
    return float((err / c.bound()).max())


def phase_dp_step(seed: int) -> None:
    """The compressed data-parallel reduction on a one-rank NCCL group, then
    three AdamW steps with compressed moments, at Qwen1.5-0.5B's shapes."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.compression import grad as G
    from repro_torch.compression import opt_state as OS
    from repro_torch.core import jitmode as J
    from repro_torch.optim import adamw

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    grads = qwen_tree(seed + 20, 1e-3)
    leaves, _ = tree_util.flatten(grads)
    n = sum(leaf.numel() for leaf in leaves)
    if n != 463_987_712:
        raise AssertionError(f"the Qwen1.5-0.5B tree holds {n} parameters, not 463,987,712")
    largest = max(leaves, key=lambda t: t.numel())
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        store = dist.FileStore(str(pathlib.Path(tmp) / "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            # NCCL sets up its communicator at the first collective: not timed
            warm = {"w": torch.ones(4096, device="cuda")}
            G.compressed_reduce_tree(warm, G.init_feedback(warm, 1), None, "int8:bs=512")
            for spec in ("int8:bs=512", "int4:bs=512"):
                pol = G.as_policy(spec)
                fb = G.init_feedback(grads, 1)
                out, t_reduce = _timed(lambda: G.compressed_reduce_tree(grads, fb, None, pol))
                out_tree, new_fb = out
                # dp = 1: the shard is the bf16-rounded flat vector; the
                # reduction's output and feedback are its decode and residual
                shard = G._flatten_tree(grads)[0].to(torch.bfloat16).to(torch.float32)
                c, t_enc = _timed(lambda: J.encode(shard, pol))
                dec, t_dec = _timed(lambda: J.decode(c))
                flat_out = G._flatten_tree(out_tree)[0]
                if not (same_bits(flat_out, dec) and same_bits(new_fb, shard - dec)):
                    raise AssertionError(f"{spec}: the reduction's output or feedback is not its codes' decode")
                ratio = block_error_over_bound(c, shard)
                if not ratio <= 1.0:
                    raise AssertionError(f"{spec}: a block's error is {ratio} times its bound")
                blocks = codes_equal_host(c, shard, pol)
                c_leaf = J.encode(largest.reshape(-1), pol)
                leaf_blocks = codes_equal_host(c_leaf, largest.reshape(-1), pol)
                wire = G.collective_bytes(n, 1, pol)
                if c.wire_bytes() != wire["ag_bytes"]:
                    raise AssertionError(f"{spec}: {c.wire_bytes()} code bytes, the byte model says {wire['ag_bytes']}")
                emit(
                    f"dp step {spec}",
                    parameters=n,
                    reduce_s=t_reduce,
                    encode_s=t_enc,
                    decode_s=t_dec,
                    encode_GBps=4 * n / t_enc / 1e9,
                    decode_GBps=4 * n / t_dec / 1e9,
                    wire_bytes=wire,
                    max_block_error_over_bound=ratio,
                    blocks_equal_to_encode_host=blocks,
                    largest_leaf=list(largest.shape),
                    largest_leaf_blocks_equal_to_encode_host=leaf_blocks,
                    peak_device_bytes=torch.cuda.max_memory_allocated(),
                )
                del out, out_tree, new_fb, shard, c, dec, flat_out, c_leaf
        finally:
            dist.destroy_process_group()
    del grads, leaves, largest
    # three AdamW steps with compressed moments on the same shapes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = qwen_tree(seed + 21, 0.02)
    cfg = adamw.AdamWConfig(lr=1e-3, compress_moments=True, moment_policy="int8:bs=256")
    state = adamw.init_state(params, cfg)
    steps = []
    for step in range(3):
        g = qwen_tree(seed + 30 + step, 1e-3)
        (params, state, met), t_step = _timed(lambda: adamw.update(params, g, state, cfg))
        steps.append({"seconds": t_step, "grad_norm": float(met["grad_norm"])})
        del g
    p_leaves = tree_util.flatten(params)[0]
    if not all(bool(torch.isfinite(p).all()) for p in p_leaves):
        raise AssertionError("AdamW with compressed moments gave non-finite parameters")
    moments = [c for k in ("m", "v") for c in tree_util.flatten(state[k])[0]]
    if not all(isinstance(c, OS.Compressed) for c in moments):
        raise AssertionError("AdamW state holds uncompressed moments")
    moment_bytes = sum(c.nbytes() for c in moments)
    emit(
        "adamw compressed moments",
        parameters=n,
        policy=cfg.moment_policy,
        steps=steps,
        moment_bytes=moment_bytes,
        float32_moment_bytes=2 * 4 * n,
        moment_ratio=2 * 4 * n / moment_bytes,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
    )


def phase_kv_path(seed: int, launches_total: dict) -> None:
    """Prefill codes for one layer's K and V, then the V cache through the
    KV-quantization kernels: the kernels' main path."""
    from repro_torch.compression import kvcache as KVC
    from repro_torch.core import jitmode as J
    from repro_torch.kernels.kvquant import ops as kvops
    from repro_torch.kernels.kvquant import ref as R

    T, H, hd = QWEN["context"], QWEN["kv_heads"], QWEN["hd"]
    k = v_cache((1, T, H, hd), seed + 40)
    v = v_cache((1, T, H, hd), seed + 41)
    a = attention_rows(KV_QUERIES, T, seed + 42)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    prefill = {}
    for name, x in (("k", k), ("v", v)):
        c = KVC.quantize_prefill(x)
        back = KVC.dequantize_prefill(c)
        prefill[name] = (c, back)
    v_cache_2d = v.reshape(T, H * hd)
    q, scale = kvops.kv_quantize(v_cache_2d)
    out = kvops.kv_dequant_matmul(a, q, scale)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    for name in ("absmax", "quantize_with_scale", "dequant_matmul"):
        if launches[name] == 0:
            raise AssertionError(f"KV path: kernel {name} was not launched")
        launches_total[name] += launches[name]
    report = {}
    for name, x in (("k", k), ("v", v)):
        c, back = prefill[name]
        err = (back - x).abs().amax(dim=-1)  # one block per token vector
        ratio = float((err / c.bound()[..., 0]).max())
        if not ratio <= 1.0:
            raise AssertionError(f"KV prefill {name}: a token's error is {ratio} times its bound")
        flat = J.BlockCodes(codes=c.codes.reshape(-1, c.codes.shape[-1]), scale=c.scale.reshape(-1),
                            tags=c.tags.reshape(-1), base=c.base.reshape(-1), n=x.numel(), bits=c.bits, bs=hd)
        blocks = codes_equal_host(flat, x.reshape(-1), KVC.prefill_policy(hd))
        report[name] = {"max_token_error_over_bound": ratio, "blocks_equal_to_encode_host": blocks}
    q_plain, s_plain = R.quantize(v_cache_2d)
    if not (torch.equal(q, q_plain) and same_bits(scale, s_plain)):
        raise AssertionError("KV path: kv_quantize differs from its plain version")
    ratio = f64_matmul_check(out, a, q, scale)
    if not ratio <= 1.0:
        raise AssertionError(f"KV path: kv_dequant_matmul error is {ratio} times the float64 bound")
    deq_err = float((R.dequantize(q, scale) - v_cache_2d).abs().div(scale[None, :] * 0.5).max())
    if not deq_err <= 1.0002:  # scale/2, and the JAX test's 0.5001 for the product's rounding
        raise AssertionError(f"KV path: kv_quantize error is {deq_err} times half the scale")
    emit(
        "kv path",
        shape=[1, T, H, hd],
        seconds=seconds,
        prefill=report,
        prefill_code_bytes=sum(c.codes.numel() + 9 * c.scale.numel() for c, _ in prefill.values()),
        float32_bytes=2 * 4 * k.numel(),
        kv_quantize_error_over_half_scale=deq_err,
        dequant_matmul_shape=[KV_QUERIES, T, H * hd],
        dequant_matmul_err_over_f64_bound=ratio,
        launches={n: c for n, c in launches.items() if c},
    )


# ---------------------------------------------------------------------------
# pointwise-relative bounds, GAMESS and APS (paper §4, §5.2, §6.2)
# ---------------------------------------------------------------------------

#: GAMESS ERI-like stream: 70,000 blocks of the 96-value pattern (53.76 MB
#: of float64), ABS 1e-10, the pattern length benchmarks/bench_gamess.py
#: passes; cut from 200,000 blocks, where the phase took 74 s
GAMESS_BLOCKS, GAMESS_PATTERN, GAMESS_EB = 70_000, 96, 1e-10
#: APS photon-count stack: frames x 256 x 256 float32; cut from 512
#: frames, where the phase took 45 s
APS_SHAPE = (256, 256, 256)


def pw_rel_field(x2d: torch.Tensor, seed: int) -> torch.Tensor:
    """The 2-D field with what a pointwise-relative bound must carry
    written in: a band of negative rows and scattered negatives, exact
    zeros, NaN, +-inf and float32 subnormals."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = x2d.clone()
    y[600:700] *= -1
    n = y.numel()
    flat = y.view(-1)
    pick = torch.randperm(n, generator=g, device="cuda")
    flat[pick[:5000]] *= -1
    flat[pick[5000:5200]] = 0.0
    flat[pick[5200:5203]] = float("nan")
    flat[pick[5203:5206]] = float("inf")
    flat[pick[5206:5209]] = float("-inf")
    flat[pick[5209:5215]] = torch.tensor([1e-40, -3e-42, 1e-45, 2e-39, -1e-41, 5e-44], device="cuda")
    return y


def pointwise_check(label: str, out: torch.Tensor, x: torch.Tensor, eb: float) -> float:
    """max |x^ - x| / |x| over finite nonzero points (must be <= eb); zeros
    exact; non-finite values (and the subnormals LogTransform escapes)
    bit-exact.  Returns the maximum."""
    if out.shape != x.shape or out.dtype != x.dtype:
        raise AssertionError(f"{label}: decoded {tuple(out.shape)} {out.dtype}, not {tuple(x.shape)} {x.dtype}")
    x64, o64 = x.double(), out.double()
    fin = torch.isfinite(x64) & (x64 != 0)
    rel = float(((o64 - x64).abs()[fin] / x64.abs()[fin]).max())
    if not rel <= eb:
        raise AssertionError(f"{label}: pointwise error {rel} breaks the bound {eb}")
    if not bool((o64[x64 == 0] == 0).all()):
        raise AssertionError(f"{label}: a zero did not decode to zero")
    raw = ~torch.isfinite(x64) | (fin & (x64.abs() < torch.finfo(x.dtype).tiny))
    if not same_bits(out[raw], x[raw]):
        raise AssertionError(f"{label}: non-finite or subnormal values are not bit-exact")
    return rel


def log2_mismatches(y: torch.Tensor) -> dict:
    """Finite nonzero elements where torch.log2 on the card (float64)
    differs from numpy.log2 on the host: a finding, nothing switches on it."""
    mag = y.double().abs()
    mag = mag[torch.isfinite(mag) & (mag > 0)]
    card = torch.log2(mag).cpu().numpy()
    host = np.log2(mag.cpu().numpy())
    diff = card.view(np.int64) != host.view(np.int64)
    ulps = np.abs(card.view(np.int64) - host.view(np.int64))[diff]
    return {"elements": int(mag.numel()), "differ": int(diff.sum()), "max_ulps": int(ulps.max()) if ulps.size else 0}


def _path_line(label, x, res, t_c, t_d, requested_lossless, **fields) -> None:
    from repro_torch.core import lossless

    mb = x.numel() * x.element_size() / 1e6
    emit(label, shape=list(x.shape), dtype=str(x.dtype).replace("torch.", ""), ratio=res.ratio,
         blob_bytes=len(res.blob), lossless=lossless.effective_backend(requested_lossless),
         compress_s=t_c, decompress_s=t_d, compress_MBps=mb / t_c, decompress_MBps=mb / t_d, **fields)


def phase_pw_rel(x2d: torch.Tensor, seed: int, launches_total: dict) -> None:
    """PW_REL 1e-3 on the field with signs, zeros, NaN, +-inf and
    subnormals: v1 LorenzoPredictor under LogTransform, sz3_pwr (4 MiB
    chunks, workers 1 and 4) and sz3_fast.  The log field is float64, so
    the Lorenzo paths take the host route (plain torch on the card's
    tensors) and launch no kernel; sz3_fast classifies its float32 cast
    with block_stats, once per block batch."""
    import repro_torch.core as tc
    from repro_torch.core import fastmode, predictors, preprocess

    y = pw_rel_field(x2d, seed + 30)
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.PW_REL, eb=1e-3)
    y_cpu = y.cpu()
    emit("pw_rel log2 on the card", field=list(y.shape), **log2_mismatches(y))

    def v1(device="cuda"):
        return tc.SZ3Compressor(preprocessor=preprocess.LogTransform(), predictor=predictors.LorenzoPredictor(), device=device)

    runs = [
        ("v1 LogTransform + LorenzoPredictor", v1, lambda: v1("cpu"), {}, "sz3_v1_log"),
        ("sz3_pwr", lambda: tc.sz3_pwr(), lambda: tc.sz3_pwr(device="cpu"), {}, "sz3_pwr"),
        ("sz3_fast", lambda: tc.sz3_fast(), lambda: tc.sz3_fast(device="cpu", route="force"),
         {"block_stats": 1}, "sz3_fast_pwrel"),
    ]
    for name, make, make_plain, want, stage_key in runs:
        make().compress(y[:64].contiguous(), conf)  # warm-up
        reset_all_launches()
        res, t_c = _timed(lambda: make().compress(y, conf, with_stats=True))
        out, t_d = _timed(lambda: tc.decompress(res.blob))
        launches = all_launches()
        for k in ("encode_1d", "decode_1d", "encode_2d", "decode_2d", "block_stats"):
            if launches[k] != want.get(k, 0):
                raise AssertionError(f"pw_rel {name}: kernel {k} launched {launches[k]} times, expected {want.get(k, 0)}")
            launches_total[k] += launches[k]
        rel = pointwise_check(f"pw_rel {name}", out, y, 1e-3)
        plain, t_plain = _timed(lambda: make_plain().compress(y_cpu, conf).blob)
        if plain != res.blob:
            raise AssertionError(f"pw_rel {name}: the card's blob differs from the plain route's")
        extra = {}
        if name == "sz3_pwr":
            chunks = res.meta["chunks"]
            par, t_par = _timed(lambda: tc.sz3_pwr(workers=4).compress(y, conf).blob)
            if par != res.blob:
                raise AssertionError("pw_rel sz3_pwr: the workers=4 blob differs from the serial one")
            out4, t_d4 = _timed(lambda: tc.decompress(res.blob, workers=4))
            if not same_bits(out4, out):
                raise AssertionError("pw_rel sz3_pwr: the workers=4 decode differs from the serial one")
            extra = {"chunks": len(chunks), "picks": [c["pipeline"] for c in chunks],
                     "workers4_compress_s": t_par, "workers4_decompress_s": t_d4, "workers4_same_bytes": True}
        if name == "sz3_fast":
            nb = -(-y.numel() // fastmode.DEFAULT_BS)
            extra = {"blocks": nb, "block_batches": 1, "kernel_route": bool(res.meta["device"])}
        header = tc.parse_header(res.blob)[0]
        _path_line(f"pw_rel {name}", y, res, t_c, t_d, "none" if name == "sz3_fast" else "zstd",
                   mode="pw_rel", eb=1e-3, max_pointwise_rel_err=rel, zeros_exact=True, nonfinite_bit_exact=True,
                   same_bytes_as_plain=True, plain_cpu_compress_s=t_plain,
                   preprocessor=header.get("spec", {}).get("preprocessor", "log (per chunk)"),
                   launches={k: v for k, v in launches.items() if v}, **extra,
                   stages=stage_breakdown(stage_key, y, conf, make))


def gamess_stream(seed: int) -> torch.Tensor:
    """An ERI-like float64 stream made on the card, with the structure of
    the repository's GAMESS generator: a 96-value pattern scaled per block
    (log-normal scales), residuals a few bins wide at eb, and 15% of the
    blocks non-conforming (a second pattern added)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb, P, eb = GAMESS_BLOCKS, GAMESS_PATTERN, GAMESS_EB
    kw = {"device": "cuda", "dtype": torch.float64}
    t = torch.linspace(0, 1, P, **kw)
    base = torch.exp(-6 * t) * torch.sin(24 * t) + 0.3 * torch.exp(-9 * t) * torch.cos(53 * t)
    scales = torch.exp(-6.0 + 2.5 * torch.randn(nb, generator=g, **kw))
    x = scales[:, None] * base[None, :] + 15.0 * eb * torch.randn((nb, P), generator=g, **kw)
    bad = torch.rand(nb, generator=g, **kw) < 0.15
    alt = torch.exp(-3 * t) * torch.cos(31 * t + 0.7)
    alt_scales = torch.exp(-9.0 + 1.5 * torch.randn(nb, generator=g, **kw))
    x[bad] += alt_scales[bad, None] * alt[None, :]
    return x.reshape(-1).contiguous()


def phase_gamess(seed: int) -> None:
    """sz_pastri, sz_pastri_zstd and sz3_pastri at ABS 1e-10 on the ERI-like
    stream: no kernel; the quantization runs on the card, the pattern's
    float64 reductions as numpy computes them, the coding on the host.  A
    slice with NaN and -inf written in must give the plain route's bytes
    too: a NaN's prediction error reaches the unpred-aware quantizer's
    float-to-int64 cast, which the port pins to x86 numpy's answer."""
    import repro_torch.core as tc

    x = gamess_stream(seed + 50)
    x_cpu = x.cpu()
    x_nan = x[: 20000 * GAMESS_PATTERN].clone()
    x_nan[torch.tensor([5, 777, 500_000, 1_234_567])] = torch.tensor(
        [float("nan"), float("nan"), float("-inf"), float("nan")], dtype=x.dtype, device=x.device)
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=GAMESS_EB)
    ratios = {}
    for name, lossless_name in (("sz_pastri", "none"), ("sz_pastri_zstd", "zstd"), ("sz3_pastri", "zstd")):
        make = lambda: tc.PIPELINES[name](pattern_size=GAMESS_PATTERN)  # noqa: E731
        make().compress(x[: 64 * GAMESS_PATTERN], conf)  # warm-up
        reset_all_launches()
        res, t_c = _timed(lambda: make().compress(x, conf, with_stats=True))
        out, t_d = _timed(lambda: tc.decompress(res.blob))
        launches = all_launches()
        if any(launches.values()):
            raise AssertionError(f"gamess {name}: a kernel launched on a path that has none: {launches}")
        nan_blob = make().compress(x_nan, conf).blob
        nan_plain = tc.PIPELINES[name](pattern_size=GAMESS_PATTERN, device="cpu").compress(x_nan.cpu(), conf).blob
        if nan_blob != nan_plain or not same_bits(tc.decompress(nan_blob).cpu(), tc.decompress(nan_plain, device="cpu")):
            raise AssertionError(f"gamess {name}: on NaN input the card's blob or decode differs from the plain route's")
        err = float((out - x).abs().max())
        if out.shape != x.shape or not err <= GAMESS_EB:
            raise AssertionError(f"gamess {name}: max error {err} breaks the bound {GAMESS_EB}")
        plain, t_plain = _timed(lambda: tc.PIPELINES[name](pattern_size=GAMESS_PATTERN, device="cpu").compress(x_cpu, conf).blob)
        if plain != res.blob:
            raise AssertionError(f"gamess {name}: the card's blob differs from the plain route's")
        codes = torch.from_numpy(res.codes.astype(np.int64))
        sec = res.meta["sections"]
        ratios[name] = res.ratio
        _path_line(f"gamess {name}", x, res, t_c, t_d, lossless_name, mode="abs", eb=GAMESS_EB,
                   max_abs_err=err, same_bytes_as_plain=True, plain_cpu_compress_s=t_plain,
                   nan_input_same_bytes_as_plain=True, launches=sum(launches.values()),
                   pattern=res.meta["P"], blocks=res.meta["nb"],
                   unpredictable_share=float((codes[sec[0] + sec[1]:] == 0).double().mean()),
                   stages=stage_breakdown("pastri", x, conf, make) if name != "sz_pastri_zstd" else None)
    order = sorted(ratios, key=ratios.get, reverse=True)
    emit("gamess ratio order", observed=order, paper_table1=["sz3_pastri", "sz_pastri_zstd", "sz_pastri"],
         as_in_the_paper=order == ["sz3_pastri", "sz_pastri_zstd", "sz_pastri"], ratios=ratios)


def aps_stack(seed: int, shape=APS_SHAPE) -> torch.Tensor:
    """A photon-count stack made on the card, with the structure of the
    repository's APS generator: Poisson counts under a bright centre, a
    speckle field drifting slowly in time (strong temporal, weak spatial
    correlation)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames, h, w = shape
    kw = {"device": "cuda", "dtype": torch.float64}
    yy = torch.arange(h, **kw)[:, None]
    xx = torch.arange(w, **kw)[None, :]
    r2 = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2) / (0.08 * h * w)
    envelope = 40.0 * torch.exp(-r2)
    phase = torch.randn((h, w), generator=g, **kw)
    drift = 0.05 * torch.randn((h, w), generator=g, **kw)
    out = torch.empty(shape, device="cuda", dtype=torch.float32)
    for f0 in range(0, frames, 64):
        t = torch.arange(f0, min(frames, f0 + 64), **kw)[:, None, None]
        speckle = torch.fft.ifft2(torch.fft.fft2(torch.exp(1j * (phase + t * drift))) * torch.exp(-r2)).abs()
        peak = speckle.amax(dim=(1, 2), keepdim=True).clamp_min(1e-9)
        out[f0 : f0 + t.shape[0]] = torch.poisson(envelope * (0.2 + speckle / peak), generator=g).float()
    return out


def phase_aps(seed: int, launches_total: dict) -> None:
    """sz3_aps below its threshold (ABS 0.25: transpose to time-innermost,
    one 1-D float32 Lorenzo row through encode_1d and decode_1d, integer
    counts decode exactly), above it (ABS 2.0: the 3-D composite) and
    sz3_truncation(keep_bytes=2), each against the plain route."""
    import repro_torch.core as tc

    x = aps_stack(seed + 60)
    x_cpu = x.cpu()
    runs = [
        ("sz3_aps low", 0.25, lambda: tc.sz3_aps(), lambda: tc.sz3_aps(device="cpu", route="force"),
         {"encode_1d": 1, "decode_1d": 2}, "sz3_aps_low", "zstd"),
        ("sz3_aps high", 2.0, lambda: tc.sz3_aps(), lambda: tc.sz3_aps(device="cpu"), {}, "sz3_aps_high", "zstd"),
        ("sz3_truncation", None, lambda: tc.sz3_truncation(keep_bytes=2),
         lambda: tc.sz3_truncation(keep_bytes=2, device="cpu"), {}, "sz3_truncation", "none"),
    ]
    for name, eb, make, make_plain, want, stage_key, lossless_name in runs:
        conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=eb or 1.0)
        make().compress(x[:2].contiguous(), conf)  # warm-up
        reset_all_launches()
        res, t_c = _timed(lambda: make().compress(x, conf))
        out, t_d = _timed(lambda: tc.decompress(res.blob))
        launches = all_launches()
        for k in ("encode_1d", "decode_1d", "encode_2d", "decode_2d"):
            if launches[k] != want.get(k, 0):
                raise AssertionError(f"aps {name}: kernel {k} launched {launches[k]} times, expected {want.get(k, 0)}")
            launches_total[k] += launches[k]
        if out.shape != x.shape or out.dtype != x.dtype:
            raise AssertionError(f"aps {name}: decoded {tuple(out.shape)} {out.dtype}")
        check = {}
        if name == "sz3_aps low":
            if not torch.equal(out, x):
                raise AssertionError("aps sz3_aps low: the integer counts did not decode exactly")
            check = {"exact": True, "abs_eb": tc.parse_header(res.blob)[0]["abs_eb"]}
        elif name == "sz3_aps high":
            err = float((out.double() - x.double()).abs().max())
            if not err <= eb:
                raise AssertionError(f"aps sz3_aps high: max error {err} breaks the bound {eb}")
            check = {"max_abs_err": err}
        else:  # the two most significant bytes of each value, the rest zero
            if not torch.equal(out.view(torch.int32), x.view(torch.int32) & -65536):
                raise AssertionError("aps sz3_truncation: decode is not the input's top two bytes")
            check = {"top_bytes_exact": True}
        plain, t_plain = _timed(lambda: make_plain().compress(x_cpu, conf).blob)
        if plain != res.blob:
            raise AssertionError(f"aps {name}: the card's blob differs from the plain route's")
        _path_line(f"aps {name}", x, res, t_c, t_d, lossless_name, mode="abs" if eb else None, eb=eb,
                   same_bytes_as_plain=True, plain_cpu_compress_s=t_plain, **check,
                   launches={k: v for k, v in launches.items() if v},
                   stages=stage_breakdown(stage_key, x, conf, make))


#: the block hybrid's 3-D input: the shape of an SDRBench Hurricane-ISABEL
#: field (100 x 500 x 500 float32 per variable), at ABS 2^-8
HYBRID_3D_SHAPE = (100, 500, 500)
HYBRID_3D_EB = 2.0**-8
#: side of the regime tiles written into it (a multiple of its 8^3 blocks)
HYBRID_TILE = 32


def hybrid_field_3d(seed: int, shape=HYBRID_3D_SHAPE) -> torch.Tensor:
    """A smooth float32 3-D field (plane waves plus small noise) with
    32^3 regime tiles written in, cycling through exact zeros and
    zero-mean noise (the zero tag's turf), steep ramps with noise of one
    bound (regression's), a quadratic (Lorenzo-1's: its third difference
    vanishes inside a block) and a trilinear product i*j*k on the
    quantization grid (Lorenzo-2's: Lorenzo-1 leaves its constant third
    difference); the smooth rest is Lorenzo-1's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = {"device": "cuda", "dtype": torch.float64}
    d0, d1, d2 = shape
    z = torch.linspace(0, 1, d0, **kw)[:, None, None]
    y = torch.linspace(0, 1, d1, **kw)[None, :, None]
    x = torch.linspace(0, 1, d2, **kw)[None, None, :]
    f = torch.zeros(shape, **kw)
    for _ in range(4):
        kz, ky, kx, ph = torch.rand(4, generator=g, **kw)
        f += 5.0 * torch.sin(2 * math.pi * ((1 + 3 * kz) * z + (1 + 3 * ky) * y + (1 + 3 * kx) * x) + 6.3 * ph)
    f += 1e-3 * torch.randn(shape, generator=g, **kw)
    t, eb = HYBRID_TILE, HYBRID_3D_EB
    i = torch.arange(t, **kw)
    ii, jj, kk = i[:, None, None], i[None, :, None], i[None, None, :]
    regimes = (
        lambda: torch.zeros((t, t, t), **kw),
        lambda: 0.3 * torch.randn((t, t, t), generator=g, **kw),
        lambda: 0.05 * ii + 0.03 * jj + 0.02 * kk + eb * torch.randn((t, t, t), generator=g, **kw),
        lambda: 2.0 * eb * (ii * ii + jj * jj + kk * kk),
        lambda: 2.0 * eb * ii * jj * kk,
        None,
    )
    n = 0
    for z0 in range(0, d0 - t + 1, t):
        for y0 in range(0, d1 - t + 1, 2 * t):
            for x0 in range(0, d2 - t + 1, 2 * t):
                make = regimes[n % len(regimes)]
                n += 1
                if make is not None:
                    f[z0 : z0 + t, y0 : y0 + t, x0 : x0 + t] = make()
    return f.to(torch.float32)


def gamma_mismatches(make, x: torch.Tensor, conf) -> dict:
    """One more compress, in which every gamma length the card computes
    (``blockwise._gamma_bits``) is held against numpy's
    ``2*log2(1+|q|)+1`` on a host copy of the same codes."""
    from repro_torch.core import blockwise

    fn = blockwise._gamma_bits
    tally = {"values": 0, "differ": 0}

    def checked(q):
        out = fn(q)
        host = 2.0 * np.log2(1.0 + np.abs(q.double().cpu().numpy())) + 1.0
        tally["values"] += host.size
        tally["differ"] += int((out.cpu().numpy().view(np.int64) != host.view(np.int64)).sum())
        return out

    blockwise._gamma_bits = checked
    try:
        make().compress(x, conf)
    finally:
        blockwise._gamma_bits = fn
    return tally


def phase_hybrid(x2d: torch.Tensor, x1d: torch.Tensor, seed: int) -> None:
    """sz3_hybrid compressing and decompressing on the card: the field at
    REL 1e-4 and at ABS 1e-3 of its range, the series at REL 1e-4, the
    Hurricane-shaped 3-D field with regime tiles at ABS 2^-8 and the
    PW_REL field at PW_REL 1e-3.  No kernel launches (the contest is plain
    torch); each blob equals the plain route's, each decode keeps its
    bound, and no gamma length differs from numpy's."""
    import repro_torch.core as tc

    mode = tc.ErrorBoundMode
    rel = tc.CompressionConfig(mode=mode.REL, eb=1e-4)
    field_range = float(x2d.max() - x2d.min())
    runs = [
        ("field rel", lambda: x2d, rel),
        ("field abs", lambda: x2d, tc.CompressionConfig(mode=mode.ABS, eb=1e-3 * field_range)),
        ("series rel", lambda: x1d, rel),
        ("3-D field abs", lambda: hybrid_field_3d(seed + 70), tc.CompressionConfig(mode=mode.ABS, eb=HYBRID_3D_EB)),
        ("pw_rel field", lambda: pw_rel_field(x2d, seed + 30), tc.CompressionConfig(mode=mode.PW_REL, eb=1e-3)),
    ]
    make = tc.sz3_hybrid
    make().compress(x2d[:64].contiguous(), rel)  # warm-up
    for label, data, conf in runs:
        x = data()
        reset_all_launches()
        res, t_c = _timed(lambda: make().compress(x, conf, with_stats=True))
        out, t_d = _timed(lambda: tc.decompress(res.blob))
        launches = all_launches()
        if any(launches.values()):
            raise AssertionError(f"hybrid {label}: a kernel launched on a path that has none: {launches}")
        if conf.mode == mode.PW_REL:
            check = {"max_pointwise_rel_err": pointwise_check(f"hybrid {label}", out, x, conf.eb),
                     "zeros_exact": True, "nonfinite_bit_exact": True}
        else:
            abs_eb = tc.parse_header(res.blob)[0]["abs_eb"]
            if out.shape != x.shape or out.dtype != x.dtype:
                raise AssertionError(f"hybrid {label}: decoded {tuple(out.shape)} {out.dtype}, not {tuple(x.shape)}")
            err = float((out.double() - x.double()).abs().max())
            if not err <= abs_eb:
                raise AssertionError(f"hybrid {label}: max error {err} breaks the bound {abs_eb}")
            check = {"abs_eb": abs_eb, "max_abs_err": err}
        x_cpu = x.cpu()
        plain, t_plain = _timed(lambda: make(device="cpu").compress(x_cpu, conf).blob)
        if plain != res.blob:
            raise AssertionError(f"hybrid {label}: the card's blob differs from the plain route's")
        gamma = gamma_mismatches(make, x, conf)
        if gamma["differ"]:
            raise AssertionError(f"hybrid {label}: {gamma['differ']} of {gamma['values']} gamma lengths differ from numpy's")
        _path_line(f"hybrid {label}", x, res, t_c, t_d, "zstd", mode=conf.mode.value, eb=conf.eb, **check,
                   same_bytes_as_plain=True, plain_cpu_compress_s=t_plain, gamma_values=gamma["values"],
                   gamma_mismatches=gamma["differ"], blocks=res.meta["nb"], tag_shares=res.meta["tag_shares"],
                   nfail=res.meta["nfail"], launches=0, stages=stage_breakdown("sz3_hybrid", x, conf, make))


def phase_auto(x2d: torch.Tensor, x1d: torch.Tensor, launches_total: dict) -> None:
    """sz3_auto at REL 1e-4 on the field and the series: the chunked
    engine's checks (picks, workers=4, exact launches per routed chunk, the
    plain route's bytes chunk by chunk) over the six-way contest."""
    phase_chunked("2-D", x2d, launches_total, engine="sz3_auto")
    phase_chunked("1-D", x1d, launches_total, engine="sz3_auto")


def phase_quality(x2d: torch.Tensor, launches_total: dict) -> None:
    """sz3_quality(target_psnr=60) and sz3_quality(target_ratio=10) on the
    field: the achieved PSNR, the plain route's bytes, the per-chunk
    records, and launches equal to those of the full-chunk compressions
    (each decoded once) that ran on the card."""
    import repro_torch.core as tc
    from repro_torch.core import quality

    x_cpu = x2d.cpu()
    x_host = x_cpu.double().numpy()
    field_range = float(x2d.max() - x2d.min())
    for label, kw in (("psnr 60", {"target_psnr": 60.0}), ("ratio 10", {"target_ratio": 10.0})):
        calls = []
        mse_s = [0.0]
        routed, finite_mse = quality._routed_pipeline, quality._finite_mse

        def counted(name, route, device):
            comp = routed(name, route, device)
            inner = comp.compress

            def compress(data, *a, **k):
                calls.append((name, data.numel()))
                return inner(data, *a, **k)

            comp.compress = compress
            return comp

        def timed_mse(a, b):
            t0 = time.perf_counter()
            try:
                return finite_mse(a, b)
            finally:
                mse_s[0] += time.perf_counter() - t0

        quality._routed_pipeline, quality._finite_mse = counted, timed_mse
        try:
            reset_all_launches()
            res, t_c = _timed(lambda: tc.sz3_quality(**kw).compress(x2d))
            launches = all_launches()
        finally:
            quality._routed_pipeline, quality._finite_mse = routed, finite_mse
        expected = _expected_chunk_launches(calls, x2d.ndim)
        for name, want in expected.items():
            if launches[name] != want:
                raise AssertionError(f"quality {label}: kernel {name} launched {launches[name]} times, "
                                     f"expected {want} for the compressions routed to it")
            launches_total[name] += launches[name]
        out, t_d = _timed(lambda: tc.decompress(res.blob))
        mse = float(np.mean((out.double().cpu().numpy() - x_host) ** 2))
        psnr = 20.0 * math.log10(field_range) - 10.0 * math.log10(mse)
        rec = res.meta["quality"]
        if "target_psnr" in kw and not (rec["achieved_psnr"] >= kw["target_psnr"] and psnr >= kw["target_psnr"] - 1e-9):
            raise AssertionError(f"quality {label}: achieved PSNR {rec['achieved_psnr']} (decode: {psnr}) "
                                 f"is below the target {kw['target_psnr']}")
        plain, t_plain = _timed(lambda: tc.sz3_quality(device="cpu", route="force", **kw).compress(x_cpu).blob)
        if plain != res.blob:
            raise AssertionError(f"quality {label}: the card's blob differs from the plain route's")
        chunks = [{"pipeline": c["pipeline"], "rows": c["n0"], **{k: c["q"][k] for k in ("eb", "iters", "confirms", "bits", "psnr")}}
                  for c in res.meta["chunks"]]
        mb = x2d.numel() * x2d.element_size() / 1e6
        emit(f"quality {label}", shape=list(x2d.shape), target=rec["target"], achieved_psnr=rec["achieved_psnr"],
             decoded_psnr=psnr, achieved_ratio=rec["achieved_ratio"], achieved_bits=rec["achieved_bits"],
             blob_bytes=len(res.blob), compress_s=t_c, decompress_s=t_d, compress_MBps=mb / t_c,
             decompress_MBps=mb / t_d, mse_s=mse_s[0], mse_share=mse_s[0] / t_c,
             full_chunk_compressions=len(calls),
             compressions_by_pipeline_and_rows=dict(collections.Counter(
                 f"{name} {n // math.prod(x2d.shape[1:])}" for name, n in calls)),
             chunks=chunks, same_bytes_as_plain=True,
             plain_cpu_compress_s=t_plain, launches={k: v for k, v in launches.items() if v},
             expected_launches={k: v for k, v in expected.items() if v})


# ---------------------------------------------------------------------------
# telemetry, the checkpoint manager and the KV-offload service
# ---------------------------------------------------------------------------

def _decode_launches(picks, ndim: int) -> dict:
    """Launches a chunked container's decode makes on the card: one
    ``decode_2d`` (or ``decode_1d``) per kernel-routed Lorenzo chunk (the
    transform and fast tiers are not in these paths' contests)."""
    name = "decode_2d" if ndim == 2 else "decode_1d"
    return {name: sum(1 for p, n in picks if p == "sz3_lorenzo" and _takes_kernel_route(p, n))}


def phase_telemetry(x: torch.Tensor, launches_total: dict) -> None:
    """A traced ``sz3_chunked`` compress and decode of the field at one and
    four workers: the traced blobs are equal, each equals the plain route's
    traced blob, ``explain`` reads the same records from both, launches
    equal the chunks routed to the kernels; the trace's stage seconds (its
    spans synchronise the card at exit) beside the phase's wrapped stages."""
    import repro_torch.core as tc
    from repro_torch.core import telemetry

    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    runs = {}
    for workers in (1, 4):
        reset_all_launches()
        with telemetry.trace(f"sz3_chunked workers={workers}") as tr:
            res, t_c = _timed(lambda: tc.sz3_chunked(workers=workers).compress(x, conf, with_stats=True))
        c_totals = tr.stage_totals()
        with telemetry.trace("decompress") as trd:
            out, t_d = _timed(lambda: tc.decompress(res.blob))
        launches = all_launches()
        inner = math.prod(x.shape[1:])
        expected = _expected_chunk_launches([(c["pipeline"], c["n0"] * inner) for c in res.meta["chunks"]], x.ndim)
        for name, want in expected.items():
            if launches[name] != want:
                raise AssertionError(f"telemetry workers={workers}: kernel {name} launched {launches[name]} times, "
                                     f"expected {want} for the chunks routed to it")
            launches_total[name] += launches[name]
        header = tc.parse_header(res.blob)[0]
        if not all("sel" in c for c in header["chunks"]):
            raise AssertionError("a traced chunked blob lacks its sel entries")
        runs[workers] = (res, tr, trd, c_totals, t_c, t_d, out, launches)
    (res1, tr1, trd1, totals1, t_c1, t_d1, out1, launches1), (res4, tr4, *_rest) = runs[1], runs[4]
    if res4.blob != res1.blob:
        raise AssertionError("the traced workers=4 blob differs from the traced serial one")
    x_cpu = x.cpu()
    with telemetry.trace("plain") as trp:
        plain = tc.sz3_chunked(device="cpu", route="force").compress(x_cpu, conf).blob
    if plain != res1.blob:
        raise AssertionError("the card's traced blob differs from the plain route's traced blob")
    records = telemetry.explain(res1.blob)
    if records != telemetry.explain(plain) or [r["winner"] for r in records] != [r["winner"] for r in tr1.decisions]:
        raise AssertionError("explain reads other records from the card's blob than from the plain route's")
    if tr1.decisions != trp.decisions or tr4.decisions != tr1.decisions:
        raise AssertionError("the live decision records differ between the card, workers=4 and the plain route")
    abs_eb = tc.parse_header(_chunk_blobs(res1.blob)[0])[0]["abs_eb"]
    err = float((out1.double() - x.double()).abs().max())
    if err > abs_eb:
        raise AssertionError(f"telemetry: traced decode error {err} breaks the bound {abs_eb}")
    summary = telemetry.trace_summary(tr1)
    print(summary, flush=True)
    emit(
        "telemetry sz3_chunked 2-D",
        shape=list(x.shape),
        chunks=len(res1.meta["chunks"]),
        picks=[c["pipeline"] for c in res1.meta["chunks"]],
        traced_compress_s=t_c1,
        traced_decompress_s=t_d1,
        decisions=len(tr1.decisions),
        explain_records=len(records),
        same_bytes_as_workers4_and_plain_route=True,
        trace_summary=summary.splitlines(),
        trace_compress_stage_seconds={k: v["seconds"] for k, v in totals1.items()},
        trace_decompress_stage_seconds={k: v["seconds"] for k, v in trd1.stage_totals().items()},
        stages=stage_breakdown("sz3_chunked", x, conf),
        launches={k: v for k, v in launches1.items() if v},
        expected_launches={k: v for k, v in expected.items() if v},
        prometheus_lines=len(telemetry.prometheus_text().splitlines()),
        max_abs_err=err,
    )


#: the checkpoint's train state: Qwen1.5-0.5B at full width (d_model 1024,
#: d_ff 2816, vocab 151936, QKV bias, tied embedding), its stacked blocks cut
#: from 24 layers to 2
CKPT_LAYERS = 2
#: chunks of each ``sz3_auto_rel`` leaf held to the plain route's bytes
CKPT_SAMPLE_CHUNKS = 4


def _ckpt_state(seed: int) -> dict:
    """``init_train_state``'s layout: bf16 params, float32 AdamW moments
    after two steps of the port's ``adamw.update`` on gradients made on the
    card, and the step."""
    from repro_torch import tree as tree_util
    from repro_torch.optim import adamw

    params = tree_util.tree_map(lambda t: t.to(torch.bfloat16), qwen_tree(seed + 50, 0.02, CKPT_LAYERS))
    cfg = adamw.AdamWConfig(lr=1e-3)
    opt = adamw.init_state(params, cfg)
    for step in range(2):
        grads = qwen_tree(seed + 51 + step, 1e-3, CKPT_LAYERS)
        params, opt, _ = adamw.update(params, grads, opt, cfg)
        del grads
    return {"params": params, "opt": opt}


def _leaf_blob_abs_eb(blob: bytes) -> float:
    """The bound a lossy leaf's container records (its first v1 body's)."""
    import repro_torch.core as tc

    header, _ = tc.parse_header(blob)
    return tc.parse_header(_chunk_blobs(blob)[0])[0]["abs_eb"] if "chunks" in header else header["abs_eb"]


def _ckpt_expected_launches(manifest: dict, files: dict) -> dict:
    """Launches of one save and one restore: each lossy leaf's Lorenzo
    compress and decode (the leaf reshaped to (rows, -1)), or its chunks'."""
    import repro_torch.core as tc

    picks = []
    for meta in manifest["leaves"].values():
        shape = meta["shape"]
        inner = math.prod(shape[1:]) if len(shape) > 1 else 1
        if meta["codec"] == "sz3_lorenzo_rel" and len(shape) > 1:
            picks.append(("sz3_lorenzo", math.prod(shape)))
        elif meta["codec"] == "sz3_auto_rel":
            header = tc.parse_header(files[meta["file"]])[0]
            picks += [(c["pipeline"], c["n0"] * inner) for c in header["chunks"]]
    return _expected_chunk_launches(picks, 2), picks


def _ckpt_plain_sample(manifest: dict, files: dict, leaves: dict) -> dict:
    """The sampled leaf blobs against the plain route on the host: one leaf
    of each whole-leaf codec (the largest ``sz3_lorenzo_rel`` leaf, the
    smallest lossless one), and ``CKPT_SAMPLE_CHUNKS`` chunks (first, last
    and two between) of every ``sz3_auto_rel`` leaf, through the chunked
    engine's own per-chunk path (selection included)."""
    import repro_torch.core as tc
    from repro_torch.core import pipeline
    from repro_torch.core.chunking import ChunkedCompressor
    from repro_torch.ft import checkpoint as ck

    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    def preference(meta):
        n = math.prod(meta["shape"])
        return n if meta["codec"] == "sz3_lorenzo_rel" else -n

    jobs = []
    by_codec: dict = {}
    for path, meta in manifest["leaves"].items():
        if meta["codec"] != "sz3_auto_rel":
            best = by_codec.get(meta["codec"])
            if best is None or preference(meta) > preference(manifest["leaves"][best]):
                by_codec[meta["codec"]] = path
    for codec, path in by_codec.items():
        meta = manifest["leaves"][path]
        leaf = leaves[path].cpu()
        if codec == "sz3_lorenzo_rel":
            flat2d = leaf.reshape(leaf.shape[0], -1) if leaf.ndim > 1 else leaf
            jobs.append((path, lambda f=flat2d: tc.sz3_lorenzo(device="cpu", route="force").compress(f, conf).blob,
                         files[meta["file"]]))
        else:
            pol = ck.CheckpointPolicy().for_path(path)
            jobs.append((path, lambda t=leaf, p=pol: ck.encode_leaf(t, p)[0], files[meta["file"]]))
    chunk_checks = 0
    for path, meta in manifest["leaves"].items():
        if meta["codec"] != "sz3_auto_rel":
            continue
        blob = files[meta["file"]]
        header, _ = tc.parse_header(blob)
        parts = _chunk_blobs(blob)
        n = len(parts)
        pick = sorted({0, n - 1, n // 3, (2 * n) // 3})[:CKPT_SAMPLE_CHUNKS]
        flat2d = leaves[path].cpu().reshape(meta["shape"][0], -1)
        abs_eb = conf.resolve_abs_eb(*pipeline._finite_stats(flat2d))  # the engine's global bound
        eff = conf.replace(mode=tc.ErrorBoundMode.ABS, eb=abs_eb)
        starts = np.cumsum([0] + [c["n0"] for c in header["chunks"]])
        eng = ChunkedCompressor(candidates=ck._LOSSY_CANDIDATES, device="cpu", route="force")
        for i in pick:
            chunk = flat2d[starts[i] : starts[i + 1]]
            jobs.append((f"{path}#{i}", lambda c=chunk, a=abs_eb, e=eff: eng._compress_chunk(c, a, e)[0], parts[i]))
            chunk_checks += 1
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda job: job[1](), jobs))
    for (label, _, want), blob in zip(jobs, got):
        if blob != want:
            raise AssertionError(f"checkpoint: {label}'s blob differs from the plain route's")
    return {"whole_leaves": sorted(by_codec.values()), "chunks": chunk_checks}


def phase_checkpoint(seed: int, launches_total: dict) -> dict:
    """Qwen1.5-0.5B's train state (2 layers) saved under the default policy,
    sync and async (params ``add_(1)`` in place after the async save
    returns), then restored onto the card from a meta-device template:
    lossless leaves bit for bit, lossy ones within their recorded bound,
    sampled blobs equal to the plain route's, launches equal to the chunks
    routed to the Lorenzo kernels.  Returns what :func:`phase_elastic`
    reuses: the sync checkpoint (its directory is the caller's to remove),
    the template, the restored state and the restore's seconds and
    launches."""
    import shutil
    import tempfile

    from repro_torch import tree as tree_util
    from repro_torch.core import telemetry
    from repro_torch.ft import CheckpointManager

    torch.cuda.empty_cache()
    state = _ckpt_state(seed)
    leaves = dict(tree_util.flatten_with_path(state)[0])
    saved = tree_util.tree_map(lambda t: t.clone(), state)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    lossless_bytes = sum(t.numel() * t.element_size() for p, t in leaves.items() if p.startswith("params/"))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "chiprun_out"))
    try:
        sync = CheckpointManager(tmp / "sync", use_async=False)
        torch.cuda.synchronize()
        reset_all_launches()
        _, t_save = _timed(lambda: sync.save(1, state))
        save_launches = all_launches()
        manifest = json.loads((tmp / "sync" / "step_1" / "manifest.json").read_text())
        files = {m["file"]: (tmp / "sync" / "step_1" / m["file"]).read_bytes() for m in manifest["leaves"].values()}
        asyn = CheckpointManager(tmp / "async", use_async=True)
        reset_all_launches()
        t0 = time.perf_counter()
        asyn.save(1, state)
        t_return = time.perf_counter() - t0
        for leaf in tree_util.flatten(state["params"])[0]:
            leaf.add_(1)  # an optimizer's in-place update, racing the save
        asyn.wait()
        torch.cuda.synchronize()
        t_async = time.perf_counter() - t0
        async_launches = all_launches()
        if async_launches != save_launches:
            raise AssertionError(f"checkpoint: the async save launched {async_launches}, the sync one {save_launches}")
        amanifest = json.loads((tmp / "async" / "step_1" / "manifest.json").read_text())
        for path, meta in manifest["leaves"].items():
            other = amanifest["leaves"][path]
            if {k: v for k, v in meta.items() if k != "seconds"} != {k: v for k, v in other.items() if k != "seconds"}:
                raise AssertionError(f"checkpoint: {path}'s async manifest entry differs from the sync one")
            if (tmp / "async" / "step_1" / meta["file"]).read_bytes() != files[meta["file"]]:
                raise AssertionError(f"checkpoint: {path}'s async leaf differs from the sync one")
        template = tree_util.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), saved)
        reset_all_launches()
        with telemetry.trace("checkpoint restore") as tr:  # a trace changes no decoded bit
            (restored, _), t_restore = _timed(lambda: asyn.restore(template))
        restore_launches = all_launches()
        expected, picks = _ckpt_expected_launches(manifest, files)
        for name, want in expected.items():
            got = save_launches[name] + restore_launches[name]
            if got != want:
                raise AssertionError(f"checkpoint: kernel {name} launched {got} times in a save and a restore, "
                                     f"expected {want} for the leaves and chunks routed to it")
            launches_total[name] += save_launches[name] + async_launches[name] + restore_launches[name]
        per_leaf = {}
        for (path, want), got in zip(tree_util.flatten_with_path(saved)[0], tree_util.flatten(restored)[0]):
            meta = manifest["leaves"][path]
            if got.device.type != "cuda" or got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"checkpoint: {path} restored as {got.dtype} {tuple(got.shape)} on {got.device}")
            if meta["codec"].startswith("sz3_"):
                bound = _leaf_blob_abs_eb(files[meta["file"]])
                err = float((got.double() - want.double()).abs().max())
                if not err <= bound:
                    raise AssertionError(f"checkpoint: {path}'s error {err} breaks its bound {bound}")
            else:
                bits = (lambda t: t.view(torch.int16)) if want.dtype == torch.bfloat16 else (lambda t: t)
                if not torch.equal(bits(got), bits(want)):
                    raise AssertionError(f"checkpoint: lossless leaf {path} did not restore bit for bit")
                err = 0.0
            per_leaf[path] = {"codec": meta["codec"], "ratio": meta["ratio"], "seconds": meta["seconds"],
                              "max_abs_err": err}
        sample = _ckpt_plain_sample(manifest, files, dict(tree_util.flatten_with_path(saved)[0]))
        codecs = collections.Counter(m["codec"] for m in manifest["leaves"].values())
        emit(
            "checkpoint qwen1.5-0.5b train state",
            layers=CKPT_LAYERS,
            leaves=len(per_leaf),
            state_bytes=n_bytes,
            lossless_param_bytes=lossless_bytes,
            lossy_moment_bytes=sum(t.numel() * t.element_size() for p, t in leaves.items()
                                   if manifest["leaves"][p]["codec"].startswith("sz3_")),
            checkpoint_bytes=manifest["bytes_out"],
            ratio=manifest["ratio"],
            codecs=dict(codecs),
            chunk_picks=dict(collections.Counter(p for p, _ in picks)),
            save_s=t_save,
            save_seconds_by_codec={c: sum(m["seconds"] for m in manifest["leaves"].values() if m["codec"] == c)
                                   for c in codecs},
            async_save_return_s=t_return,
            async_save_s=t_async,
            restore_s=t_restore,
            restore_stage_seconds={k: v["seconds"] for k, v in tr.stage_totals().items()},
            save_MBps=n_bytes / 1e6 / t_save,
            restore_MBps=n_bytes / 1e6 / t_restore,
            async_snapshot_survives_add_=True,
            plain_route_sample=sample,
            per_leaf=per_leaf,
            launches={k: save_launches[k] + restore_launches[k] for k in save_launches
                      if save_launches[k] + restore_launches[k]},
            expected_launches={k: v for k, v in expected.items() if v},
        )
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    del state, saved, leaves
    torch.cuda.empty_cache()
    return {"tmp": tmp, "dir": tmp / "sync", "template": template, "restored": restored, "restore_s": t_restore,
            "restore_launches": restore_launches, "picks": picks}


#: decode launches of a restore for each chunk (or whole lossy leaf) that
#: takes its pipeline's kernel route: one decode of a Lorenzo chunk, one
#: inverse product of a transform chunk (2-D: the checkpoint's leaves are
#: stored as (rows, -1))
_RESTORE_DECODES = {"sz3_lorenzo": {"decode_2d": 1}, "sz3_transform": {"transform_inv_2d": 1}}
_RESTORE_DECODE_NAMES = ("decode_1d", "decode_2d", "transform_inv_2d")
#: the quarter read's rows of the largest chunked leaf, and the share of its
#: container it may read (its chunks hold 1024 rows each: about a quarter)
ELASTIC_QUARTER = (1 / 4, 1 / 2)
ELASTIC_QUARTER_FRAC = (0.2, 0.3)


def _restore_decodes(picks) -> dict:
    """Decode-kernel launches of one restore of chunks ``picks`` ((pipeline,
    elements) each)."""
    out = {name: 0 for name in _RESTORE_DECODE_NAMES}
    for pipeline, n in picks:
        if _takes_kernel_route(pipeline, n):
            for name, k in _RESTORE_DECODES.get(pipeline, {}).items():
                out[name] += k
    return out


def phase_elastic(ckpt: dict, launches_total: dict) -> None:
    """The checkpoint phase's sync checkpoint restored through
    ``ft.elastic.restore_resharded`` onto the card's elastic mesh (one
    card: (1, 1), ``make_elastic_mesh``) under a plan without FSDP, where
    the embedding's spec is (model, None): every leaf bit-equal to the
    plain restore placed in its spec (``parallel.specs.place``), every
    chunked leaf whose spec shards nothing past dim 0 read by chunk range,
    decode-kernel launches equal to the chunks routed to each kernel, the
    rest as the plain restore's; then ``ChunkRangeReader.rows`` over a
    quarter of the rows of the largest chunked leaf, equal to the full
    decode's rows, reading about a quarter of its container.  Removes the
    checkpoint."""
    import shutil

    import torch.distributed as dist

    import repro_torch.core as tc
    from repro_torch import configs
    from repro_torch import tree as tree_util
    from repro_torch.ft import CheckpointManager
    from repro_torch.ft.elastic import (_CHUNKED_CODECS, ChunkRangeReader, _axis0_only, make_elastic_mesh, replan,
                                        restore_resharded)
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import ParallelPlan
    from repro_torch.parallel import specs as sp
    from repro_torch.train.step import state_specs

    try:
        cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=CKPT_LAYERS)
        step_dir = ckpt["dir"] / "step_1"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        mesh = make_elastic_mesh(device="cuda")
        plan = replan(cfg, ParallelPlan(batch_axes=("data",)), mesh)
        if tuple(mesh.shape) != (1, 1) or plan.fsdp_axes or list(mesh.get_coordinate()) != [0, 0]:
            raise AssertionError(f"elastic: the one-card mesh is {mesh}, the plan {plan}")
        specs = state_specs(ckpt["template"], cfg, plan, AdamWConfig())
        mgr = CheckpointManager(ckpt["dir"], use_async=False)
        reset_all_launches()
        (state, extra, report), t_elastic = _timed(lambda: restore_resharded(mgr, ckpt["template"], specs, plan))
        launches = all_launches()
        whole = dict(tree_util.flatten_with_path(ckpt["restored"])[0])
        modes = collections.Counter()
        for path, got in tree_util.flatten_with_path(state)[0]:
            spec, meta = sp.spec_at(specs, path), manifest["leaves"][path]
            want = sp.shard_local(whole[path], spec, plan)
            if list(got.placements) != plan.placements(spec) or not same_bits(got.to_local(), want):
                raise AssertionError(f"elastic: {path} differs from the plain restore placed as {spec}")
            mode = report.leaves[path].mode
            if meta["codec"] in _CHUNKED_CODECS and _axis0_only(spec, len(meta["shape"])) and mode != "chunk-range":
                raise AssertionError(f"elastic: chunked leaf {path} under {spec} restored {mode}")
            modes[(meta["codec"], mode)] += 1
        embed = report.leaves["opt/m/embed"]
        if sp.spec_at(specs, "opt/m/embed") != ("model", None) or embed.mode != "chunk-range":
            raise AssertionError(f"elastic: the embedding's moment under {sp.spec_at(specs, 'opt/m/embed')}: {embed}")
        expected = _restore_decodes(ckpt["picks"])
        for name, want in expected.items():
            if launches[name] != want:
                raise AssertionError(f"elastic: kernel {name} launched {launches[name]} times, expected {want} for "
                                     "the chunks routed to it")
            launches_total[name] += launches[name]
        others = {k: (v, ckpt["restore_launches"][k]) for k, v in launches.items()
                  if k not in expected and v != ckpt["restore_launches"][k]}
        if others:
            raise AssertionError(f"elastic: launches other than the plain restore's: {others}")
        del state

        # the quarter read: rows [n/4, n/2) of the largest chunked leaf
        big = max((math.prod(m["shape"]), p) for p, m in manifest["leaves"].items()
                  if m["codec"] in _CHUNKED_CODECS)[1]
        meta = manifest["leaves"][big]
        blob = (step_dir / meta["file"]).read_bytes()
        n = meta["shape"][0]
        r0, r1 = int(n * ELASTIC_QUARTER[0]), int(n * ELASTIC_QUARTER[1])
        reset_all_launches()
        reader = ChunkRangeReader(blob, device="cuda")
        rows, t_quarter = _timed(lambda: reader.rows(r0, r1))
        q_launches = all_launches()
        got = rows.reshape((r1 - r0,) + tuple(meta["shape"][1:])).to(whole[big].dtype)
        if not same_bits(got, whole[big][r0:r1]):
            raise AssertionError(f"elastic: rows [{r0}, {r1}) of {big} differ from the full decode's")
        header = tc.parse_header(blob)[0]
        inner = math.prod(meta["shape"][1:])
        starts = reader.row_starts
        read = [i for i in range(len(starts) - 1) if starts[i] < r1 and starts[i + 1] > r0]
        q_expected = _restore_decodes([(header["chunks"][i]["pipeline"], header["chunks"][i]["n0"] * inner)
                                       for i in read])
        for name, want in q_expected.items():
            if q_launches[name] != want:
                raise AssertionError(f"elastic quarter read: kernel {name} launched {q_launches[name]} times, "
                                     f"expected {want}")
            launches_total[name] += q_launches[name]
        frac = reader.bytes_read / len(blob)
        if not ELASTIC_QUARTER_FRAC[0] <= frac <= ELASTIC_QUARTER_FRAC[1]:
            raise AssertionError(f"elastic quarter read: read {frac} of the container")
        emit(
            "elastic qwen1.5-0.5b train state",
            mesh={"shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names)},
            plan={"batch_axes": list(plan.batch_axes), "fsdp_axes": list(plan.fsdp_axes)},
            leaves=len(report.leaves),
            modes={f"{c} {m}": k for (c, m), k in sorted(modes.items())},
            bit_equal_to_restore_and_place=True,
            extra=extra,
            summary=report.summary(),
            bytes_read=report.bytes_read,
            bytes_full=report.bytes_full,
            restore_resharded_s=t_elastic,
            plain_restore_s=ckpt["restore_s"],
            over_plain=t_elastic / ckpt["restore_s"],
            launches={k: v for k, v in launches.items() if v},
            expected_decode_launches=expected,
            quarter_read={"leaf": big, "rows": [r0, r1], "of_rows": n, "chunks_read": len(read),
                          "chunks": len(starts) - 1, "bytes_read": reader.bytes_read, "bytes": len(blob),
                          "fraction": frac, "seconds": t_quarter, "launches": {k: v for k, v in q_launches.items() if v},
                          "equal_to_full_decode": True},
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(ckpt["tmp"], ignore_errors=True)
        ckpt.clear()
    torch.cuda.empty_cache()


#: the dry run (``launch/dryrun.py``) in subprocesses, started before the
#: train phase and read after it: the CLI's Qwen1.5-0.5B ``train_4k`` cell
#: on the fake 16 x 16 group, and the train phase's own shapes (batch 8,
#: seq 4096, the cell plan on a fake (1, 1) mesh), whose counted dot FLOPs
#: are held against the profiler's over one real step of the train phase
DRYRUN_TIMEOUT_S = 900
DRYRUN_DOT_RTOL = 0.01
_DRYRUN_ONE = """
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun
with dryrun.fake_world(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    res = dryrun.analyze_cell(sys.argv[1], "train_4k", mesh, False, batch=int(sys.argv[2]))
json.dump(res, open(sys.argv[3], "w"), indent=1)
"""


def start_dryrun() -> dict:
    """Start the dry run's two cells, each a CPU-only subprocess (a fake
    process group cannot share a process with the card's), writing under
    ``chiprun_out/dryrun_torch``."""
    import os
    import shutil

    out = ROOT / "chiprun_out" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    cmds = {
        "16x16": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", TRAIN_ARCH, "--shape", "train_4k",
                  "--out", str(out), "--force"],
        "1x1": [sys.executable, "-c", _DRYRUN_ONE, TRAIN_ARCH, str(TRAIN_BATCH), str(out / "1x1.json")],
    }
    procs = {}
    for name, cmd in cmds.items():
        with open(out / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    return {"procs": procs, "out": out, "t0": time.perf_counter()}


def stop_dryrun(run: dict) -> None:
    for p in run.get("procs", {}).values():
        if p.poll() is None:
            p.kill()
        p.wait()


def phase_dryrun(run: dict) -> None:
    """Wait for the dry run's cells and check them: the CLI's JSON for the
    16 x 16 cell, and the (1, 1) cell's dot FLOPs within ``DRYRUN_DOT_RTOL``
    of the profiler's over one real step of the train phase (the profiled
    dot calls that launched a kernel), its counted peak against that
    phase's ``max_memory_allocated``, its compute term against the measured
    step p50."""
    t0 = time.perf_counter()
    try:
        for name, p in run["procs"].items():
            rc = p.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - run["t0"])))
            if rc != 0:
                log = (run["out"] / f"{name}.log").read_text()[-3000:]
                raise AssertionError(f"dryrun: the {name} cell exited {rc}:\n{log}")
    finally:
        stop_dryrun(run)
    waited = time.perf_counter() - t0
    out = run["out"]
    cli = out / "single" / f"{TRAIN_ARCH}__train_4k.json"
    if not cli.exists():
        err = cli.with_suffix(".error.json")
        raise AssertionError(f"dryrun: no {cli.name}: {err.read_text()[-3000:] if err.exists() else 'no error file'}")
    big, one = json.loads(cli.read_text()), json.loads((out / "1x1.json").read_text())
    for res in (big, one):
        c = res["counted"]
        if not (c["dot_flops_per_chip"] > 0 and c["dtensor_ops_skipped"] == 0 and res["plain_kernels"] == []):
            raise AssertionError(f"dryrun: cell {res['mesh_shape']} counted {c}, plain kernels {res['plain_kernels']}")
    train = RESULTS["train qwen1.5-0.5b"]["plain"]
    prof = train["profiler_flops"]
    counted = one["counted"]["dot_flops_per_chip"]
    if isinstance(prof.get("executed_dot_flops"), str):
        raise AssertionError(f"dryrun: the profiler gave no FLOPs: {prof}")
    rel = abs(counted - prof["executed_dot_flops"]) / prof["executed_dot_flops"]
    if not rel <= DRYRUN_DOT_RTOL:
        raise AssertionError(f"dryrun: the (1, 1) cell counts {counted} dot FLOPs, the profiler "
                             f"{prof['executed_dot_flops']} over a real step ({rel})")
    peak_counted = one["memory_analysis"]["peak_memory_in_bytes"] / 1e9
    emit(
        "dryrun qwen1.5-0.5b train_4k",
        cells={"16x16": {k: big[k] for k in ("chips", "mesh_shape", "batch", "plan", "timing", "memory_analysis",
                                              "counted", "roofline")},
               "1x1": {k: one[k] for k in ("chips", "mesh_shape", "batch", "plan", "timing", "memory_analysis",
                                            "counted", "roofline")}},
        cli_json=str(cli.relative_to(ROOT)),
        card_step={"dot_flops_counted": counted, "profiler": prof, "rel_diff": rel, "rtol": DRYRUN_DOT_RTOL,
                   "peak_counted_GB": peak_counted, "peak_measured_GB": train["peak_memory_GB"],
                   "peak_counted_over_measured": peak_counted / train["peak_memory_GB"],
                   "compute_term_s": one["roofline"]["compute_s"], "step_p50_s": train["step_p50_s"],
                   "compute_term_over_p50": one["roofline"]["compute_s"] / train["step_p50_s"]},
        finished_before_train_ended=waited < 1.0,
        waited_after_train_s=waited,
    )


#: KV pages: one layer's K or V for one sequence at a 4096-token window,
#: (4096, 1024) float32 (16 MiB); tenants x pages (cut from 4 x 2: at 2 x 2
#: the puts took 168 s); fetches, half of them at the two hot pages
OFFLOAD_PAGE = (4096, 1024)
OFFLOAD_TENANTS, OFFLOAD_PAGES_EACH, OFFLOAD_FETCHES = 1, 2, 256


def _offload_requests(pages, n_chunks: int, bad, seed: int):
    """``OFFLOAD_FETCHES`` requests: every 128th a whole page (one per page),
    the rest single chunks; half of them at the two hot pages' first 8 chunks, and a
    few at the damaged chunk ``bad`` = (page, chunk)."""
    rng = np.random.default_rng(seed)
    hot = pages[:2]
    reqs = []
    for i in range(OFFLOAD_FETCHES):
        if i % 128 == 127:
            reqs.append((*pages[(i // 128) % len(pages)], None))
        elif i % 2:
            reqs.append((*hot[int(rng.integers(0, 2))], int(rng.integers(0, 8))))
        elif i % 32 == 6:
            reqs.append((*bad[0], bad[1]))
        else:
            reqs.append((*pages[int(rng.integers(0, len(pages)))], int(rng.integers(0, n_chunks))))
    return reqs


def _put_profile(page: torch.Tensor) -> dict:
    """Where a put's time goes: the first quarter of ``page`` compressed as
    the service compresses a page, on this thread under ``cProfile`` (a
    put's executor thread is not profiled): the functions with the most own
    time, and the cumulative time of the chunk contest and the Huffman
    tree builds."""
    import cProfile
    import pstats

    from repro_torch.serve import offload as off

    rows = page.shape[0] // 4
    part = page[:rows].contiguous()
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    off._compress_page(part, "abs", 1e-3, None, 1 << 16, "cuda")
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    chunks = part.numel() * part.element_size() // (1 << 16)

    def label(key):
        return f"{pathlib.Path(key[0]).name}:{key[1]}({key[2]})"

    def cumulative(name):
        return sum(v[3] for k, v in stats.items() if k[2] == name)

    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    return {
        "chunks": chunks,
        "seconds": wall,
        "ms_per_chunk": wall / chunks * 1e3,
        "select_pipeline_s": cumulative("select_pipeline"),
        "huffman_code_lengths_s": cumulative("_huffman_code_lengths"),
        "top_own_s": [{"function": label(k), "calls": v[1], "own_s": v[2], "cum_s": v[3]} for k, v in top],
    }


def phase_offload(seed: int, launches_total: dict) -> None:
    """One ``OffloadService`` on the card (thread executor, defaults: ABS
    1e-3, 64 KiB chunks, strict verify): one sequence's K and V put, one chunk
    of one page corrupted (``put_compressed`` of ``faults.corrupt_chunk``),
    256 fetches.  Exactly the requests that read the damaged chunk fail;
    every fetched chunk keeps the bound and equals the plain route's decode
    of the same blob; ``encode_2d`` launches equal the chunks routed to
    ``sz3_lorenzo``, ``decode_2d`` launches the chunk decodes that missed the
    cache (plus the whole-page decodes' routed chunks)."""
    import asyncio

    import repro_torch.core as tc
    from repro_torch.core import faults, telemetry
    from repro_torch.serve import OffloadError, OffloadService
    from repro_torch.serve import offload as off

    telemetry.reset_metrics()
    data = {(f"t{i}", kv): v_cache(OFFLOAD_PAGE, seed + 60 + 2 * i + j)
            for i in range(OFFLOAD_TENANTS) for j, kv in enumerate(("k", "v")[:OFFLOAD_PAGES_EACH])}
    pages = list(data)
    decoded = []
    real = off.decompress_chunk

    def counted(blob, index, *a, **k):
        out = real(blob, index, *a, **k)
        decoded.append((off.blob_key(blob), int(index)))
        return out

    async def run():
        async with OffloadService() as svc:
            torch.cuda.synchronize()
            reset_all_launches()
            t0 = time.perf_counter()
            reports = await asyncio.gather(*[svc.put(t, p, x) for (t, p), x in data.items()])
            torch.cuda.synchronize()
            t_put = time.perf_counter() - t0
            put_launches = all_launches()
            blobs = {key: svc._pages[key] for key in pages}
            n_chunks = reports[0]["chunks"]
            bad = (pages[-1], n_chunks // 3)
            blobs[bad[0]] = faults.corrupt_chunk(blobs[bad[0]], bad[1])
            await svc.put_compressed(*bad[0], blobs[bad[0]], n_in=reports[-1]["n_in"])
            reqs = _offload_requests(pages, n_chunks, bad, seed)
            before = svc.cache.stats()
            reset_all_launches()
            t0 = time.perf_counter()
            results = await asyncio.gather(*[svc.fetch(*r) for r in reqs], return_exceptions=True)
            torch.cuda.synchronize()
            t_fetch = time.perf_counter() - t0
            return (reports, t_put, put_launches, blobs, bad, reqs, results, t_fetch, all_launches(),
                    before, svc.cache.stats(), svc.stats())

    off.decompress_chunk = counted
    try:
        (reports, t_put, put_launches, blobs, bad, reqs, results, t_fetch, fetch_launches,
         before, after, stats) = asyncio.run(run())
    finally:
        off.decompress_chunk = real
    picks = {key: [(c["pipeline"], c["n0"] * OFFLOAD_PAGE[1]) for c in tc.parse_header(b)[0]["chunks"]]
             for key, b in blobs.items()}
    routed = {key: _decode_launches(p, 2)["decode_2d"] for key, p in picks.items()}
    if put_launches["encode_2d"] != sum(routed.values()) or put_launches["decode_2d"] != sum(routed.values()):
        raise AssertionError(f"offload: puts launched {put_launches['encode_2d']} encode_2d and "
                             f"{put_launches['decode_2d']} decode_2d, expected {sum(routed.values())} each")
    # exactly the requests that read the damaged chunk fail
    failed = [i for i, r in enumerate(results) if isinstance(r, BaseException)]
    should = [i for i, (t, p, c) in enumerate(reqs) if (t, p) == bad[0] and c in (None, bad[1])]
    if failed != should or not all(isinstance(results[i], OffloadError) for i in failed):
        raise AssertionError(f"offload: requests {failed} failed, {should} read the damaged chunk")
    misses = after["chunk_misses"] - before["chunk_misses"]
    bad_misses = sum(1 for t, p, c in reqs if (t, p) == bad[0] and c == bad[1])
    if len(decoded) != misses - bad_misses:
        raise AssertionError(f"offload: {len(decoded)} chunk decodes for {misses - bad_misses} good cache misses")
    keys = {off.blob_key(b): key for key, b in blobs.items()}
    whole = [(t, p) for i, (t, p, c) in enumerate(reqs) if c is None and i not in failed]
    want_decode = sum(1 for k, i in decoded if picks[keys[k]][i][0] == "sz3_lorenzo") + sum(routed[k] for k in whole)
    if fetch_launches["decode_2d"] != want_decode or fetch_launches["encode_2d"]:
        raise AssertionError(f"offload: fetches launched {fetch_launches['decode_2d']} decode_2d "
                             f"(and {fetch_launches['encode_2d']} encode_2d), expected {want_decode}")
    for name in ("encode_2d", "decode_2d"):
        launches_total[name] += put_launches[name] + fetch_launches[name]
    # every fetched chunk: within the bound, and the plain route's decode
    rows = OFFLOAD_PAGE[0] // len(picks[pages[0]])
    good = [(r, out) for r, out in zip(reqs, results) if not isinstance(out, BaseException)]
    wanted = sorted({r for r, _ in good}, key=str)

    def plain(r):
        t, p, c = r
        blob = blobs[(t, p)] if c is None else _chunk_blobs(blobs[(t, p)])[c]
        return tc.decompress(blob, device="cpu", route="force")

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        plain_out = dict(zip(wanted, pool.map(plain, wanted)))
    max_err = 0.0
    for (t, p, c), out in good:
        want = plain_out[(t, p, c)]
        x = data[(t, p)] if c is None else data[(t, p)][c * rows : (c + 1) * rows]
        if not (out.device.type == "cuda" and same_bits(out.cpu(), want)):
            raise AssertionError(f"offload: fetch {t}/{p}[{c}] differs from the plain route's decode")
        max_err = max(max_err, float((out.double() - x.double()).abs().max()))
    if not max_err <= 1e-3:
        raise AssertionError(f"offload: a fetched value's error {max_err} breaks the bound 1e-3")
    put_profile = _put_profile(data[pages[0]])
    snap = telemetry.METRICS.snapshot()
    lat = snap["histograms"]["sz3_serve_request_seconds"]
    n_in = sum(r["n_in"] for r in reports)
    n_out = sum(len(b) for b in blobs.values())
    emit(
        "offload kv pages",
        page_shape=list(OFFLOAD_PAGE),
        pages=len(pages),
        chunks_per_page=len(picks[pages[0]]),
        chunk_picks=dict(collections.Counter(name for p in picks.values() for name, _ in p)),
        fetches=len(reqs),
        whole_page_fetches=sum(1 for r in reqs if r[2] is None),
        failed_requests=len(failed),
        put_s=t_put,
        put_MBps=n_in / 1e6 / t_put,
        fetch_s=t_fetch,
        request_p50_s=lat["p50"],
        request_p99_s=lat["p99"],
        chunk_cache_hits=after["chunk_hits"] - before["chunk_hits"],
        chunk_cache_misses=misses,
        chunk_decodes=len(decoded),
        batches=snap["counters"]["sz3_serve_batches_total"],
        batched_requests=snap["counters"]["sz3_serve_batched_requests_total"],
        ratio=n_in / n_out,
        max_abs_err=max_err,
        same_as_plain_route=True,
        prometheus_lines=len(telemetry.prometheus_text().splitlines()),
        huffman_table_cache=stats["huffman_table_cache"],
        put_profile=put_profile,
        launches={k: put_launches[k] + fetch_launches[k] for k in ("encode_2d", "decode_2d")},
        expected_launches={"encode_2d": sum(routed.values()), "decode_2d": sum(routed.values()) + want_decode},
    )
    del data


# ---------------------------------------------------------------------------
# serving: the launcher's decode and KV offload at granite-3-8b's full size
# ---------------------------------------------------------------------------

#: the serve launcher's defaults: granite-3-8b (its default --arch) at full
#: width and depth, batch 4, 16 greedy tokens, a cache of 24 positions
SERVE_ARCH, SERVE_BATCH, SERVE_TOKENS = "granite-3-8b", 4, 16
#: prefill against the last decode step, in bf16 at 40 layers: bf16 keeps 8
#: significant bits, and prefill and decode round at different points (decode
#: rounds the scaled query and the softmax weights to bf16, prefill keeps
#: them in float32; their GEMMs split K differently), so the two drift apart
#: by a random walk of some 40 x 5 roundings of 2^-9: about 3% of the logits'
#: scale (2% seen at widths 256 and 512 on the CPU); the bound is 10% of the
#: largest |logit|
SERVE_PREFILL_RTOL = 0.1
#: the reference's own bound on int8-versus-bf16 log-probability drift
#: (tests/test_models_smoke.py::test_int8_kv_cache_close_to_bf16)
SERVE_INT8_DRIFT = 0.3


def _step_latency() -> dict:
    from repro_torch.core import telemetry

    h = telemetry.METRICS.snapshot()["histograms"]["sz3_decode_step_seconds"]
    return {"step_p50_s": h["p50"], "step_p99_s": h["p99"], "step_max_s": h["max"], "step_sum_s": h["sum"],
            "steps": h["count"]}


def _offload_recorded(offload, cache) -> tuple:
    """``offload(cache)`` with each leaf's stream frames recorded (the
    chunked engine's ``compress_stream`` wrapped for the call)."""
    from repro_torch.core import chunking

    real = chunking.compress_stream
    streams = []

    def recording(arr, *a, **k):
        frames = []
        streams.append((arr, frames))
        for frame in real(arr, *a, **k):
            frames.append(frame)
            yield frame

    chunking.compress_stream = recording
    try:
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        n_in, n_out = offload(cache)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        chunking.compress_stream = real
    return n_in, n_out, seconds, streams, all_launches()


#: the weight-stationary sub-run: the plain runs' granite-3-8b on a one-card
#: NCCL mesh (data 1 x model 1), FSDP over data and decode_feature_shard,
#: the plain runs' greedy steps from the same prompt tokens.  Every group
#: has one rank, so every collective is skipped and each feature-sharded
#: product is the plain product: the ops are the plain decode's, and the
#: tokens and last logits are held equal to its, bit for bit
SERVE_STATIONARY_ATOL = 0.0


def _serve_stationary(cfg, params, seed: int, plain: dict, launches_total: dict) -> dict:
    """``jit_serve_step`` under the weight-stationary plan on a one-card
    mesh, for each of ``plain``'s runs (``{"bf16": (ServeResult, its step
    latencies), "int8": ...}``): the parameters placed as DTensors (no copy on one card), the
    cache in ``cache_specs`` placements, ``SERVE_TOKENS`` greedy steps from
    the launcher's prompt tokens, each step timed as the launcher times it.
    Holds the tokens and the last logits against the plain run's and the
    int8 run's ``quantize_append`` launches at one per layer and token.
    Tears the process group down."""
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.core import telemetry
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import ParallelPlan
    from repro_torch.serve.step import jit_serve_step, make_serve_step

    B, T = SERVE_BATCH, SERVE_TOKENS
    t_all = time.perf_counter()
    mesh = make_debug_mesh((1, 1), ("data", "model"), device="cuda")
    out = {"mesh": {"shape": [1, 1], "axes": ["data", "model"], "backend": dist.get_backend()},
           "scope": "every group has one rank: no collective runs; tools/sharded_cards.py runs the decode across "
                    "four cards"}
    try:
        for kv, (ref, ref_lat) in plain.items():
            plan = ParallelPlan(mesh=mesh, fsdp_axes=("data",), kv_cache_dtype=kv, decode_feature_shard=True)
            if not plan.weight_stationary:
                raise AssertionError(f"serve stationary: the plan {plan} is not weight-stationary")
            telemetry.reset_metrics()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_all_launches()
            with float32_bf16_reductions():
                cache = models.init_cache(params, cfg, plan, B, T + 8)
                step = jit_serve_step(make_serve_step(cfg, plan), params, cache, cfg, plan)
                gen = torch.Generator(device="cuda").manual_seed(seed + 2)
                tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda", dtype=torch.int32)
                seq, t0 = [tok], time.perf_counter()
                for _ in range(T):
                    ts = time.perf_counter()
                    logits, cache = step(params, cache, tok)
                    tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
                    torch.cuda.synchronize()
                    telemetry.metric_observe("sz3_decode_step_seconds", time.perf_counter() - ts)
                    seq.append(tok)
                seconds = time.perf_counter() - t0
            launched = all_launches()
            want = cfg.n_layers * T if kv == "int8" else 0
            others = {k: v for k, v in launched.items() if v and k != "quantize_append"}
            if launched["quantize_append"] != want or others:
                raise AssertionError(f"serve stationary {kv}: quantize_append launched {launched['quantize_append']} "
                                     f"times, expected {want}; other kernels {others}")
            launches_total["quantize_append"] += want
            seq = torch.cat(seq, dim=1).cpu().numpy()
            err = float((logits - ref.logits).abs().max())
            tokens_equal = bool((seq == ref.sequences).all())
            if not (tokens_equal and err <= SERVE_STATIONARY_ATOL and bool(torch.isfinite(logits).all())):
                raise AssertionError(f"serve stationary {kv}: tokens equal {tokens_equal}, last logits "
                                     f"{err} from the plain decode's (bound {SERVE_STATIONARY_ATOL})")
            lat = _step_latency()
            out[kv] = {"tok_per_s": B * T / seconds, "seconds": seconds, **lat,
                       "plain_step_p50_s": ref_lat["step_p50_s"], "plain_step_p99_s": ref_lat["step_p99_s"],
                       "p50_over_plain_p50": lat["step_p50_s"] / ref_lat["step_p50_s"],
                       "launches": {k: v for k, v in launched.items() if v},
                       "tokens_equal_plain": tokens_equal, "logits_max_abs_vs_plain": err,
                       "logits_bit_equal_plain": bool(torch.equal(logits, ref.logits)),
                       "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9}
            del cache, step
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_all
    return out


def phase_serve(seed: int, launches_total: dict, cases: dict, bw: float) -> None:
    """``repro_torch.launch.serve.serve`` at granite-3-8b's full size: 16
    greedy bf16 steps, prefill against the last step, the bf16 cache through
    ``offload_cache`` (chunked, strict verify; launches equal to the chunks
    routed to ``sz3_lorenzo``, the first leaf's blob equal to the plain
    route's), then 16 int8 steps (``quantize_append`` 40 x 16 times, the
    standalone pair never), the int8 drift from bf16 on the same tokens,
    ``_quantize_token`` on the bf16 cache's K and V against its plain
    version, the fused append against the sequence it replaced, the int8
    cache's offload (its scales only), and both runs again through the
    weight-stationary decode on a one-card mesh (:func:`_serve_stationary`:
    ``quantize_append`` 40 x 16 more times)."""
    import repro_torch.core as tc
    from repro_torch import configs, models
    from repro_torch.core import chunking, telemetry
    from repro_torch.kernels.kvquant import kernel as KK
    from repro_torch.kernels.kvquant import ref as KR
    from repro_torch.launch import serve as ls
    from repro_torch.models import lm
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import ParallelPlan
    from repro_torch.serve.step import make_serve_step

    cfg = configs.get(SERVE_ARCH)
    plan, plan8 = ParallelPlan(), ParallelPlan(kv_cache_dtype="int8")
    B, T = SERVE_BATCH, SERVE_TOKENS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(seed, cfg, plan, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    weight_bytes = sum(t.numel() * t.element_size() for t in params.parameters())

    # 1. bf16: 16 greedy steps, then prefill over the consumed tokens
    telemetry.reset_metrics()
    torch.cuda.synchronize()
    reset_all_launches()
    bf = ls.serve(cfg, plan, B, T, arch=SERVE_ARCH, seed=seed, params=params)
    torch.cuda.synchronize()
    bf_launches = {k: v for k, v in all_launches().items() if v}
    if bf_launches:
        raise AssertionError(f"serve bf16: a bf16 decode launched kernels {bf_launches}")
    bf_lat = _step_latency()
    if bf.sequences.shape != (B, T + 1) or not bool(torch.isfinite(bf.logits).all()):
        raise AssertionError(f"serve bf16: tokens {bf.sequences.shape} or non-finite logits")
    if tuple(bf.logits.shape) != (B, cfg.vocab) or not (bf.sequences < cfg.vocab).all():
        raise AssertionError(f"serve bf16: logits {tuple(bf.logits.shape)}, or a token outside the vocabulary")
    consumed = torch.from_numpy(bf.sequences[:, :T]).cuda()  # the last token was never fed back
    with float32_bf16_reductions(), torch.no_grad():
        pre = models.prefill_logits(params, {"tokens": consumed}, cfg, plan)
    pre_err = float((pre - bf.logits).abs().max())
    logit_scale = float(bf.logits.abs().max())
    if not pre_err <= SERVE_PREFILL_RTOL * logit_scale:
        raise AssertionError(f"serve: prefill differs from the last decode step by {pre_err}, over "
                             f"{SERVE_PREFILL_RTOL} of the largest |logit| {logit_scale}")
    pre_logprob = float((torch.log_softmax(pre, -1) - torch.log_softmax(bf.logits, -1)).abs().max())

    # 2. the bf16 cache through offload_cache: chunked, strict verify
    telemetry.reset_metrics()
    n_in, n_out, t_off, streams, off_launches = _offload_recorded(
        lambda c: ls.offload_cache(c, eb=1e-3, device="cuda"), bf.cache)
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-3)
    leaves, picks_all = [], []
    for (arr, frames), name in zip(streams, ("k", "v")):
        blob = chunking.frames_to_blob(frames)
        chunks = tc.parse_header(blob)[0]["chunks"]
        picks = [(c["pipeline"], c["n0"] * arr.shape[1]) for c in chunks]
        picks_all += picks
        nbytes = arr.numel() * 2  # bf16 at rest
        leaves.append({
            "leaf": name, "shape": list(arr.shape), "chunks": len(chunks), "ratio": nbytes / len(blob),
            "picks": dict(collections.Counter(p for p, _ in picks)),
        })
    if len(streams) != 2 or n_in != sum(a.numel() * 2 for a, _ in streams):
        raise AssertionError(f"serve offload: {len(streams)} leaves, {n_in} bytes in")
    expected = _expected_chunk_launches(picks_all, 2)
    for name in _CHUNK_KERNEL_NAMES:
        if off_launches[name] != expected[name]:
            raise AssertionError(f"serve offload: kernel {name} launched {off_launches[name]} times, "
                                 f"expected {expected[name]} for the chunks routed to it")
        launches_total[name] += off_launches[name]
    arr0, frames0 = streams[0]
    t_plain = time.perf_counter()
    plain = tc.sz3_chunked(chunk_bytes=1 << 20, device="cpu", route="force").compress(arr0.cpu(), conf).blob
    t_plain = time.perf_counter() - t_plain
    if chunking.frames_to_blob(frames0) != plain:
        raise AssertionError("serve offload: the k leaf's blob differs from the plain route's on the host")
    back = tc.decompress(plain, device="cpu")
    abs_eb = tc.parse_header(_chunk_blobs(plain)[0])[0]["abs_eb"]
    off_err = float((back.double() - arr0.cpu().double()).abs().max())
    if not off_err <= abs_eb:
        raise AssertionError(f"serve offload: k leaf error {off_err} breaks the bound {abs_eb}")
    verify_s = telemetry.METRICS.snapshot()["histograms"]["sz3_offload_verify_seconds"]["sum"]
    # where the offload's time goes: the same offload again under a trace
    # (a traced blob carries decision entries, so it is not compared)
    with telemetry.trace("kv_offload") as tr:
        ls.offload_cache(bf.cache, eb=1e-3, device="cuda")
    torch.cuda.synchronize()
    stages = {k: v["seconds"] for k, v in tr.stage_totals().items()}
    host_coding_share = (stages.get("huffman", 0.0) + stages.get("lossless", 0.0)) / tr.seconds

    # 3. int8: 16 greedy steps through the kvquant kernels
    telemetry.reset_metrics()
    torch.cuda.synchronize()
    reset_all_launches()
    i8 = ls.serve(cfg, plan8, B, T, arch=SERVE_ARCH, seed=seed, params=params)
    torch.cuda.synchronize()
    i8_launches = all_launches()
    i8_lat = _step_latency()
    want = cfg.n_layers * T
    if i8_launches["quantize_append"] != want or i8_launches["absmax"] or i8_launches["quantize_with_scale"]:
        raise AssertionError(f"serve int8: quantize_append launched {i8_launches['quantize_append']} times, "
                             f"expected {want}; absmax {i8_launches['absmax']} and quantize_with_scale "
                             f"{i8_launches['quantize_with_scale']} times, expected 0")
    launches_total["quantize_append"] += want
    others = {k: v for k, v in i8_launches.items() if v and k != "quantize_append"}
    if others or not bool(torch.isfinite(i8.logits).all()):
        raise AssertionError(f"serve int8: other kernels {others}, or non-finite logits")
    # drift from bf16 on the bf16 run's tokens (teacher-forced, not counted)
    step = make_serve_step(cfg, plan8)
    cache8 = models.init_cache(params, cfg, plan8, B, T + 8)

    with float32_bf16_reductions():
        for t in range(T):
            forced_logits, cache8 = step(params, cache8, consumed[:, t : t + 1])
    drift = float((torch.log_softmax(forced_logits, -1) - torch.log_softmax(bf.logits, -1)).abs().max())
    if not drift < SERVE_INT8_DRIFT:
        raise AssertionError(f"serve int8: log-probability drift {drift} from bf16, bound {SERVE_INT8_DRIFT}")
    # _quantize_token on the bf16 cache's K and V (empty slots: the 1e-8
    # floor): the card's codes and scales against the plain version's
    same = {}
    for name in ("k", "v"):
        x = getattr(bf.cache, name)
        q, scale = lm._quantize_token(x)
        torch.cuda.synchronize()
        pq, ps = lm._quantize_token(x.cpu())
        same[name] = bool(torch.equal(q.cpu(), pq) and same_bits(scale.cpu(), ps))
        if not same[name]:
            raise AssertionError(f"serve: _quantize_token of the {name} cache differs on the card from its plain version")
    fused_vs_old = append_against_old_sequence(bf.cache, i8.cache, "serve")
    # the int8 cache's offload: the codes are not float, only the scales go
    telemetry.reset_metrics()
    n8_in, n8_out, t8_off, streams8, off8_launches = _offload_recorded(
        lambda c: ls.offload_cache(c, eb=1e-3, device="cuda"), i8.cache)
    c8 = telemetry.METRICS.snapshot()["counters"]
    scales = i8.cache.k_scale.numel()
    if (c8["sz3_offload_leaves_total"], c8["sz3_offload_leaves_skipped_total"], n8_in) != (2, 4, 2 * 4 * scales):
        raise AssertionError(f"serve int8 offload: {c8['sz3_offload_leaves_total']} leaves, "
                             f"{c8['sz3_offload_leaves_skipped_total']} skipped, {n8_in} bytes in")
    picks8 = [(c["pipeline"], c["n0"] * a.shape[1]) for a, f in streams8
              for c in tc.parse_header(chunking.frames_to_blob(f))[0]["chunks"]]
    expected8 = _expected_chunk_launches(picks8, 2)
    for name in _CHUNK_KERNEL_NAMES:
        if off8_launches[name] != expected8[name]:
            raise AssertionError(f"serve int8 offload: kernel {name} launched {off8_launches[name]} times, "
                                 f"expected {expected8[name]}")
        launches_total[name] += off8_launches[name]

    # the weight-stationary decode of both runs, from their prompt tokens
    peak_plain = torch.cuda.max_memory_allocated() / 1e9
    stationary = _serve_stationary(cfg, params, seed, {"bf16": (bf, bf_lat), "int8": (i8, i8_lat)}, launches_total)

    # the kvquant kernels at the decode shape: the fused append on layer 0's
    # token at slot 0 (bf16, as served) into the int8 cache, and the
    # standalone pair on (hd, B * KV) per call
    timer = Timer(reps=CHUNK_REPS, warmup=5)
    k0, v0 = (t[0][:, 0:1].contiguous() for t in (bf.cache.k, bf.cache.v))
    append = append_timings(k0, v0, [t[0].clone() for t in (i8.cache.k, i8.cache.v, i8.cache.k_scale,
                                                               i8.cache.v_scale)], timer, bw)
    shape = (cfg.hd, B * cfg.n_kv_heads)
    x = bf.cache.k[0, :, 0].reshape(-1, cfg.hd).to(torch.float32).T.contiguous()  # layer 0, slot 0
    n = x.numel()
    amax = KK.absmax(x)
    s8 = KR.scale_from_absmax(amax)
    serve_cases = {
        "absmax": {
            "kernel_ms": timer(lambda: KK.absmax(x)), "plain_ms": timer(lambda: KR.absmax(x)),
            "library_ms": timer(lambda: torch.amax(x.abs(), 0)), **bound(4 * n + 4 * shape[1], 2 * n, bw),
            "bit_identical": same_bits(amax, KR.absmax(x)),
        },
        "quantize_with_scale": {
            "kernel_ms": timer(lambda: KK.quantize_with_scale(x, s8)),
            "plain_ms": timer(lambda: KR.quantize_with_scale(x, s8)),
            "library_ms": None, **bound(5 * n + 4 * shape[1], 4 * n, bw),
            "bit_identical": torch.equal(KK.quantize_with_scale(x, s8), KR.quantize_with_scale(x, s8)),
        },
        "quantize_append": append,
    }
    for name, c in serve_cases.items():
        c.setdefault("shape", list(shape))
        emit(f"kernel {name} serve {'x'.join(map(str, c['shape']))}", name=name, **c)
        if not c["bit_identical"]:
            raise AssertionError(f"{name} at the decode shape {c['shape']} differs from its plain version")
        cases[name].update({
            "serve_shape": c["shape"], "serve_launches": i8_launches[name], "serve_ms": c["kernel_ms"],
            "serve_plain_ms": c["plain_ms"], "serve_library_ms": c["library_ms"], "serve_bound_ms": c["bound_ms"],
        })
    emit(
        "serve granite-3-8b",
        config={"layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "padded_vocab": cfg.padded_vocab,
                "dtype": cfg.dtype},
        params=n_params,
        n_flop_params=cfg.n_flop_params(),
        weight_bytes=weight_bytes,
        init_s=t_init,
        batch=B,
        tokens=T,
        bf16={"tok_per_s": bf.tok_per_s, "seconds": bf.seconds, **bf_lat,
              "weight_read_bound_step_ms": weight_bytes / bw * 1e3,
              "sample": bf.sequences[0].tolist()},
        prefill_max_abs_err=pre_err,
        prefill_rtol=pre_err / logit_scale,
        prefill_tolerance=SERVE_PREFILL_RTOL,
        prefill_logprob_diff=pre_logprob,
        prefill_argmax_equal=bool((pre.argmax(-1) == bf.logits.argmax(-1)).all()),
        offload={"leaves": leaves, "n_in": n_in, "n_out": n_out, "ratio": n_in / n_out, "seconds": t_off,
                 "MBps": n_in / 1e6 / t_off, "verify_seconds": verify_s,
                 "verify_share": verify_s / t_off, "frames": sum(len(f) - 1 for _, f in streams),
                 "launches": {k: v for k, v in off_launches.items() if v},
                 "expected_launches": {k: v for k, v in expected.items() if v},
                 "k_leaf_same_bytes_as_plain_route": True, "k_leaf_max_abs_err": off_err, "abs_eb": abs_eb,
                 "plain_cpu_compress_s": t_plain, "traced_seconds": tr.seconds, "traced_stage_seconds": stages,
                 "host_coding_share": host_coding_share},
        int8={"tok_per_s": i8.tok_per_s, "seconds": i8.seconds, **i8_lat,
              "launches": {k: v for k, v in i8_launches.items() if v},
              "greedy_tokens_equal_bf16": bool((i8.sequences == bf.sequences).all()),
              "logprob_drift_from_bf16": drift, "drift_bound": SERVE_INT8_DRIFT},
        quantize_token_bit_identical=same,
        fused_append_against_old_sequence=fused_vs_old,
        append_host_us_per_layer=append["host"],
        int8_offload={"n_in": n8_in, "n_out": n8_out, "ratio": n8_in / n8_out, "seconds": t8_off,
                      "leaves": 2, "skipped": 4,
                      "launches": {k: v for k, v in off8_launches.items() if v}},
        weight_stationary=stationary,
        peak_memory_GB=max(peak_plain, torch.cuda.max_memory_allocated() / 1e9),
    )
    del params, bf, i8, cache8
    torch.cuda.empty_cache()


#: the families phase: the other model families through the serve launcher
#: at their full configs with the launcher's defaults (batch 4, 16 greedy
#: tokens); qwen3-moe-30b-a3b's depth cut from 48 layers to 8 (the cut that
#: keeps the script's time; its width, GQA and 128 experts at top-8 stay)
FAMILY_ARCHS = (("deepseek-moe-16b", None), ("qwen3-moe-30b-a3b", 8), ("mamba2-2.7b", None), ("zamba2-7b", None),
                ("whisper-small", None))
#: bytes at rest of the cache leaves offloaded a family: the first leaves in
#: the reference's order, the one that does not fit cut to its leading
#: layers (the float32 SSM states and whisper's cross K/V run to 221-671 MB,
#: 10-30 s each of host coding)
FAMILY_OFFLOAD_BYTES = 64 << 20
#: the MoE card-against-CPU check: full width, float32, the dense prefix
#: layer and one MoE layer (two MoE layers without a dense prefix), 4 decode
#: steps and a prefill over 16 tokens from one set of weights
MOE_CHECK_LAYERS, MOE_CHECK_STEPS, MOE_CHECK_PREFILL = 2, 4, 16
#: the MoE int8 drift: the reference itself drifts past its 0.3 at full
#: width, and at its deepseek smoke config in bf16, as a token's top-k set
#: flips under the int8 noise and it takes other experts' outputs
#: (``ROADMAP.md`` queue 3).  So each MoE arch is held against the
#: reference's own reading in ``MOE_DRIFT_READINGS`` (``tools/moe_int8_drift.py``
#: on the CPU) at full width, the depth and seed of ``MOE_DRIFT_HELD``
#: (deepseek-moe-16b at 8 layers, the deepest the reference was read at;
#: qwen3-moe-30b-a3b at 3, whose 8 would add 55 s of CPU draw): the same
#: weights (the port's CPU draw from the seed, its fingerprint checked),
#: tokens and depth on the card, with the reference's top-k ids pinned,
#: within ``MOE_DRIFT_RTOL`` of the reference's drift plus ``MOE_DRIFT_ATOL``
MOE_DRIFT_READINGS = ROOT / "tools" / "moe_int8_drift.json"
MOE_DRIFT_HELD = {"deepseek-moe-16b": (8, 0), "qwen3-moe-30b-a3b": (3, 0)}
#: Set from the port on the CPU against the reference with the same routing
#: (the tool's ``with_reference_routing``), written before the first card
#: reading: at 3 full-width layers over 8 readings the two differ by at most
#: 0.033 (drift 0.20-4.33) and 0.038 (routing held, 0.16-0.23); bf16 logits
#: of scale 4-5 round to 0.016-0.031, so the card, whose GEMMs sum in yet
#: another order, is allowed 5% of the reference's drift plus 0.1.  The
#: first card readings (H100 80GB HBM3, 700 W) differed by 0.094 and 0.0005
#: (deepseek-moe-16b, 8 layers) and 0.024 and 0.008 (qwen3-moe-30b-a3b, 3)
MOE_DRIFT_RTOL, MOE_DRIFT_ATOL = 0.05, 0.1
#: its logits, card against CPU, relative to the largest |logit|: float32
#: GEMMs summed in other orders (cuBLAS against the CPU's BLAS); the first
#: readings were 2.27e-6 (deepseek-moe-16b) and 2.69e-6 (qwen3-moe-30b-a3b)
#: on an H100 80GB HBM3 at 700 W, and the bound is about 7 times those
MOE_CHECK_RTOL = 2e-5


@contextlib.contextmanager
def recording_routing():
    """``models.moe._dispatch`` wrapped for the block: each call's top-k ids,
    slot map and kept flags are kept (no sync, no launch)."""
    from repro_torch.models import moe

    real = moe._dispatch
    calls = []

    def recording(idx, gates, n_experts, C):
        out = real(idx, gates, n_experts, C)
        calls.append((idx, out[0], out[2]))
        return out

    moe._dispatch = recording
    try:
        yield calls
    finally:
        moe._dispatch = real


def _cache_fields(cache) -> list:
    """(name, leaf) in the reference's leaf order (an ``EncDecCache``'s self
    cache first)."""
    out = []
    for f in dataclasses.fields(cache):
        value = getattr(cache, f.name)
        if dataclasses.is_dataclass(value):
            out += [(f"{f.name}.{n}", t) for n, t in _cache_fields(value)]
        elif value is not None:
            out.append((f.name, value))
    return out


def _offload_cut(cache, budget: int):
    """The float leaves of at least 1024 elements, in the reference's order,
    whole while their bytes at rest fit ``budget``; the first that does not,
    cut to the leading layers that fit (one layer if nothing went before);
    nothing after it.  Returns (leaves, names, bytes, cut)."""
    leaves, names, used, cut = [], [], 0, None
    fields = [(n, t) for n, t in _cache_fields(cache) if t.is_floating_point() and t.numel() >= 1024]
    for i, (name, t) in enumerate(fields):
        nbytes = t.numel() * t.element_size()
        if used + nbytes <= budget:
            leaves.append(t)
            names.append(name)
            used += nbytes
            continue
        per_layer = nbytes // t.shape[0]
        n = (budget - used) // per_layer or (0 if leaves else 1)  # at least one layer of something
        if n:
            leaves.append(t[:n])
            names.append(f"{name}[:{n}]")
            used += n * per_layer
        cut = {"leaf": name, "layers_kept": int(n), "layers": int(t.shape[0]),
               "left_out": [m for m, _ in fields[i + 1 :]],
               "bytes_left_out": sum(u.numel() * u.element_size() for _, u in fields[i:]) - int(n) * per_layer}
        break
    return leaves, names, used, cut


def _family_offload(cache, launches_total: dict) -> dict:
    """The bf16 cache's first ``FAMILY_OFFLOAD_BYTES`` through
    ``offload_cache`` (chunked, REL 1e-3, strict verify): launches equal to
    the chunks routed to each kernel, each leaf decoded on the card within
    its blob's bound."""
    import repro_torch.core as tc
    from repro_torch.core import chunking, telemetry
    from repro_torch.launch import serve as ls

    leaves, names, used, cut = _offload_cut(cache, FAMILY_OFFLOAD_BYTES)
    telemetry.reset_metrics()
    n_in, n_out, seconds, streams, launches = _offload_recorded(
        lambda c: ls.offload_cache(c, eb=1e-3, device="cuda"), leaves)
    if len(streams) != len(leaves) or n_in != used:
        raise AssertionError(f"families offload: {len(streams)} streams for {len(leaves)} leaves, {n_in} bytes in "
                             f"for {used}")
    picks_all, per_leaf = [], []
    for (arr, frames), name in zip(streams, names):
        blob = chunking.frames_to_blob(frames)
        chunks = tc.parse_header(blob)[0]["chunks"]
        picks = [(c["pipeline"], c["n0"] * arr.shape[1]) for c in chunks]
        picks_all += picks
        abs_eb = min(tc.parse_header(b)[0]["abs_eb"] for b in _chunk_blobs(blob))
        back = tc.decompress(blob, device="cuda")
        err = float((back.double() - arr.double()).abs().max())
        if not err <= abs_eb:
            raise AssertionError(f"families offload: leaf {name} error {err} breaks its bound {abs_eb}")
        per_leaf.append({"leaf": name, "shape": list(arr.shape), "chunks": len(chunks), "max_abs_err": err,
                         "abs_eb": abs_eb, "picks": dict(collections.Counter(p for p, _ in picks))})
    expected = _expected_chunk_launches(picks_all, 2)
    for name in _CHUNK_KERNEL_NAMES:
        if launches[name] != expected[name]:
            raise AssertionError(f"families offload: kernel {name} launched {launches[name]} times, expected "
                                 f"{expected[name]} for the chunks routed to it")
        launches_total[name] += launches[name]
    return {"leaves": per_leaf, "n_in": n_in, "n_out": n_out, "ratio": n_in / n_out, "seconds": seconds,
            "MBps": n_in / 1e6 / seconds, "cut": cut,
            "launches": {k: v for k, v in launches.items() if v}}


def _moe_card_against_cpu(cfg, seed: int) -> dict:
    """``MOE_CHECK_LAYERS`` layers of ``cfg`` at full width in float32 from
    one set of weights, on the card and on the CPU: every call's top-k ids,
    slot map and kept flags identical, the logits within
    ``MOE_CHECK_RTOL`` of the largest |logit|."""
    from repro_torch import models
    from repro_torch import tree as tree_util
    from repro_torch.models import moe
    from repro_torch.parallel import ParallelPlan

    plan = ParallelPlan()
    cfg2 = dataclasses.replace(cfg, n_layers=MOE_CHECK_LAYERS, dtype="float32")
    card = models.init_params(seed, cfg2, plan, device="cuda")
    host = models.DecoderLM(cfg2, plan, tree_util.tree_map(lambda t: t.cpu(), card.tree()))
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    toks = torch.randint(0, cfg.vocab, (SERVE_BATCH, MOE_CHECK_PREFILL), generator=gen, device="cuda",
                         dtype=torch.int32)

    def run(model, dev):
        tk = toks.to(dev)
        with recording_routing() as calls, torch.no_grad():
            cache = models.init_cache(model, cfg2, plan, SERVE_BATCH, MOE_CHECK_PREFILL)
            outs = []
            for t in range(MOE_CHECK_STEPS):
                logits, cache = models.decode_step(model, cache, tk[:, t : t + 1], cfg2, plan)
                outs.append(logits)
            outs.append(models.prefill_logits(model, {"tokens": tk}, cfg2, plan))
        return [o.cpu() for o in outs], [tuple(a.cpu() for a in c) for c in calls]

    t0 = time.perf_counter()
    card_logits, card_calls = run(card, "cuda")
    host_logits, host_calls = run(host, "cpu")
    seconds = time.perf_counter() - t0
    if len(card_calls) != len(host_calls) or not all(
            all(torch.equal(a, b) for a, b in zip(c, h)) for c, h in zip(card_calls, host_calls)):
        raise AssertionError(f"families {cfg.name}: the card's routing differs from the CPU's")
    err = max(float((c - h).abs().max()) for c, h in zip(card_logits, host_logits))
    scale = max(float(h.abs().max()) for h in host_logits)
    if not err <= MOE_CHECK_RTOL * scale:
        raise AssertionError(f"families {cfg.name}: card and CPU logits differ by {err}, over {MOE_CHECK_RTOL} of "
                             f"the largest |logit| {scale}")
    kept = [int(k.sum()) for _, _, k in card_calls]
    return {"layers": MOE_CHECK_LAYERS, "dtype": "float32", "calls": len(card_calls), "routing_identical": True,
            "max_abs_err": err, "rel_err": err / scale, "tolerance": MOE_CHECK_RTOL, "seconds": seconds,
            "prefill_dropped_share": 1 - kept[-1] / (SERVE_BATCH * MOE_CHECK_PREFILL * cfg.top_k),
            "prefill_capacity": moe.capacity(SERVE_BATCH * MOE_CHECK_PREFILL, cfg.top_k, cfg.n_experts)}


def _forced_int8_drift(params, cfg, tokens: torch.Tensor, ref_logits: torch.Tensor, frames=None):
    """int8 steps fed ``tokens`` (B, T) one column at a time: the
    log-probability drift of the last step's logits from ``ref_logits``,
    and the routing recorded (MoE)."""
    from repro_torch import models
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import ParallelPlan
    from repro_torch.serve.step import make_serve_step

    plan8 = ParallelPlan(kv_cache_dtype="int8")
    step = make_serve_step(cfg, plan8)
    B, T = tokens.shape
    cache = models.init_cache(params, cfg, plan8, B, T + 8, enc_frames=frames)
    with recording_routing() as routing, float32_bf16_reductions():
        for t in range(T):
            logits, cache = step(params, cache, tokens[:, t : t + 1])
    return float((torch.log_softmax(logits, -1) - torch.log_softmax(ref_logits, -1)).abs().max()), routing


def _drift_tool():
    """``tools/moe_int8_drift.py`` (its port side imports no JAX)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("moe_int8_drift", ROOT / "tools" / "moe_int8_drift.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _moe_drift_against_reference(arch: str) -> dict:
    """The int8 drift of ``arch`` on the card at the weights, tokens and
    depth of the reference's reading in ``MOE_DRIFT_READINGS``: the port's
    CPU draw from the reading's seed (its fingerprint checked) moved to the
    card and read by the tool's ``port_readings``.  With the reference's
    top-k ids pinned, the drift and the drift with the routing held at the
    bf16 run's must each be within ``MOE_DRIFT_RTOL`` of the reference's
    plus ``MOE_DRIFT_ATOL``; the card's free-running readings are
    reported beside the reference's and the port's on the CPU."""
    from repro_torch import configs

    tool = _drift_tool()
    layers, seed = MOE_DRIFT_HELD[arch]
    line = next(r for r in json.loads(MOE_DRIFT_READINGS.read_text())
                if (r["arch"], r["layers"], r["seed"]) == (arch, layers, seed))
    cfg = dataclasses.replace(configs.get(arch), n_layers=line["layers"])
    t0 = time.perf_counter()
    model, _ = tool.draw(cfg, line["seed"])
    if tool.fingerprint(model.tree()) != line["weights_sha256"]:
        raise AssertionError(f"families {arch}: the CPU draw from seed {line['seed']} differs from the weights of "
                             f"the reference's reading")
    model.to("cuda")
    t_draw = time.perf_counter() - t0
    ref = line["reference"]
    t0 = time.perf_counter()
    card = tool.port_readings(model, cfg, np.asarray(line["token_ids"], dtype=np.int32), ref)
    seconds = time.perf_counter() - t0
    for key in ("drift", "drift_routing_pinned"):
        got, want = card["with_reference_routing"][key], ref[key]
        if not abs(got - want) <= MOE_DRIFT_RTOL * want + MOE_DRIFT_ATOL:
            raise AssertionError(f"families {arch} int8 at {line['layers']} layers with the reference's routing: "
                                 f"{key} {got} on the card, the reference's {want}, tolerance {MOE_DRIFT_RTOL} "
                                 f"relative plus {MOE_DRIFT_ATOL}")
    del model
    torch.cuda.empty_cache()
    return {"layers": line["layers"], "seed": line["seed"], "weights_sha256": line["weights_sha256"],
            "reference": {k: v for k, v in ref.items() if not k.startswith("routing")}, "port_cpu": line["port"],
            "card": card, "rtol": MOE_DRIFT_RTOL, "atol": MOE_DRIFT_ATOL, "draw_s": t_draw, "seconds": seconds}


def _moe_decode_checks(cfg, params, bf, routing, plan) -> dict:
    """The share of assignments dropped at each bf16 step (from the
    recorded routing), and one decode step from one cache run twice: the
    same bits."""
    from repro_torch import models
    from repro_torch.models import moe
    from repro_torch.models.common import float32_bf16_reductions

    n_moe = cfg.n_layers - cfg.dense_prefix_layers
    per_call = SERVE_BATCH * cfg.top_k
    kept = torch.stack([k.sum() for _, _, k in routing]).cpu().reshape(SERVE_TOKENS, n_moe)
    dropped = (1 - kept.sum(1).double() / (n_moe * per_call)).tolist()
    tok = torch.from_numpy(bf.sequences[:, SERVE_TOKENS:]).cuda()  # the last token, never fed back
    runs = []
    for _ in range(2):
        cache = dataclasses.replace(bf.cache, **{n: t.clone() for n, t in _cache_fields(bf.cache)})
        with float32_bf16_reductions(), torch.no_grad():
            logits, cache = models.decode_step(params, cache, tok, cfg, plan)
        runs.append([logits] + [t for _, t in _cache_fields(cache)])
    torch.cuda.synchronize()
    same = all(same_bits(a, b) for a, b in zip(*runs))
    if not same:
        raise AssertionError(f"families {cfg.name}: one decode step from one cache gave different bits twice")
    return {"capacity_decode": moe.capacity(SERVE_BATCH, cfg.top_k, cfg.n_experts),
            "capacity_prefill_64": moe.capacity(64, cfg.top_k, cfg.n_experts),
            "dropped_share_per_step": dropped, "second_step_bit_identical": True}


def _family_kernel_cases(cfg, self_cache, timer, bw: float) -> dict:
    """The fused append at the family's int8 append shape (B, 1, KV, hd) in
    bf16, and ``absmax`` and ``quantize_with_scale`` at (hd, B·KV): layer
    0's slot 0 of the bf16 cache's K (and V)."""
    from repro_torch.kernels.kvquant import kernel as KK
    from repro_torch.kernels.kvquant import ref as KR

    k_cache = self_cache.k
    k0, v0 = (t[0][:, 0:1].contiguous() for t in (self_cache.k, self_cache.v))
    g = torch.Generator(device="cuda").manual_seed(cfg.hd + k_cache.shape[3])
    prior = [torch.randint(-127, 128, k_cache.shape[1:], generator=g, device="cuda", dtype=torch.int8)
             for _ in range(2)] + [torch.rand(k_cache.shape[1:4], generator=g, device="cuda") for _ in range(2)]
    append = append_timings(k0, v0, prior, timer, bw)
    x = k_cache[0, :, 0].reshape(-1, cfg.hd).to(torch.float32).T.contiguous()
    n, cols = x.numel(), x.shape[1]
    amax = KK.absmax(x)
    s8 = KR.scale_from_absmax(amax)
    out = {
        "absmax": {"kernel_ms": timer(lambda: KK.absmax(x)), "plain_ms": timer(lambda: KR.absmax(x)),
                   "library_ms": timer(lambda: torch.amax(x.abs(), 0)), **bound(4 * n + 4 * cols, 2 * n, bw),
                   "bit_identical": same_bits(amax, KR.absmax(x))},
        "quantize_with_scale": {"kernel_ms": timer(lambda: KK.quantize_with_scale(x, s8)),
                                "plain_ms": timer(lambda: KR.quantize_with_scale(x, s8)), "library_ms": None,
                                **bound(5 * n + 4 * cols, 4 * n, bw),
                                "bit_identical": torch.equal(KK.quantize_with_scale(x, s8),
                                                             KR.quantize_with_scale(x, s8))},
    }
    for c in out.values():
        c["shape"] = list(x.shape)
    out["quantize_append"] = append
    for name, c in out.items():
        if not c["bit_identical"]:
            raise AssertionError(f"{name} at the {cfg.name} append shape {c['shape']} differs from its plain "
                                 f"version")
    return out


def phase_families(seed: int, launches_total: dict, cases: dict, bw: float) -> None:
    """The MoE, SSM, hybrid and encoder-decoder families through
    ``repro_torch.launch.serve.serve`` at full width (``FAMILY_ARCHS``):
    size and speed of 16 greedy bf16 steps (no kernel launched); fidelity
    (prefill against the last step within ``SERVE_PREFILL_RTOL``; for MoE,
    whose prefill and decode drop different assignments by design, the
    share dropped at each step, a step from one cache twice to the same
    bits and ``_moe_card_against_cpu``); 16 int8 steps (``quantize_append``
    attention layers x 16 times, the standalone pair never, the
    drift from bf16 under ``SERVE_INT8_DRIFT``, for MoE reported and held
    against the reference's own reading (``_moe_drift_against_reference``),
    ``_quantize_token`` on the card against its plain version, the fused
    append against the sequence it replaced; mamba2-2.7b's int8 run equal
    to its bf16 run); the bf16 cache's first 64 MB through
    ``offload_cache``."""
    from repro_torch import configs, models
    from repro_torch.core import telemetry
    from repro_torch.launch import serve as ls
    from repro_torch.models import lm
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import ParallelPlan

    plan, plan8 = ParallelPlan(), ParallelPlan(kv_cache_dtype="int8")
    B, T = SERVE_BATCH, SERVE_TOKENS
    timer = Timer(reps=CHUNK_REPS, warmup=5)
    for name in ("absmax", "quantize_with_scale", "quantize_append"):
        cases[name].update({"families_launches": {}, "families_shapes": {}})
    for arch, depth in FAMILY_ARCHS:
        t_family = time.perf_counter()
        cfg = configs.get(arch)
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = models.init_params(seed, cfg, plan, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(t.numel() for t in params.parameters())
        weight_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
        frames = ls.stub_frames(cfg, B, seed, "cuda") if cfg.family == "encdec" else None
        La = cfg.n_layers if cfg.family == "encdec" else lm._n_attn_layers(cfg)  # the int8 appends a step
        out = {"config": {f: getattr(cfg, f) for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                                                       "d_ff", "vocab", "n_experts", "top_k", "moe_d_ff",
                                                       "n_shared_experts", "dense_prefix_layers", "ssm_state",
                                                       "ssm_head_dim", "hybrid_attn_every", "n_enc_layers",
                                                       "enc_seq", "dtype")},
               "reduced": {"n_layers": [configs.get(arch).n_layers, depth]} if depth else {},
               "params": n_params, "weight_bytes": weight_bytes, "init_s": t_init, "batch": B, "tokens": T,
               "attention_layers": La}

        # 1. bf16: 16 greedy steps, the routing recorded
        telemetry.reset_metrics()
        torch.cuda.synchronize()
        with recording_routing() as routing:
            reset_all_launches()
            bf = ls.serve(cfg, plan, B, T, arch=arch, seed=seed, params=params)
            torch.cuda.synchronize()
            bf_launches = {k: v for k, v in all_launches().items() if v}
        if bf_launches:
            raise AssertionError(f"families {arch}: a bf16 decode launched kernels {bf_launches}")
        if bf.sequences.shape != (B, T + 1) or tuple(bf.logits.shape) != (B, cfg.vocab) \
                or not bool(torch.isfinite(bf.logits).all()) or not (bf.sequences < cfg.vocab).all():
            raise AssertionError(f"families {arch}: tokens {bf.sequences.shape}, logits {tuple(bf.logits.shape)}, "
                                 f"or non-finite logits")
        out["bf16"] = {"tok_per_s": bf.tok_per_s, "seconds": bf.seconds, **_step_latency(),
                       "weight_read_bound_step_ms": weight_bytes / bw * 1e3, "sample": bf.sequences[0].tolist()}
        consumed = torch.from_numpy(bf.sequences[:, :T]).cuda()  # the last token was never fed back

        # 2. fidelity
        if cfg.family == "moe":
            out["moe"] = _moe_decode_checks(cfg, params, bf, routing, plan)
        else:
            batch = {"tokens": consumed}
            if frames is not None:
                batch["enc_frames"] = frames
            with float32_bf16_reductions(), torch.no_grad():
                pre = models.prefill_logits(params, batch, cfg, plan)
            pre_err = float((pre - bf.logits).abs().max())
            scale = float(bf.logits.abs().max())
            if not pre_err <= SERVE_PREFILL_RTOL * scale:
                raise AssertionError(f"families {arch}: prefill differs from the last decode step by {pre_err}, "
                                     f"over {SERVE_PREFILL_RTOL} of the largest |logit| {scale}")
            out["prefill"] = {"max_abs_err": pre_err, "rtol": pre_err / scale, "tolerance": SERVE_PREFILL_RTOL,
                              "argmax_equal": bool((pre.argmax(-1) == bf.logits.argmax(-1)).all())}
            del pre

        # 3. int8: 16 greedy steps through the kvquant kernels
        telemetry.reset_metrics()
        torch.cuda.synchronize()
        reset_all_launches()
        i8 = ls.serve(cfg, plan8, B, T, arch=arch, seed=seed, params=params)
        torch.cuda.synchronize()
        i8_launches = all_launches()
        i8_lat = _step_latency()
        want = La * T
        if i8_launches["quantize_append"] != want or i8_launches["absmax"] or i8_launches["quantize_with_scale"]:
            raise AssertionError(f"families {arch} int8: quantize_append launched {i8_launches['quantize_append']} "
                                 f"times, expected {want}; absmax {i8_launches['absmax']} and quantize_with_scale "
                                 f"{i8_launches['quantize_with_scale']} times, expected 0")
        launches_total["quantize_append"] += want
        for name in ("absmax", "quantize_with_scale", "quantize_append"):
            cases[name]["families_launches"][arch] = i8_launches[name]
        others = {k: v for k, v in i8_launches.items() if v and k != "quantize_append"}
        if others or not bool(torch.isfinite(i8.logits).all()):
            raise AssertionError(f"families {arch} int8: other kernels {others}, or non-finite logits")
        if La == 0 and not (np.array_equal(i8.sequences, bf.sequences) and same_bits(i8.logits, bf.logits)):
            raise AssertionError(f"families {arch}: without attention the int8 run must equal the bf16 run")
        drift, routing8 = _forced_int8_drift(params, cfg, consumed, bf.logits, frames)
        out["int8"] = {"tok_per_s": i8.tok_per_s, "seconds": i8.seconds, **i8_lat,
                       "launches": {k: v for k, v in i8_launches.items() if v}, "expected_launches_each": want,
                       "greedy_tokens_equal_bf16": bool((i8.sequences == bf.sequences).all()),
                       "logprob_drift_from_bf16": drift, "drift_bound": SERVE_INT8_DRIFT}
        if cfg.family == "moe":
            # the reference has no reading at this depth: reported, and held
            # at the depth of its reading (_moe_drift_against_reference)
            ids, ids8 = ([c[0].cpu().numpy() for c in r] for r in (routing, routing8))
            out["int8"].update(assignments=sum(a.shape[0] for a in ids),
                               topk_set_changed=_drift_tool().set_changes(ids, ids8))
        elif not drift < SERVE_INT8_DRIFT:
            raise AssertionError(f"families {arch} int8: log-probability drift {drift} from bf16, bound "
                                 f"{SERVE_INT8_DRIFT}")
        self_cache = bf.cache.self_cache if cfg.family == "encdec" else bf.cache
        if La:
            i8_self = i8.cache.self_cache if cfg.family == "encdec" else i8.cache
            out["fused_append_against_old_sequence"] = append_against_old_sequence(self_cache, i8_self,
                                                                                    f"families {arch}")
        del i8, routing8
        if La:
            same = {}
            for name in ("k", "v"):
                x = getattr(self_cache, name)
                q, scale8 = lm._quantize_token(x)
                torch.cuda.synchronize()
                pq, ps = lm._quantize_token(x.cpu())
                same[name] = bool(torch.equal(q.cpu(), pq) and same_bits(scale8.cpu(), ps))
                if not same[name]:
                    raise AssertionError(f"families {arch}: _quantize_token of the {name} cache differs on the "
                                         f"card from its plain version")
            out["quantize_token_bit_identical"] = same
            for name, c in _family_kernel_cases(cfg, self_cache, timer, bw).items():
                cases[name]["families_shapes"][arch] = c
                out.setdefault("kernels", {})[name] = c
        out["peak_memory_GB"] = torch.cuda.max_memory_allocated() / 1e9

        # 4. the bf16 cache's first 64 MB through the offload
        out["offload"] = _family_offload(bf.cache, launches_total)
        del params, bf, routing
        torch.cuda.empty_cache()
        if cfg.family == "moe":
            out["moe"]["card_against_cpu"] = _moe_card_against_cpu(cfg, seed)
            torch.cuda.empty_cache()
            out["moe"]["int8_drift_against_reference"] = _moe_drift_against_reference(arch)
        out["seconds"] = time.perf_counter() - t_family
        emit(f"families {arch}", **out)


#: the train phase: the reference launcher's default architecture at full
#: width and depth (24 layers, d_model 1024, 16/16 heads, d_ff 2816, vocab
#: 151936, tied embedding, QKV bias, bf16), at ``configs/shapes.py``'s
#: ``train_4k`` sequence of 4096 with the global batch cut from 256 to 8, in
#: the reference's ``TRAIN_MICROBATCHES`` for it (2, ``launch/plans.py``),
#: remat ``full``; 6 steps a run, at the launcher's learning rate
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = "qwen1.5-0.5b", 4096, 8, 6, 3e-3
#: its parameters: 463,987,712 with the vocabulary unpadded (``QWEN``'s
#: tree), plus 128 embedding rows of padding to 152,064 (a multiple of 256)
TRAIN_PARAMS = 463_987_712 + 128 * 1024
#: the first loss of a random model sits near ln(vocab)
TRAIN_FIRST_LOSS_SLACK = 0.5
#: tests/test_system.py::test_microbatched_step_matches_unbatched's bound
#: on the first loss at microbatches 1 and 2
TRAIN_MICRO_TOL = 1e-3
#: and, between the same two steps, the grad norm's relative difference and
#: the first moment's (the clipped gradient itself) relative L2 difference:
#: on an H100 (700 W) at seeds 0 and 1 they read 1.0e-4 and 1.9e-4, and
#: 2.60e-3 and 2.59e-3 (bf16 gradients rounded once or twice).  A missing
#: 1/n doubles the grad norm (0.5); one microbatch alone reads 0.2 and 0.67
#: on the bf16 smoke config on the CPU
TRAIN_MICRO_GNORM_RTOL, TRAIN_MICRO_MOMENT_RTOL = 2e-3, 1e-2
#: (b) the card against the CPU: each step's loss, relative
TRAIN_CPU_RTOL = 1e-5
#: (c) the loss drop over 25 steps on one repeated batch (smoke config,
#: float32, the launcher's seq 64 and batch 4, lr 3e-3, no weight decay),
#: written before the first chip run; the CPU drops 1.754
TRAIN_LEARN_STEPS, TRAIN_LEARN_DROP = 25, 1.0


#: the sharded sub-run: Qwen1.5-0.5B's train_4k cell plan on a (1, 1)
#: data x model mesh, whose losses are held against the plain run's: the
#: local ops are the plain run's, so they are expected equal; a sum taken
#: in another order would be held within this relative bound
TRAIN_SHARDED_RTOL = 1e-5
#: expert parallelism on the same mesh: deepseek-moe-16b at full width,
#: depth cut from 28 layers to 4 (1 dense, 3 MoE), one batch of 1 x 4096
#: tokens; the loss of the sharded plan against the plain plan's, at the
#: default capacity and drop-free (the reference's contract: within 0.5 at
#: the default, equal drop-free)
EP_ARCH, EP_LAYERS, EP_BATCH, EP_SEQ, EP_DROPFREE = "deepseek-moe-16b", 4, 1, 4096, 16.0
EP_DEFAULT_ATOL = 0.5


def _train_sharded(cfg, seed: int, plain: dict) -> dict:
    """The sharded sub-run on a one-card NCCL mesh (data 1 x model 1):
    ``make_cell_plan`` for the train_4k cell (FSDP over data, the
    reference's microbatches), the full state drawn from the plain run's
    seed and placed as DTensors, ``TRAIN_STEPS`` steps through
    ``jit_train_step`` on the plain run's batches; then expert parallelism
    (:func:`_train_expert_parallel`) on the same mesh.  Tears the process
    group down."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import tree as tree_util
    from repro_torch.data import make_pipeline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.plans import TRAIN_MICROBATCHES, make_cell_plan
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, jit_train_step, make_train_step

    mesh = make_debug_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        plan, popt = make_cell_plan(TRAIN_ARCH, cfg, configs.SHAPES["train_4k"], mesh)
        if (plan.fsdp_axes, plan.microbatches, plan.batch_axes, plan.tp, plan.dp) != \
                (("data",), TRAIN_MICROBATCHES[TRAIN_ARCH], ("data",), 1, 1):
            raise AssertionError(f"train sharded: the cell plan is {plan}")
        opt = AdamWConfig(lr=TRAIN_LR, compress_moments=popt.compress_moments)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        state = init_train_state(seed, cfg, plan, opt, device="cuda")
        leaves = tree_util.flatten(state["params"])[0]
        placements = sorted({str(list(t.placements)) for t in leaves})
        if not all(hasattr(t, "placements") for t in leaves):
            raise AssertionError("train sharded: the state's leaves are not DTensors")
        pipe = make_pipeline(cfg, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH)

        def batch(k):
            return {x: torch.from_numpy(v).cuda() for x, v in pipe.batch_at(k).items()}

        step = jit_train_step(make_train_step(cfg, plan, opt, total_steps=TRAIN_STEPS), state, cfg, plan, opt,
                              batch(0))
        losses, norms, secs = [], [], []
        with float32_bf16_reductions():
            t0 = time.perf_counter()
            for k in range(TRAIN_STEPS):  # timed as the launcher times a step: batch, step, sync
                state, m = step(state, batch(k))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                secs.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        launched = {k: v for k, v in all_launches().items() if v}
        if launched:
            raise AssertionError(f"train sharded: a train step launched kernels {launched}")
        del state, step
        torch.cuda.empty_cache()
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
        if not loss_rel <= TRAIN_SHARDED_RTOL:
            raise AssertionError(f"train sharded: losses {losses} against the plain run's {plain['losses']}")
        p50 = statistics.median(secs)
        out = {
            "mesh": {"shape": [1, 1], "axes": ["data", "model"], "backend": dist.get_backend()},
            "plan": {"fsdp_axes": list(plan.fsdp_axes), "microbatches": plan.microbatches, "remat": plan.remat,
                     "batch_axes": list(plan.batch_axes), "compress_moments": opt.compress_moments},
            "placements": placements, "losses": losses, "grad_norms": norms,
            "losses_bit_equal_plain": losses == plain["losses"], "loss_max_rel_vs_plain": loss_rel,
            "grad_norm_max_rel_vs_plain": max(abs(a - b) / abs(b) for a, b in zip(norms, plain["grad_norms"])),
            "step_seconds": secs, "step_p50_s": p50, "step_p99_s": float(np.percentile(secs, 99)),
            "steady_p50_s": statistics.median(secs[1:]), "peak_memory_GB": peak,
            "p50_over_plain_p50": p50 / plain["step_p50_s"],
            "steady_p50_over_plain": statistics.median(secs[1:]) / plain["steady_p50_s"],
        }
        out["expert_parallel"] = _train_expert_parallel(mesh, seed)
        return out
    finally:
        dist.destroy_process_group()


def _train_expert_parallel(mesh, seed: int) -> dict:
    """``models.loss_fn`` of deepseek-moe-16b (full width, ``EP_LAYERS``
    layers) on one batch under the plain plan and under the expert-parallel
    plan on ``mesh`` (the reference's ``test_moe_expert_parallel_parity``),
    at the default capacity and drop-free.  On one card the model axis has
    one rank: the expert-parallel dispatch runs, but nothing reaches its
    discard bucket and no combine crosses ranks."""
    from repro_torch import configs, models
    from repro_torch.data import make_pipeline
    from repro_torch.models import moe
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import ParallelPlan

    cfg = dataclasses.replace(configs.get(EP_ARCH), n_layers=EP_LAYERS)
    plain, sharded = ParallelPlan(), ParallelPlan(mesh=mesh, batch_axes=("data",))
    t0 = time.perf_counter()
    params = models.init_params(seed, cfg, plain, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_pipeline(cfg, seq=EP_SEQ, global_batch=EP_BATCH).batch_at(0).items()}
    default = moe.CAPACITY_FACTOR
    out = {"arch": EP_ARCH, "layers": EP_LAYERS, "of_layers": configs.get(EP_ARCH).n_layers,
           "experts": cfg.n_experts, "top_k": cfg.top_k, "tokens": EP_BATCH * EP_SEQ,
           "scope": "the expert-parallel dispatch on a model axis of one rank: its discard bucket stays empty "
                    "and no combine crosses ranks; tools/sharded_cards.py runs it across four cards"}
    try:
        with torch.no_grad(), float32_bf16_reductions():
            for name, factor in (("default", default), ("dropfree", EP_DROPFREE)):
                moe.CAPACITY_FACTOR = factor
                one = float(models.loss_fn(params, batch, cfg, plain))
                ep = float(models.loss_fn(params, batch, cfg, sharded))
                out[name] = {"capacity_factor": factor, "plain": one, "expert_parallel": ep, "abs_diff": abs(one - ep)}
    finally:
        moe.CAPACITY_FACTOR = default
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    if not all(math.isfinite(out[k][x]) for k in ("default", "dropfree") for x in ("plain", "expert_parallel")):
        raise AssertionError(f"train expert parallel: non-finite loss {out}")
    if not (out["default"]["abs_diff"] < EP_DEFAULT_ATOL and out["dropfree"]["plain"] == out["dropfree"]["expert_parallel"]):
        raise AssertionError(f"train expert parallel: the sharded plan's loss differs from the plain plan's: {out}")
    return out


def _adam_bound(lr: float, steps: int, total: int) -> float:
    """The most Adam's first steps can move an element whose gradient's sign
    differs between two runs: twice ``lr * lr_scale`` summed over the steps."""
    from repro_torch.optim import warmup_cosine

    return 2 * lr * sum(float(warmup_cosine(torch.tensor(k), total=total)) for k in range(steps))


def _train_run(label, cfg, plan, opt, state, ckpt_dir, n_params) -> dict:
    """``launch.train.train`` for ``TRAIN_STEPS`` steps from ``state`` (no
    checkpoint written): losses, grad norms, step times, model-FLOPs share,
    peak memory; the losses must be finite, the first within
    ``TRAIN_FIRST_LOSS_SLACK`` of ln(vocab); no kernel launches."""
    from repro_torch.launch import train as lt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    res = lt.train(cfg, plan, opt, steps=TRAIN_STEPS, seq=TRAIN_SEQ, batch=TRAIN_BATCH, ckpt_dir=ckpt_dir,
                   ckpt_every=TRAIN_STEPS + 1, device="cuda", state=state)
    launched = {k: v for k, v in all_launches().items() if v}
    if launched:
        raise AssertionError(f"train {label}: a train step launched kernels {launched}")
    if not all(math.isfinite(x) for x in res.losses + res.grad_norms):
        raise AssertionError(f"train {label}: non-finite loss or grad norm {res.losses} {res.grad_norms}")
    first = math.log(cfg.vocab)
    if not abs(res.losses[0] - first) <= TRAIN_FIRST_LOSS_SLACK:
        raise AssertionError(f"train {label}: first loss {res.losses[0]}, ln(vocab) {first}")
    secs = res.step_seconds
    p50 = statistics.median(secs)
    flops = 6 * cfg.n_flop_params() * res.tokens_per_step
    return {
        "losses": res.losses, "grad_norms": res.grad_norms, "step_seconds": secs,
        "step_p50_s": p50, "step_p99_s": float(np.percentile(secs, 99)),
        "steady_p50_s": statistics.median(secs[1:]),
        "tok_per_s_p50": res.tokens_per_step / p50, "tok_per_s_all": res.tokens_per_step * len(secs) / sum(secs),
        "model_flops_per_step": flops, "model_flops_share_p50": flops / p50 / _BF16_TC_RATE,
        "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9, "params": n_params,
    }, res.state


def _train_micro_check(cfg, micro: int, opt, state, batch) -> dict:
    """One full-size step at ``microbatches=1`` and one at ``micro`` from
    clones of ``state`` on one batch: their losses, grad norms and first
    moments after the step.  The first step's learning-rate scale is 0, so
    it moves no parameter; its first moment is ``(1 - b1)`` times the
    clipped gradient, which is where the microbatched accumulation shows
    (a missing ``1 / n`` doubles the grad norm, one microbatch alone turns
    the moment)."""
    from repro_torch import tree as tree_util
    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.parallel import ParallelPlan
    from repro_torch.train.step import make_train_step

    out, moments = {}, {}
    for n in (1, micro):
        run = tree_util.tree_map(lambda t: t.clone(), state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with float32_bf16_reductions():
            run, m = make_train_step(cfg, ParallelPlan(microbatches=n, remat="full"), opt,
                                     total_steps=TRAIN_STEPS)(run, batch)
        out[n] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                  "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9}
        moments[n] = tree_util.flatten(run["opt"]["m"])[0]
        del run, m
        torch.cuda.empty_cache()
    one, many = moments[1], moments[micro]
    diff_sq = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(one, many))
    ref_sq = sum(float(b.double().square().sum()) for b in many)
    m_max = max(float(b.abs().max()) for b in many)
    return {
        "microbatches_1": out[1], f"microbatches_{micro}": out[micro],
        "loss_diff": abs(out[1]["loss"] - out[micro]["loss"]),
        "grad_norm_rel": abs(out[1]["grad_norm"] - out[micro]["grad_norm"]) / out[micro]["grad_norm"],
        "moment_rel_l2": math.sqrt(diff_sq / ref_sq),
        "moment_max_abs_over_max": max(float((a - b).abs().max()) for a, b in zip(one, many)) / m_max,
    }


#: kernel-name fragments of the matrix products (cuBLAS, cuBLASLt, CUTLASS)
_MATMUL_NAMES = ("gemm", "xmma", "nvjet", "cutlass")


def _train_profile(cfg, plan, opt, state, batch) -> dict:
    """One more step of ``state`` under ``torch.profiler`` (CUDA activity
    only): device time by kernel (the top 12) and by kind (matrix products,
    elementwise, reductions, the rest), and the device's busy share of the
    step's wall time (kernel time summed over the wall, which the profiler
    itself slows)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.train.step import make_train_step

    step = make_train_step(cfg, plan, opt, total_steps=TRAIN_STEPS)
    with float32_bf16_reductions():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # kernels only: fewer events to sort
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total", 0) / 1e3
        if ms > 0:
            rows.append((e.key, ms, e.count))
    if not rows:
        return {"wall_s": wall, "device_ms": "not measured (the profiler recorded no device time)"}
    total = sum(ms for _, ms, _ in rows)
    kinds = collections.Counter()
    for name, ms, _ in rows:
        low = name.lower()
        kind = ("matmul" if any(k in low for k in _MATMUL_NAMES) else "elementwise"
                if "elementwise" in low or "vectorized" in low else "reduce" if "reduce" in low else "other")
        kinds[kind] += ms
    rows.sort(key=lambda r: -r[1])
    return {
        "wall_s": wall, "device_ms": total, "device_busy_share": total / 1e3 / wall,
        "kernel_launches": sum(n for _, _, n in rows),
        "by_kind_ms": dict(kinds), "top": [{"kernel": n[:120], "ms": ms, "calls": k} for n, ms, k in rows[:12]],
    }


#: the profiler's FLOP-counted products (``with_flops``)
_PROFILER_DOTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::conv2d")


def _train_flops(cfg, plan, opt, state, batch) -> dict:
    """One more step of ``state`` under ``torch.profiler`` with
    ``with_flops``: the products' FLOPs, those of the calls that launched a
    kernel and those of the calls that did not.  The profiler records an
    aten call where it is dispatched, before autograd: the non-reentrant
    checkpoint's early stop aborts each block's last product in the
    recompute once its inputs are saved, after that record and before the
    kernel, so the sum over every record exceeds the work done.  A kernel
    names the call that launched it (its linked correlation id); the raw
    events are read, not ``prof.events()``, whose tree takes half a minute
    to build at this step's 200,000 events."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.common import float32_bf16_reductions
    from repro_torch.train.step import make_train_step

    step = make_train_step(cfg, plan, opt, total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    with float32_bf16_reductions():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_flops=True) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    raw = prof.profiler.kineto_results.events()
    launched = {e.linked_correlation_id() for e in raw if e.device_type() == torch.autograd.DeviceType.CUDA}
    done, aborted = collections.Counter(), collections.Counter()
    n_aborted = 0
    for e in raw:
        if e.name() not in _PROFILER_DOTS or not e.flops() or e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        if e.correlation_id() in launched:
            done[e.name()] += e.flops()
        else:
            aborted[e.name()] += e.flops()
            n_aborted += 1
    out = {"executed_by_op": dict(done), "calls_without_a_kernel": n_aborted, "their_flops": sum(aborted.values()),
           "recorded_dot_flops": sum(done.values()) + sum(aborted.values()), "kernels": len(launched),
           "step_s": t_step, "read_s": time.perf_counter() - t0 - t_step}
    out["executed_dot_flops"] = (sum(done.values()) if done else
                                 "not measured (the profiler linked no kernel to a product)")
    return out


def _train_resume(cfg, plan, opt, tmp, launches_total, seed: int) -> dict:
    """(d) save and resume through the launcher on the smoke config: under
    the default policy, launches of a save and a restore equal the chunks
    routed to each kernel and every lossy leaf restores within its bound;
    under a lossless policy, the step after the resume equals the
    uninterrupted run's bit for bit."""
    from repro_torch import tree as tree_util
    from repro_torch.data import make_pipeline
    from repro_torch.ft import CheckpointPolicy, LeafPolicy
    from repro_torch.launch import train as lt
    from repro_torch.train.step import make_train_step

    kw = dict(seq=64, batch=4, ckpt_every=2, device="cuda", seed=seed)
    torch.cuda.synchronize()
    reset_all_launches()
    first = lt.train(cfg, plan, opt, steps=2, ckpt_dir=str(tmp / "lossy"), **kw)
    saved = tree_util.tree_map(lambda t: t.clone(), first.state)
    back = lt.train(cfg, plan, opt, steps=2, ckpt_dir=str(tmp / "lossy"), **kw)  # resumes; nothing left to run
    torch.cuda.synchronize()
    launches = all_launches()
    d = tmp / "lossy" / "step_2"
    manifest = json.loads((d / "manifest.json").read_text())
    files = {m["file"]: (d / m["file"]).read_bytes() for m in manifest["leaves"].values()}
    expected, picks = _ckpt_expected_launches(manifest, files)
    for name in _CHUNK_KERNEL_NAMES:
        if launches[name] != expected[name]:
            raise AssertionError(f"train resume: kernel {name} launched {launches[name]} times in a save and a "
                                 f"restore, expected {expected[name]} for the leaves routed to it")
        launches_total[name] += launches[name]
    if back.start != 2 or not sum(expected.values()):
        raise AssertionError(f"train resume: started at {back.start}; expected launches {expected}")
    worst = 0.0
    for (path, want), (_, got) in zip(tree_util.flatten_with_path(saved)[0],
                                      tree_util.flatten_with_path(back.state)[0]):
        meta = manifest["leaves"][path]
        if meta["codec"].startswith("sz3_"):
            bound_ = _leaf_blob_abs_eb(files[meta["file"]])
            err = float((got.double() - want.double()).abs().max())
            if not err <= bound_:
                raise AssertionError(f"train resume: {path}'s error {err} breaks its bound {bound_}")
            worst = max(worst, err / bound_)
        elif not torch.equal(got, want):
            raise AssertionError(f"train resume: lossless leaf {path} did not restore bit for bit")
    # lossless: 2 steps saved, then the third step from the saved state in
    # memory against the third step of a run resumed from the checkpoint
    lossless = CheckpointPolicy(rules=(("", LeafPolicy("lossless")),))
    two = lt.train(cfg, plan, opt, steps=3 - 1, ckpt_dir=str(tmp / "split"), ckpt_policy=lossless, **kw)
    cont = tree_util.tree_map(lambda t: t.clone(), two.state)
    b2 = {k: torch.from_numpy(v).cuda() for k, v in make_pipeline(cfg, seq=64, global_batch=4).batch_at(2).items()}
    cont, m2 = make_train_step(cfg, plan, opt, total_steps=3)(cont, b2)
    resumed = lt.train(cfg, plan, opt, steps=3, ckpt_dir=str(tmp / "split"), ckpt_policy=lossless, **kw)
    same = all(torch.equal(a, b) for a, b in zip(tree_util.flatten(cont)[0], tree_util.flatten(resumed.state)[0]))
    if resumed.start != 2 or resumed.losses != [float(m2["loss"])] or not same:
        raise AssertionError(f"train resume: the resumed step differs from the uninterrupted one "
                             f"({resumed.losses} against {float(m2['loss'])}, state equal: {same})")
    # two runs from the seed, 3 steps each: is the whole run deterministic?
    whole = lt.train(cfg, plan, opt, steps=3, ckpt_dir=str(tmp / "whole"), ckpt_policy=lossless, **kw)
    rerun_equal = all(torch.equal(a, b) for a, b in zip(tree_util.flatten(whole.state)[0],
                                                        tree_util.flatten(resumed.state)[0]))
    return {
        "codecs": dict(collections.Counter(m["codec"] for m in manifest["leaves"].values())),
        "chunk_picks": dict(collections.Counter(p for p, _ in picks)),
        "launches": {k: v for k, v in launches.items() if v},
        "expected_launches": {k: v for k, v in expected.items() if v},
        "lossy_worst_error_over_bound": worst, "lossless_resume_bit_exact": True,
        "resumed_step_loss": resumed.losses[0], "uninterrupted_run_bit_equal": rerun_equal,
    }


def phase_train(seed: int, launches_total: dict) -> None:
    """The train launcher (``repro_torch.launch.train.train``): (a)
    Qwen1.5-0.5B at full size, plain and with the compressed DP reduction
    and compressed moments on a one-rank NCCL mesh, sharded through
    ``jit_train_step`` on a (1, 1) data x model mesh with expert
    parallelism after it (:func:`_train_sharded`), and one full-size step
    at ``microbatches`` 1 and 2 from one state (loss, grad norm and first
    moment, :func:`_train_micro_check`); (b) the smoke
    config in float32 on the card against the CPU; (c) the loss falling on
    one repeated batch; (d) save and resume through the launcher."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import tree as tree_util
    from repro_torch.data import make_pipeline
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.plans import TRAIN_MICROBATCHES
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import ParallelPlan
    from repro_torch.train.step import init_train_state, make_train_step

    torch.cuda.empty_cache()
    cfg = configs.get(TRAIN_ARCH)
    if configs.SHAPES["train_4k"].seq != TRAIN_SEQ:
        raise AssertionError(f"the train_4k cell's sequence is {configs.SHAPES['train_4k'].seq}, not {TRAIN_SEQ}")
    micro = TRAIN_MICROBATCHES[TRAIN_ARCH]
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "chiprun_out"))
    try:
        # (a) full size: microbatches 1 and 2 on the first batch, then the plain run
        plan = ParallelPlan(microbatches=micro, remat="full")
        opt = AdamWConfig(lr=TRAIN_LR)
        t0 = time.perf_counter()
        state = init_train_state(seed, cfg, plan, opt, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_util.flatten(state["params"])[0])
        if n_params != TRAIN_PARAMS:
            raise AssertionError(f"train: Qwen1.5-0.5B holds {n_params} parameters, not {TRAIN_PARAMS}")
        pipe = make_pipeline(cfg, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH)
        batch0 = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(0).items()}
        micro_check = _train_micro_check(cfg, micro, opt, state, batch0)
        del batch0
        if not (micro_check["loss_diff"] <= TRAIN_MICRO_TOL and micro_check["grad_norm_rel"] <= TRAIN_MICRO_GNORM_RTOL
                and micro_check["moment_rel_l2"] <= TRAIN_MICRO_MOMENT_RTOL):
            raise AssertionError(f"train: the step at microbatches={micro} differs from microbatches=1: {micro_check} "
                                 f"(bounds {TRAIN_MICRO_TOL}, {TRAIN_MICRO_GNORM_RTOL}, {TRAIN_MICRO_MOMENT_RTOL})")
        plain, state = _train_run("plain", cfg, plan, opt, state, str(tmp / "plain"), n_params)
        batch_next = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(TRAIN_STEPS).items()}
        plain["profile"] = _train_profile(cfg, plan, opt, state, batch_next)
        plain["profiler_flops"] = _train_flops(cfg, plan, opt, state, batch_next)
        del batch_next
        micro_check["plain_run_first_loss"] = plain["losses"][0]
        del state
        torch.cuda.empty_cache()
        # (a) compressed: --mesh data=1 --compress-grads int8 --compress-opt int8:bs=256
        mesh = make_debug_mesh((1,), ("data",), device="cuda")
        try:
            cplan = ParallelPlan(mesh=mesh, microbatches=micro, remat="full", grad_policy="int8")
            copt = AdamWConfig(lr=TRAIN_LR, compress_moments=True, moment_policy="int8:bs=256")
            state = init_train_state(seed, cfg, cplan, copt, device="cuda")
            comp, state = _train_run("compressed", cfg, cplan, copt, state, str(tmp / "compressed"), n_params)
            comp["moment_bytes"] = sum(c.nbytes() for k in ("m", "v") for c in tree_util.flatten(state["opt"][k])[0])
            comp["feedback_elements"] = state["feedback"].numel()
            del state
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        # (a) sharded: the train_4k cell plan on a (1, 1) data x model mesh
        t_sharded = time.perf_counter()
        sharded = _train_sharded(cfg, seed, plain)
        sharded["seconds"] = time.perf_counter() - t_sharded
        torch.cuda.empty_cache()

        # (b) the smoke config in float32: 3 steps on the card and on the CPU
        scfg = configs.get_smoke(TRAIN_ARCH)
        splan, sopt = ParallelPlan(), AdamWConfig(lr=TRAIN_LR)

        host = init_train_state(seed, scfg, splan, sopt, device="cpu")
        card = tree_util.tree_map(lambda t: t.to("cuda", copy=True), host)
        kw = dict(steps=3, seq=64, batch=4, ckpt_every=10)
        on_cpu = lt.train(scfg, splan, sopt, ckpt_dir=str(tmp / "cpu"), device="cpu", state=host, **kw)
        on_card = lt.train(scfg, splan, sopt, ckpt_dir=str(tmp / "card"), device="cuda", state=card, **kw)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(on_card.losses, on_cpu.losses))
        if not loss_rel <= TRAIN_CPU_RTOL:
            raise AssertionError(f"train: card losses {on_card.losses}, CPU {on_cpu.losses}")
        diffs = torch.cat([(c.cpu() - h).abs().reshape(-1) for c, h in
                           zip(tree_util.flatten(on_card.state["params"])[0], tree_util.flatten(on_cpu.state["params"])[0])])
        param_bound = _adam_bound(TRAIN_LR, 3, 3)
        loose = float((diffs > 1e-5).double().mean())
        if not (float(diffs.max()) <= param_bound and loose <= 1e-3):
            raise AssertionError(f"train: card params differ from the CPU's by {float(diffs.max())} "
                                 f"(bound {param_bound}), {loose} of them beyond 1e-5")

        # (c) learning: one repeated batch
        lopt = AdamWConfig(lr=TRAIN_LR, weight_decay=0.0)
        lstate = init_train_state(seed, scfg, splan, lopt, device="cuda")
        lstep = make_train_step(scfg, splan, lopt, total_steps=60)
        lb = {k: torch.from_numpy(v).cuda() for k, v in make_pipeline(scfg, seq=64, global_batch=4).batch_at(0).items()}
        learn = []
        for _ in range(TRAIN_LEARN_STEPS):
            lstate, lm = lstep(lstate, lb)
            learn.append(float(lm["loss"]))
        if not learn[0] - learn[-1] > TRAIN_LEARN_DROP:
            raise AssertionError(f"train: the loss fell {learn[0] - learn[-1]} on one repeated batch, "
                                 f"expected more than {TRAIN_LEARN_DROP}")

        # (d) save and resume through the launcher
        resume = _train_resume(scfg, splan, sopt, tmp, launches_total, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(
        "train qwen1.5-0.5b",
        config={"layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                "d_ff": cfg.d_ff, "vocab": cfg.vocab, "padded_vocab": cfg.padded_vocab, "dtype": cfg.dtype,
                "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH, "microbatches": micro, "remat": "full",
                "steps": TRAIN_STEPS, "lr": TRAIN_LR},
        params=n_params, n_flop_params=cfg.n_flop_params(), init_s=t_init,
        plain=plain, compressed=comp, sharded=sharded,
        microbatch_check={**micro_check, "loss_tolerance": TRAIN_MICRO_TOL, "grad_norm_rtol": TRAIN_MICRO_GNORM_RTOL,
                          "moment_rtol": TRAIN_MICRO_MOMENT_RTOL},
        card_vs_cpu={"card_losses": on_card.losses, "cpu_losses": on_cpu.losses, "loss_max_rel": loss_rel,
                     "param_max_abs": float(diffs.max()), "param_bound": param_bound,
                     "param_share_over_1e-5": loose},
        learning={"losses": learn, "drop": learn[0] - learn[-1], "required_drop": TRAIN_LEARN_DROP},
        resume=resume,
    )
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi = phase_environment()
    bw = bandwidth(torch.cuda.get_device_name(0))
    phase_build()
    x2d = smooth_field(SHAPE2D, args.seed)
    x1d = particle_series(N1D, args.seed + 1)
    coder_ints = v3_coder_integers(x2d)
    cases = phase_kernels(args.seed, bw, x2d, x1d, coder_ints)
    launches = {name: 0 for name in cases}
    cases.update(phase_huffman(args.seed, bw, launches))
    t_kernels = time.perf_counter()
    for pipeline in PATHS:
        phase_main_path(pipeline, "2-D", x2d, launches)
        phase_main_path(pipeline, "1-D", x1d, launches)
    phase_bitplane_path(coder_ints, launches)
    t_v1 = time.perf_counter()
    phase_chunked("2-D", x2d, launches)
    phase_chunked("1-D", x1d, launches)
    phase_chunked("1-D", x1d, launches, speed_tier="throughput")
    t_chunked = time.perf_counter()
    for pipeline in ("sz3_lr", "sz3_interp"):
        phase_paper_pipeline(pipeline, x2d)
    phase_host_route(args.seed)
    t_paths = time.perf_counter()
    phase_pw_rel(x2d, args.seed, launches)
    t_pw_rel = time.perf_counter()
    phase_gamess(args.seed)
    t_gamess = time.perf_counter()
    phase_aps(args.seed, launches)
    t_aps = time.perf_counter()
    phase_hybrid(x2d, x1d, args.seed)
    t_hybrid = time.perf_counter()
    phase_auto(x2d, x1d, launches)
    t_auto = time.perf_counter()
    phase_quality(x2d, launches)
    t_quality = time.perf_counter()
    phase_telemetry(x2d, launches)
    t_telemetry = time.perf_counter()
    ckpt = phase_checkpoint(args.seed, launches)
    t_checkpoint = time.perf_counter()
    phase_elastic(ckpt, launches)
    t_elastic = time.perf_counter()
    phase_offload(args.seed, launches)
    t_offload = time.perf_counter()
    phase_dp_step(args.seed)
    t_dp = time.perf_counter()
    phase_kv_path(args.seed, launches)
    t_kv = time.perf_counter()
    phase_serve(args.seed, launches, cases, bw)
    t_serve = time.perf_counter()
    phase_families(args.seed, launches, cases, bw)
    t_families = time.perf_counter()
    dry = start_dryrun()
    try:
        phase_train(args.seed, launches)
        t_train = time.perf_counter()
        phase_dryrun(dry)
    finally:
        stop_dryrun(dry)
    RESULTS["phase_seconds"] = {
        "environment, build, kernels": t_kernels - t0,
        "v1/v3/v6 and bitplane main paths": t_v1 - t_kernels,
        "sz3_chunked paths": t_chunked - t_v1,
        "sz3_lr, sz3_interp, host routes": t_paths - t_chunked,
        "pw_rel": t_pw_rel - t_paths,
        "gamess": t_gamess - t_pw_rel,
        "aps": t_aps - t_gamess,
        "hybrid": t_hybrid - t_aps,
        "auto": t_auto - t_hybrid,
        "quality": t_quality - t_auto,
        "telemetry": t_telemetry - t_quality,
        "checkpoint": t_checkpoint - t_telemetry,
        "elastic": t_elastic - t_checkpoint,
        "offload": t_offload - t_elastic,
        "dp step": t_dp - t_offload,
        "kv path": t_kv - t_dp,
        "serve": t_serve - t_kv,
        "families": t_families - t_serve,
        "train (the dry run's subprocesses beside it)": t_train - t_families,
        "dryrun (its wait and checks after train)": time.perf_counter() - t_train,
    }
    summary = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": _KERNELS[name][0],
                "replaces": _KERNELS[name][1],
                "launches": launches[name],
                "max_abs_err": c["max_abs_err"],
                "ms": c["kernel_ms"],
                "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"],
                "library_ms": c["library_ms"],
                **{k: v for k, v in c.items()
                   if k.startswith(("chunk_", "row_chunk_", "serve_", "families_", "parent_", "stage_", "old_stage_"))},
            }
            for name, c in cases.items()
        ]
    }
    RESULTS["summary"] = summary
    RESULTS["seconds"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
