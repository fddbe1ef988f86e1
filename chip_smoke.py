"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

1. environment: the card, torch and CUDA versions, which host packages
   import (they decide the container's lossless backend and checksum);
2. build: compile the three CUDA sources under
   ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` each, all at once);
3. kernels: each kernel against its plain version on the card, bit for bit
   (NaN equal to NaN), at the main paths' shapes and ragged ones, with its
   time, the plain version's time, a PyTorch library call's time and its
   bound: the four Lorenzo kernels, the float32 transform (``fwd``/``inv``,
   1d and 2d modes), the float64 transform axis product (against numpy's
   product on the host) and the fast tier's ``block_stats`` (bs 128, 256);
4. main paths, each on a smooth 1800x3600 float32 field (the shape of an
   SDRBench CESM-ATM 2-D field) and on a 2^24+3-element series (HACC-like
   particle data, cut from HACC's 280,953,867 elements so the host coding
   stages fit the run), REL 1e-4, compress and decompress on the card:
   ``sz3_lorenzo``, ``sz3_transform`` and ``sz3_fast``;
5. host route: small 3-D fields compressed on the card and on the CPU give
   the same bytes (``sz3_lorenzo``, ``sz3_transform``), and so do
   ``sz3_transform`` fields with an axis that pads to exactly 4.

Each main path must launch its kernels (the launch counters are zeroed just
before the path and read just after), keep the error bound, write the same
bytes as the plain versions on the CPU (``device="cpu", route="force"``),
and decode on the CPU within the bound.

The last three lines are the ``{"kernels": [...]}`` summary, the card's name
and power limit as ``nvidia-smi`` prints them, and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before them.
Without a CUDA device, or without the repository's ``src/`` beside it, the
script fails.  Full results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: device memory rate by card name (NVIDIA data sheets), bytes/s
_BANDWIDTH = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12))
#: float32 rate outside the tensor cores, H100 SXM data sheet; the kernels'
#: integer and float32 ALU work is counted against it
_ALU_RATE = 67e12
#: float64 rate outside the tensor cores, H100 SXM data sheet
_F64_RATE = 34e12
_LORENZO_SRC = "src/repro_torch/kernels/lorenzo/csrc/lorenzo.cu"
_TRANSFORM_SRC = "src/repro_torch/kernels/transform/csrc/transform.cu"
_FASTMODE_SRC = "src/repro_torch/kernels/fastmode/csrc/fastmode.cu"
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
}
#: bytes each kernel must move per element (inputs read once, outputs
#: written once) and the ALU operations it does per element
_BYTES_PER_ELEM = {"encode_1d": 12, "encode_2d": 12, "decode_1d": 8, "decode_2d": 8}
_OPS_PER_ELEM = {"encode_1d": 6, "encode_2d": 9, "decode_1d": 3, "decode_2d": 4}
N1D = (1 << 24) + 3
SHAPE2D = (1800, 3600)

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
    emit(
        "environment",
        nvidia_smi=line,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        python=sys.version.split()[0],
        host_packages=host,
    )
    return line


def _kernel_modules():
    from repro_torch.kernels.fastmode import kernel as FK
    from repro_torch.kernels.lorenzo import kernel as LK
    from repro_torch.kernels.transform import kernel as TK

    return {"lorenzo": LK, "transform": TK, "fastmode": FK}


def phase_build() -> None:
    """Build the three CUDA sources at once: one nvcc process each."""
    mods = _kernel_modules()
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
    """Launch counts under the summary's kernel names."""
    mods = _kernel_modules()
    out = dict(mods["lorenzo"].LAUNCHES)
    out.update({f"transform_{k}": v for k, v in mods["transform"].LAUNCHES.items()})
    out.update(mods["fastmode"].LAUNCHES)
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit identity, with any NaN equal to any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
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


def lorenzo_kernels(timer, g, bw: float) -> dict:
    from repro_torch.kernels.lorenzo import ref as R

    cases = {}
    shapes = {"2d": [SHAPE2D, (1801, 3599)], "1d": [(1, N1D), (300, 1000)]}
    eb = 1e-3
    for mode, mode_shapes in shapes.items():
        for shape in mode_shapes:
            x = torch.cumsum(torch.randn(shape, generator=g, device="cuda"), dim=1)
            _, d = getattr(R, f"encode_{mode}")(x, eb, 32768)
            for name, arg in ((f"encode_{mode}", x), (f"decode_{mode}", d)):
                case = _kernel_case(timer, name, shape, arg, eb, bw)
                emit(f"kernel {name} {shape[0]}x{shape[1]}", **case)
                if not case["bit_identical"]:
                    raise AssertionError(f"{name} at {shape} differs from its plain version")
                cases.setdefault(name, case)  # first shape is the main path's
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
    return cases


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
    # NaN and inf inside blocks: the kernel and its plain version agree
    xb = torch.randn((4096, 256), device="cuda")
    xb[7, 3], xb[100, 5], xb[200, :] = float("nan"), float("inf"), 3.0
    got, want = K.block_stats(xb), R.block_stats(xb)
    if not all(same_bits(a, b) for a, b in zip(got, want)):
        raise AssertionError("block_stats with nan/inf differs from its plain version")
    return cases


def phase_kernels(seed: int, bw: float, x2d: torch.Tensor, x1d: torch.Tensor) -> dict:
    timer = Timer()
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = lorenzo_kernels(timer, g, bw)
    cases.update(transform_kernels(timer, bw, x2d, torch.cat([x1d, x1d[-1:]])))  # 2^24+4
    cases.update(block_stats_kernels(timer, bw, x2d, x1d))
    return cases


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


def phase_main_path(pipeline: str, label: str, x: torch.Tensor, launches_total) -> None:
    import repro_torch.core as tc

    factory = tc.PIPELINES[pipeline]
    expected = PATHS[pipeline][x.ndim]
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    comp = factory()
    comp.compress(x[:64].contiguous() if x.ndim == 2 else x[: 1 << 17], conf)  # warm-up
    reset_all_launches()
    res, t_c = _timed(lambda: comp.compress(x, conf))
    out, t_d = _timed(lambda: tc.decompress(res.blob))
    launches = all_launches()
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
        stages=stage_breakdown(pipeline, x, conf),
    )


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
    if pipeline == "sz3_transform":
        return host_lossless + [
            (tops, "fwd_pipeline", "forward transform (device)"),
            (transform, "_quantize_coeffs", "quantize (device)"),
            (transform, "_inv_host", "float64 inverse (device)"),
            (tops, "inv_pipeline", "float32 inverse (device)"),
            (transform, "_encode_bands", "bitplane encode (host)"),
            (transform, "_decode_bands", "bitplane decode (host)"),
            (transform, "to_host", "copies to the host"),
        ]
    return [
        (fops, "block_stats", "block stats (device)"),
        (fastmode, "to_host", "copies to the host"),
        (fastmode.FastModeCompressor, "_encode_blocks", "encode blocks (device + host packing)"),
        (fastmode, "_pack_planes", "pack planes (host)"),
        (fastmode, "_unpack_planes", "unpack planes (host)"),
    ]


def stage_breakdown(pipeline: str, x: torch.Tensor, conf) -> dict:
    """Seconds per stage in one more compress and one more decompress: the
    stage functions are wrapped for this run only (synchronising around
    each), and the two directions are reported apart."""
    import repro_torch.core as tc

    spent: dict = {}
    saved = []

    def wrap(fn, label):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for owner, attr, label in _stage_patches(pipeline):
        fn = owner.__dict__[attr]
        saved.append((owner, attr, fn))
        wrapped = wrap(fn.__func__ if isinstance(fn, staticmethod) else fn, label)
        setattr(owner, attr, staticmethod(wrapped) if isinstance(fn, staticmethod) else wrapped)
    try:
        blob, t_c = _timed(lambda: tc.PIPELINES[pipeline]().compress(x, conf).blob)
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
    cases = phase_kernels(args.seed, bw, x2d, x1d)
    launches = {name: 0 for name in cases}
    for pipeline in PATHS:
        phase_main_path(pipeline, "2-D", x2d, launches)
        phase_main_path(pipeline, "1-D", x1d, launches)
    phase_host_route(args.seed)
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
