"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:

1. environment: the card, torch and CUDA versions, which host packages
   import (they decide the container's lossless backend and checksum);
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
3. kernels: each kernel against its plain torch version on the card, bit
   for bit, at the main path's shapes and ragged ones, with its time, the
   plain version's time, a PyTorch library call's time and its bound;
4. main path 2-D: ``sz3_lorenzo`` on a smooth 1800x3600 float32 field (the
   shape of an SDRBench CESM-ATM 2-D field), REL 1e-4, compress and
   decompress on the card;
5. main path 1-D: the same on a 2^24+3-element series (HACC-like particle
   data, cut from HACC's 280,953,867 elements so the host Huffman stage fits
   the run);
6. host route: a small 3-D field compressed on the card and on the CPU gives
   the same bytes.

Each main path must launch its Lorenzo kernels (the launch counters are
zeroed just before the path and read just after), keep the error bound,
write the same bytes as the plain versions on the CPU (``device="cpu",
route="force"``), and decode on the CPU's host route within the bound.

The last three lines are the ``{"kernels": [...]}`` summary, the card's name
and power limit as ``nvidia-smi`` prints them, and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before them.
Without a CUDA device, or without the repository's ``src/`` beside it, the
script fails.  Full results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
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
_SOURCE = "src/repro_torch/kernels/lorenzo/csrc/lorenzo.cu"
_REPLACES = {
    "encode_1d": "src/repro/kernels/lorenzo/kernel.py:107",
    "encode_2d": "src/repro/kernels/lorenzo/kernel.py:131",
    "decode_1d": "src/repro/kernels/lorenzo/kernel.py:155",
    "decode_2d": "src/repro/kernels/lorenzo/kernel.py:171",
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


def phase_build() -> None:
    from repro_torch.kernels.lorenzo import kernel as K

    t0 = time.perf_counter()
    path = K.build()
    K.load()
    emit("build", seconds=time.perf_counter() - t0, library=str(path.relative_to(ROOT)))


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
    bytes_ms = _BYTES_PER_ELEM[name] * n / bw * 1e3
    ops_ms = _OPS_PER_ELEM[name] * n / _ALU_RATE * 1e3
    return {
        "name": name,
        "shape": list(shape),
        "eb": eb,
        "bit_identical": equal,
        "max_abs_err": err,
        "kernel_ms": timer(lambda: kfn(*args)),
        "plain_ms": timer(lambda: rfn(*args)),
        "library_ms": timer(lib) if lib is not None else None,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def phase_kernels(seed: int, bw: float) -> dict:
    from repro_torch.kernels.lorenzo import ref as R

    timer = Timer()
    g = torch.Generator(device="cuda").manual_seed(seed)
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


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_main_path(label: str, x: torch.Tensor, kernels, launches_total) -> None:
    import repro_torch.core as tc
    from repro_torch.kernels.lorenzo import kernel as K

    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.REL, eb=1e-4)
    comp = tc.sz3_lorenzo()
    comp.compress(x[:64].contiguous() if x.ndim == 2 else x[:8192], conf)  # warm-up
    K.reset_launches()
    res, t_c = _timed(lambda: comp.compress(x, conf))
    out, t_d = _timed(lambda: tc.decompress(res.blob))
    launches = dict(K.LAUNCHES)
    for name in kernels:
        if launches[name] == 0:
            raise AssertionError(f"{label}: kernel {name} was not launched on the main path")
        launches_total[name] += launches[name]
    header, _ = tc.parse_header(res.blob)
    abs_eb = header["abs_eb"]
    if out.shape != x.shape or out.dtype != x.dtype or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: decoded {tuple(out.shape)} {out.dtype}, not finite or not {tuple(x.shape)}")
    err = float((out.double() - x.double()).abs().max())
    if err > abs_eb:
        raise AssertionError(f"{label}: max error {err} breaks the bound {abs_eb}")
    x_cpu = x.cpu()
    plain = tc.sz3_lorenzo(device="cpu", route="force").compress(x_cpu, conf).blob
    if plain != res.blob:
        raise AssertionError(f"{label}: the card's blob differs from the plain versions' blob")
    host = tc.decompress(res.blob, device="cpu")
    host_err = float((host.double() - x_cpu.double()).abs().max())
    if host_err > abs_eb:
        raise AssertionError(f"{label}: host-route decode error {host_err} breaks the bound {abs_eb}")
    mb = x.numel() * x.element_size() / 1e6
    emit(
        f"main path {label}",
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
        host_route_max_abs_err=host_err,
        nfail=header["pred_meta"]["nfail"],
        kernel_route=bool(header["pred_meta"].get("device")),
        lossless=header["spec"]["lossless"],
        same_bytes_as_plain=True,
        launches=launches,
        stages=stage_breakdown(x, conf),
    )


def stage_breakdown(x: torch.Tensor, conf) -> dict:
    """Seconds per pipeline stage in one more compress + decompress: the
    stage methods are wrapped for this run only (synchronising around the
    device stages)."""
    import repro_torch.core as tc
    from repro_torch.core import encoders, lossless, predictors

    spent: dict = {}
    patches = [
        (predictors.LorenzoPredictor, "compress", "predict (device)"),
        (predictors.LorenzoPredictor, "decompress", "inverse (device)"),
        (encoders.HuffmanEncoder, "encode", "huffman encode (host)"),
        (encoders.HuffmanEncoder, "decode", "huffman decode (host)"),
    ]
    # without zstandard, Zstd writes zlib and the blob names "gzip", which
    # decodes through Gzip
    patches += [
        (lossless.Zstd, "compress", "lossless compress (host)"),
        (lossless.Zstd, "decompress_bounded", "lossless decompress (host)"),
        (lossless.Gzip, "decompress_bounded", "lossless decompress (host)"),
    ]
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

    for cls, attr, label in patches:
        saved.append((cls, attr, getattr(cls, attr)))
        setattr(cls, attr, wrap(getattr(cls, attr), label))
    try:
        blob, t_c = _timed(lambda: tc.sz3_lorenzo().compress(x, conf).blob)
        _, t_d = _timed(lambda: tc.decompress(blob))
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
    spent["compress total"] = t_c
    spent["decompress total"] = t_d
    return spent


def phase_host_route(seed: int) -> None:
    import repro_torch.core as tc

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.cumsum(torch.randn((16, 40, 60), generator=g, device="cuda"), dim=2)
    conf = tc.CompressionConfig(mode=tc.ErrorBoundMode.ABS, eb=1e-3)
    card = tc.sz3_lorenzo().compress(x, conf).blob
    cpu = tc.sz3_lorenzo(device="cpu").compress(x.cpu(), conf).blob
    if card != cpu:
        raise AssertionError("host route: the card's blob differs from the CPU's")
    out = tc.decompress(card)
    err = float((out.double() - x.double()).abs().max())
    if err > 1e-3:
        raise AssertionError(f"host route: max error {err} breaks the bound 1e-3")
    emit("host route 3-D", shape=list(x.shape), same_bytes_as_cpu=True, max_abs_err=err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi = phase_environment()
    bw = bandwidth(torch.cuda.get_device_name(0))
    phase_build()
    cases = phase_kernels(args.seed, bw)
    launches = {name: 0 for name in cases}
    phase_main_path("2-D", smooth_field(SHAPE2D, args.seed), ("encode_2d", "decode_2d"), launches)
    phase_main_path("1-D", particle_series(N1D, args.seed + 1), ("encode_1d", "decode_1d"), launches)
    phase_host_route(args.seed)
    summary = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": _SOURCE,
                "replaces": _REPLACES[name],
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
