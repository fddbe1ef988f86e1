"""Spread of the transform rotation's time against its first design, in
alternating pairs on one card.

    python3 tools/transform_spread.py [--pairs 10] [--out chiprun_out/transform_spread.json]

Builds the port's transform source and ``tools/baseline/transform_baseline.cu``
(the rotation's first design), then at each of ``chip_smoke.TRANSFORM_TURNS``
times, with ``chip_smoke.Timer`` (the median of 101 calls, the L2 flushed
before each), the baseline against the rotation (float32 in and out) and the
old float64 stage (cast to float32, the baseline, cast back) against the
fused one (one launch, float64 in and out), in ``--pairs`` pairs whose order
alternates.  Prints one JSON line per shape and kind: every pair, each
side's median and quartiles, and the pairs the rotation won.  Needs one
NVIDIA GPU and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def spread(times: list) -> dict:
    q = statistics.quantiles(times, n=4)
    return {"median": statistics.median(times), "q1": q[0], "q3": q[2]}


def pairs(timer, old, new, n: int) -> dict:
    """``n`` (old, new) pairs, old first in the even ones."""
    olds, news = [], []
    for i in range(n):
        if i % 2 == 0:
            olds.append(timer(old))
            news.append(timer(new))
        else:
            news.append(timer(new))
            olds.append(timer(old))
    return {
        "old_ms": olds, "new_ms": news, "old": spread(olds), "new": spread(news),
        "new_won": sum(b < a for a, b in zip(olds, news)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "transform_spread.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("transform_spread: needs an NVIDIA GPU")
    from repro_torch.kernels.transform import kernel as K

    smi = cs.smi_line()
    K.build()
    cs.transform_baseline().build()
    timer = cs.Timer(reps=cs.CHUNK_REPS, warmup=5)
    g = torch.Generator(device="cuda").manual_seed(11)
    f32, f64 = torch.float32, torch.float64
    lines = []
    for label, mode, shape in cs.TRANSFORM_TURNS:
        x64 = torch.randn(shape, generator=g, device="cuda", dtype=f64) * (100 / 3)
        x32 = x64.to(f32)
        for kind, old, new in (
            ("kernel float32", lambda: cs.baseline_rotate(x32, K._FWD, mode), lambda: K.fwd(x32, mode)),
            ("stage float64", lambda: cs.baseline_rotate(x64.to(f32), K._FWD, mode).to(f64),
             lambda: K.fwd(x64, mode, out_dtype=f64)),
        ):
            line = {"shape": list(shape), "mode": mode, "label": label, "kind": kind,
                    **pairs(timer, old, new, args.pairs)}
            lines.append(line)
            print(json.dumps(line), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "lines": lines}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
