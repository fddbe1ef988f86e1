"""The int8 decode step with the fused KV append against the sequence it
replaced, in turns, on one card.

    PYTHONPATH=src python tools/int8_append_ab.py [--archs A B ...] [--out PATH]

For each architecture at its full config (qwen3-moe-30b-a3b cut to 8
layers, as ``chip_smoke.py`` cuts it) the weights are drawn once on the
card, then the serve launcher runs batch 4 and 16 greedy tokens in
``ROUNDS`` rounds of six turns: bf16, int8 through the old append, int8
through the fused append, fused, old, bf16.  The old append is the decode step's int8 path
before ``kv_quantize_append``: two ``_quantize_token`` calls (the
standalone ``absmax`` and ``quantize_with_scale`` kernels with their host
glue) and four ``index_copy_`` into the ring slot
(``chip_smoke.append_old_sequence``), patched into ``models.lm`` for its
runs.  Each run reports the exact median and
largest of its 16 step times (host clock, each step ending in a sync, as
the launcher's ``sz3_decode_step_seconds`` observes them) and its kvquant
launches; the two int8 variants must give the same tokens.  Per
architecture: each variant's median and quartiles of its runs' medians,
the int8-minus-bf16 gap of each int8 variant, and how many of the
adjacent (old, fused) pairs the fused append won.  One JSON line per run
and per architecture on stdout, all of it in ``--out``, the card's name
and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("granite-3-8b", "deepseek-moe-16b", "qwen3-moe-30b-a3b", "mamba2-2.7b", "zamba2-7b", "whisper-small")
DEPTH = {"qwen3-moe-30b-a3b": 8}
TURNS = ("bf16", "old", "fused", "fused", "old", "bf16")
#: rounds of TURNS: ten (old, fused) pairs an architecture
ROUNDS = 5
BATCH, TOKENS = 4, 16


def run(cfg, arch: str, params, variant: str) -> dict:
    from chip_smoke import append_old_sequence
    from repro_torch.core import telemetry
    from repro_torch.kernels.kvquant import kernel as KK
    from repro_torch.launch import serve as ls
    from repro_torch.models import lm
    from repro_torch.parallel import ParallelPlan

    plan = ParallelPlan(kv_cache_dtype="bf16" if variant == "bf16" else "int8")
    steps = []
    observe, fused = telemetry.metric_observe, lm.kv_quantize_append

    def recording(name, value, *a, **k):
        if name == "sz3_decode_step_seconds":
            steps.append(value)
        return observe(name, value, *a, **k)

    telemetry.metric_observe = recording
    if variant == "old":
        lm.kv_quantize_append = append_old_sequence
    try:
        torch.cuda.synchronize()
        KK.reset_launches()
        res = ls.serve(cfg, plan, BATCH, TOKENS, arch=arch, params=params)
        torch.cuda.synchronize()
    finally:
        telemetry.metric_observe, lm.kv_quantize_append = observe, fused
    return {"variant": variant, "step_p50_ms": statistics.median(steps) * 1e3, "step_max_ms": max(steps) * 1e3,
            "steps_ms": [s * 1e3 for s in steps], "tok_per_s": res.tok_per_s,
            "launches": {k: v for k, v in KK.LAUNCHES.items() if v}, "sequences": res.sequences}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "int8_append_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_append_ab: needs a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch import configs, models
    from repro_torch.models import lm
    from repro_torch.parallel import ParallelPlan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = {"nvidia_smi": smi, "batch": BATCH, "tokens": TOKENS, "turns": list(TURNS), "archs": {}}
    for arch in args.archs:
        cfg = configs.get(arch)
        if arch in DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
        layers = cfg.n_layers if cfg.family == "encdec" else lm._n_attn_layers(cfg)
        t0 = time.perf_counter()
        params = models.init_params(args.seed, cfg, ParallelPlan(), device="cuda")
        runs = []
        for variant in TURNS * ROUNDS:
            r = run(cfg, arch, params, variant)
            want = {"bf16": {}, "old": ({"absmax": 2 * layers * TOKENS, "quantize_with_scale": 2 * layers * TOKENS}
                                        if layers else {}),
                    "fused": {"quantize_append": layers * TOKENS} if layers else {}}[variant]
            if r["launches"] != want:
                raise AssertionError(f"{arch} {variant}: launches {r['launches']}, expected {want}")
            runs.append(r)
            print(json.dumps({"arch": arch, **{k: v for k, v in r.items() if k != "sequences"}}), flush=True)
        old = [r for r in runs if r["variant"] == "old"]
        fused = [r for r in runs if r["variant"] == "fused"]
        if not all(np.array_equal(r["sequences"], old[0]["sequences"]) for r in old + fused):
            raise AssertionError(f"{arch}: the old and the fused int8 append gave different tokens")
        p50 = {v: [r["step_p50_ms"] for r in runs if r["variant"] == v] for v in ("bf16", "old", "fused")}
        med = {v: statistics.median(x) for v, x in p50.items()}
        # adjacent turns (old, fused) and (fused, old): positions 1-2 and 3-4 of each round
        pairs = [(runs[i + 1]["step_p50_ms"], runs[i + 2]["step_p50_ms"]) for i in range(0, len(runs), 6)]
        pairs += [(runs[i + 4]["step_p50_ms"], runs[i + 3]["step_p50_ms"]) for i in range(0, len(runs), 6)]
        summary = {"layers_appending": layers, "rounds": ROUNDS,
                   "median_of_run_p50_ms": med,
                   "quartiles_of_run_p50_ms": {v: statistics.quantiles(x, n=4) for v, x in p50.items()},
                   "int8_minus_bf16_ms": {v: med[v] - med["bf16"] for v in ("old", "fused")},
                   "fused_wins_of_pairs": [sum(f < o for o, f in pairs), len(pairs)],
                   "seconds": time.perf_counter() - t0}
        print(json.dumps({"arch": arch, **summary}), flush=True)
        report["archs"][arch] = {**summary, "runs": [{k: v for k, v in r.items() if k != "sequences"} for r in runs]}
        del params
        torch.cuda.empty_cache()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
