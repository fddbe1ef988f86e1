"""Runs benchmark cells in turns on two checkouts, traced and untraced, and
keeps every result line.

    python3 tools/portbench_turns.py TAG --parent DIR --cells a,b [--reps 3]
        [--seconds 51] [--order PU,CU,CT,PT]

``P`` is the checkout at ``--parent`` (lay this tree's ``BENCHMARK.json``
and ``portbench/`` over it first, as a traced comparison does), ``C`` this
tree; ``U`` runs ``--trace 0`` and ``T`` ``--trace 1``.  Each repetition
gives every turn one seed of its own, shared by the two checkouts.  Writes
each run's result line and standard error, and ``summary.json`` (the card's
name and power limit, then one row a run: metrics, and for traced runs the
device's busy seconds, the window and the idle seconds by host span) under
``chiprun_out/turns/TAG/``.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tag")
    p.add_argument("--parent", required=True, type=pathlib.Path)
    p.add_argument("--cells", required=True)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--order", default="PU,CU,CT,PT")
    p.add_argument("--seed0", type=int, default=4200000500)
    a = p.parse_args()
    trees = {"P": a.parent.resolve(), "C": ROOT}
    out = ROOT / "chiprun_out" / "turns" / a.tag
    out.mkdir(parents=True, exist_ok=True)
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    except OSError as e:
        card = f"no nvidia-smi: {e}"
    print("card:", card, flush=True)
    rows = []
    for cell in a.cells.split(","):
        for rep in range(a.reps):
            seed = a.seed0 + 1000 * rep + sum(map(ord, cell)) % 997
            for turn in a.order.split(","):
                tree, trace = turn[0], int(turn[1] == "T")
                t0 = time.time()
                r = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed),
                                    "--seconds", str(a.seconds), "--trace", str(trace)], cwd=trees[tree],
                                   capture_output=True, text=True)
                name = f"{cell}.{rep}.{turn}"
                (out / f"{name}.err").write_text(r.stderr[-200000:])
                line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
                (out / f"{name}.json").write_text(line)
                row = {"cell": cell, "rep": rep, "tree": tree, "trace": trace, "seed": seed, "rc": r.returncode,
                       "held_s": round(time.time() - t0, 1)}
                if r.returncode == 0 and line:
                    res = json.loads(line)
                    row["correct"] = res["correct"]
                    row["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
                    if trace:
                        row.update(busy_s=res["device"].get("busy_s"), window_s=res["device"].get("window_s"),
                                   idle_gaps=res["breakdown"]["idle_gaps"])
                rows.append(row)
                print(json.dumps(row), flush=True)
                (out / "summary.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
