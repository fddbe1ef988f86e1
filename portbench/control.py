"""The control of a cell's correctness check: the plain reference put in the
program's place, computed one precision below the configuration's.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--device cuda]

For each seed it makes the cell's fields as a run does, snaps each field to
the grid of ``2 * abs_eb`` in the configuration's precision and in the one
below it (bfloat16 for float32), and prints, as one JSON line per seed, the
``err_over_bound`` the judge would read over the run's fields in each: the
first has to pass its limit, the second has to fail it.  The benchmark's
own runs never run this.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: the precision one step below each configured one
BELOW = {"float64": "float32", "float32": "bfloat16"}


def readings(catalog, cell_name: str, seed: int, device: str) -> dict:
    import torch

    from portbench.harness import fields

    cell = catalog.cell(cell_name)
    config = catalog.json("configs", cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    gen = catalog.module("datagen", config["generator"])
    ref = catalog.module("reference", config["reference"])
    stated = config["precision"]
    out = {"seed": seed, "fields": 0, stated: 0.0, BELOW[stated]: 0.0, f"{BELOW[stated]}_least": None}
    items = fields.plan(int(traffic["fields"]), len(config["kinds"]), seed)
    for x in gen.make(config, items, seed, device):
        abs_eb = ref.abs_bound(x, traffic["mode"], float(traffic["eb"]))
        sound = ref.max_error(x, ref.plain_codec(x, abs_eb, getattr(torch, stated))) / abs_eb
        low = ref.max_error(x, ref.plain_codec(x, abs_eb, getattr(torch, BELOW[stated]))) / abs_eb
        out["fields"] += 1
        out[stated] = max(out[stated], sound)
        out[BELOW[stated]] = max(out[BELOW[stated]], low)
        least = out[f"{BELOW[stated]}_least"]
        out[f"{BELOW[stated]}_least"] = low if least is None else min(least, low)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from portbench.harness.catalog import Catalog

    catalog = Catalog.load(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, **readings(catalog, args.workload, seed, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
