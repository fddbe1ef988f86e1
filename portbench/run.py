"""The benchmark of the port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints progress and the numbers compared on
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``.  Exits non-zero, with no
result, where CUDA or the cell's cards are missing, where the program cannot
be imported, and where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: every build and kernel cache of the run, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions", "TRITON_CACHE_DIR": "build/portbench/triton"}
#: one rank's load on one host thread: the chunk contest's host estimates
#: spread over torch's CPU threads at 2.3-2.9 CPU seconds a second without
#: finishing sooner, and the spinning threads make the host's pace unsteady
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    for key in THREADS:
        os.environ[key] = "1"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    torch.set_num_threads(1)

    from portbench.harness import guard, session
    from portbench.harness.catalog import Catalog

    catalog = Catalog.load(ROOT)
    chips = int(catalog.cell(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing from this checkout: {e}", file=sys.stderr)
        return 4
    result = session.run_cell(catalog, args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: JAX and the JAX package may not run here", file=sys.stderr)
        return 5
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
