"""Find a cell's files by the names that ``BENCHMARK.json`` gives.

* ``configs/<config>.json``: the deployment (shapes, field kinds, generator,
  reference, what was reduced and assumed);
* ``traffic/<traffic>.json``: the requests (pipeline and its options, error
  bound, how many distinct fields a run makes, why); the loop is always
  closed with one client, so any other key is refused;
* ``datagen/<generator>.py``: a module with ``make(config, items, seed, device)``;
* ``metrics/<metric>.py``: a module with ``read(run)`` and the metric's
  ``UNIT``, ``BETTER``, ``SOURCE`` (and ``LAYER`` and ``MOVES`` for a
  per-layer metric);
* ``reference/<reference>.py``: the plain reference a configuration names.

Each name is looked up in the given directories in order, so a test can put
a throwaway cell's files ahead of the benchmark's own.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import sys
from typing import Dict, List, Sequence

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
#: every key a traffic mix may have: what the harness reads, and ``why``
TRAFFIC_KEYS = frozenset({"pipeline", "options", "mode", "eb", "fields", "why"})


class Catalog:
    def __init__(self, benchmark: Dict, dirs: Sequence[pathlib.Path]):
        self.benchmark = benchmark
        self.dirs = [pathlib.Path(d) for d in dirs]
        self._modules: Dict[pathlib.Path, object] = {}

    @classmethod
    def load(cls, root: pathlib.Path = ROOT, extra_dirs: Sequence[pathlib.Path] = ()) -> "Catalog":
        with open(pathlib.Path(root) / "BENCHMARK.json") as f:
            return cls(json.load(f), [*extra_dirs, BENCH_DIR])

    # -- files by name --------------------------------------------------------
    def path(self, kind: str, name: str, suffix: str) -> pathlib.Path:
        if not _NAME.match(name):
            raise KeyError(f"{name!r} is not a name")
        for d in self.dirs:
            p = d / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise KeyError(f"no {kind}/{name}{suffix} in {[str(d) for d in self.dirs]}")

    def json(self, kind: str, name: str) -> Dict:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def traffic(self, name: str) -> Dict:
        """A traffic mix; a key the harness does not act on is refused, so
        that no setting is silently measured as another."""
        mix = self.json("traffic", name)
        unknown = sorted(set(mix) - TRAFFIC_KEYS)
        if unknown:
            raise ValueError(f"traffic {name!r}: the harness does not act on {unknown} "
                             f"(it runs a closed loop, one client; keys: {sorted(TRAFFIC_KEYS)})")
        return mix

    def module(self, kind: str, name: str):
        p = self.path(kind, name, ".py")
        if p not in self._modules:
            spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", p)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod  # dataclasses look their module up there
            spec.loader.exec_module(mod)
            self._modules[p] = mod
        return self._modules[p]

    # -- what BENCHMARK.json says ---------------------------------------------
    def cell(self, name: str) -> Dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics_for(self, cell: str, trace: bool) -> List[Dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        untraced, its per-layer metrics traced."""
        entries = self.benchmark["per_layer" if trace else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]
