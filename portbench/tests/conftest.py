"""Fixtures of the benchmark's tests: a throwaway catalog of tiny cells, and
the ``cuda`` marker for tests that need a card (they skip themselves where
``torch.cuda.is_available()`` is false, decided inside a fixture)."""
from __future__ import annotations

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a tiny stand-in for each real configuration: same kinds, small shape
TINY_SHAPES = {"cesm-atm": [96, 512], "hacc": [50000]}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips itself where torch.cuda.is_available() is false")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return "cuda"


@pytest.fixture
def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def write_tiny(tmp: pathlib.Path, benchmark: dict, fields: int = 6) -> dict:
    """Tiny copies of every configuration and traffic mix under ``tmp``, and
    a BENCHMARK dict whose cells name them (same cell names)."""
    from portbench.harness.catalog import BENCH_DIR

    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "traffic").mkdir(exist_ok=True)
    bench = json.loads(json.dumps(benchmark))
    for cell in bench["workloads"]:
        config = json.loads((BENCH_DIR / "configs" / f"{cell['config']}.json").read_text())
        config["shape"] = TINY_SHAPES[cell["config"]]
        (tmp / "configs" / f"tiny-{cell['config']}.json").write_text(json.dumps(config))
        traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
        traffic["fields"] = fields
        (tmp / "traffic" / f"tiny-{cell['traffic']}.json").write_text(json.dumps(traffic))
        cell["config"], cell["traffic"] = f"tiny-{cell['config']}", f"tiny-{cell['traffic']}"
    return bench


@pytest.fixture
def tiny(tmp_path, benchmark):
    """(catalog, benchmark dict) of the tiny cells."""
    from portbench.harness.catalog import BENCH_DIR, Catalog

    bench = write_tiny(tmp_path, benchmark)
    return Catalog(bench, [tmp_path, BENCH_DIR]), bench
