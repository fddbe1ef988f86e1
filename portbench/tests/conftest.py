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


def tiny_shape(path: pathlib.Path, config: dict) -> list:
    """The ``tiny_shape`` a configuration file names for its CPU stand-in;
    an error that names the file and the key where it is missing or has
    another number of axes than ``shape``."""
    shape = config.get("tiny_shape")
    if not isinstance(shape, list) or not all(isinstance(n, int) and n > 0 for n in shape):
        raise ValueError(f"{path}: 'tiny_shape' must be a list of positive axis lengths, found {shape!r}")
    if len(shape) != len(config["shape"]):
        raise ValueError(f"{path}: 'tiny_shape' {shape} has {len(shape)} axes, 'shape' {config['shape']} has "
                         f"{len(config['shape'])}")
    return shape


def write_tiny(tmp: pathlib.Path, benchmark: dict, fields: int = 6, dirs=None) -> dict:
    """Tiny copies of every configuration and traffic mix under ``tmp``, each
    configuration cut to its own ``tiny_shape``, and a BENCHMARK dict whose
    cells name them (same cell names).  Files are looked up in ``dirs`` in
    order (the benchmark's own by default), as the catalog looks them up."""
    from portbench.harness.catalog import BENCH_DIR, Catalog

    catalog = Catalog(benchmark, dirs or [BENCH_DIR])
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "traffic").mkdir(exist_ok=True)
    bench = json.loads(json.dumps(benchmark))
    for cell in bench["workloads"]:
        path = catalog.path("configs", cell["config"], ".json")
        config = json.loads(path.read_text())
        config["shape"] = tiny_shape(path, config)
        (tmp / "configs" / f"tiny-{cell['config']}.json").write_text(json.dumps(config))
        traffic = json.loads(catalog.path("traffic", cell["traffic"], ".json").read_text())
        traffic["fields"] = fields
        (tmp / "traffic" / f"tiny-{cell['traffic']}.json").write_text(json.dumps(traffic))
        cell["config"], cell["traffic"] = f"tiny-{cell['config']}", f"tiny-{cell['traffic']}"
    return bench


@pytest.fixture
def tiny_writer():
    """:func:`write_tiny`, for a test that cuts cells of its own."""
    return write_tiny


@pytest.fixture
def tiny(tmp_path, benchmark):
    """(catalog, benchmark dict) of the tiny cells."""
    from portbench.harness.catalog import BENCH_DIR, Catalog

    bench = write_tiny(tmp_path, benchmark)
    return Catalog(bench, [tmp_path, BENCH_DIR]), bench
