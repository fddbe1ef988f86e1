"""The harness on the CPU: every file found by name, the result line's
schema, the import check, and a throwaway cell added by new files alone."""
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from portbench.harness import devtrace, guard, session
from portbench.harness.catalog import BENCH_DIR, ROOT, Catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _cells(benchmark):
    return [w["name"] for w in benchmark["workloads"]]


def test_every_file_a_cell_names_is_found(benchmark):
    catalog = Catalog.load()
    for cell in benchmark["workloads"]:
        config = catalog.json("configs", cell["config"])
        traffic = catalog.json("traffic", cell["traffic"])
        assert callable(catalog.module("datagen", config["generator"]).make)
        assert callable(catalog.module("reference", config["reference"]).judge_field)
        assert traffic["pipeline"] and traffic["mode"] in ("rel", "abs") and int(traffic["fields"]) >= len(config["kinds"])
    for entry in benchmark["end_to_end"] + benchmark["per_layer"]:
        mod = catalog.module("metrics", entry["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (entry["unit"], entry["better"], entry["source"]), entry["name"]
    for entry in benchmark["per_layer"]:
        mod = catalog.module("metrics", entry["name"])
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"]), entry["name"]


def test_benchmark_json_keeps_the_contract(benchmark):
    assert set(benchmark) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert benchmark["paths"] == ["portbench"] and benchmark["command"] == ["python3", "portbench/run.py"]
    assert 1 <= benchmark["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in benchmark[k]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in benchmark["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in benchmark["end_to_end"] + benchmark["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    configs = {c["name"] for c in benchmark["configs"]}
    cells = _cells(benchmark)
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in benchmark["workloads"]}) == len(cells)
    for w in benchmark["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    assert configs == {w["config"] for w in benchmark["workloads"]}
    for m in benchmark["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= set(cells)
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]].get("workloads", cells)), m["name"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in benchmark["per_layer"])
    for c in benchmark["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    assert len(json.dumps(benchmark)) < 64 * 1024


def _check_result(result, bench, cell, trace):
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert isinstance(result["correct"], bool) and result["attempted"] > 0
    want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"] if cell in m.get("workloads", [cell])
            and (result["device"]["platform"] == "gpu" or m["source"] != "device_trace")}
    assert set(result["metrics"]) == want
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"]) and m["value"] >= 0, name
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema_on_every_cell(tiny, trace):
    catalog, bench = tiny
    for cell in _cells(bench):
        result = session.run_cell(catalog, cell, 2**31 + 99, 0.2, bool(trace), device="cpu")
        _check_result(result, bench, cell, trace)
        assert result["correct"] is True and result["failed"] == 0


def test_a_window_holds_whole_groups(tiny):
    catalog, bench = tiny
    result = session.run_cell(catalog, "cesm-atm.auto", 7, 0.0, False, device="cpu")
    assert result["attempted"] == 3


def test_a_throwaway_cell_needs_only_new_files(tmp_path, benchmark):
    """A new configuration, traffic mix, generator and per-layer metric, in
    files of their own: the harness runs the cell without an edit."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "datagen").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "ramp.json").write_text(json.dumps({
        "name": "ramp", "shape": [64, 128], "generator": "ramp_2d", "reference": "sz3_bound",
        "precision": "float32", "kinds": [{"slope": 1.0}, {"slope": -2.0}], "reduced": []}))
    (tmp_path / "traffic" / "lorenzo-abs.json").write_text(json.dumps({
        "pipeline": "sz3_lorenzo", "options": {}, "mode": "abs", "eb": 0.01, "fields": 4}))
    (tmp_path / "datagen" / "ramp_2d.py").write_text(
        "import torch\n"
        "def make(config, items, seed, device):\n"
        "    r, c = config['shape']\n"
        "    base = torch.arange(r * c, dtype=torch.float32, device=device).reshape(r, c) / (r * c)\n"
        "    return [(config['kinds'][k]['slope'] * base + fid).contiguous() for fid, k in items]\n")
    (tmp_path / "metrics" / "calls.window.py").write_text(
        "UNIT, BETTER, SOURCE = 'calls', 'higher', 'host_clock'\n"
        "LAYER, MOVES = 'entry points', 'compress_MBps'\n"
        "def read(run):\n    return float(len(run.done))\n")
    bench = json.loads(json.dumps(benchmark))
    bench["workloads"].append({"name": "ramp.lorenzo-abs", "config": "ramp", "traffic": "lorenzo-abs", "chips": 1,
                               "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "calls.window", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "entry points", "moves": "compress_MBps", "workloads": ["ramp.lorenzo-abs"]})
    catalog = Catalog(bench, [tmp_path, BENCH_DIR])
    for trace in (False, True):
        result = session.run_cell(catalog, "ramp.lorenzo-abs", 1, 0.1, trace, device="cpu")
        _check_result(result, bench, "ramp.lorenzo-abs", trace)
        assert result["correct"] is True
    assert result["metrics"]["calls.window"]["value"] == result["attempted"]


def test_a_traffic_key_the_harness_does_not_act_on_is_refused(tmp_path, benchmark):
    """Every run is a closed loop with one client: a mix that asks for
    anything else (an open loop, more clients) is refused, not measured as
    that loop."""
    (tmp_path / "traffic").mkdir()
    for key, value in (("loop", "open"), ("clients", 4)):
        mix = json.loads((BENCH_DIR / "traffic" / f"{benchmark['workloads'][0]['traffic']}.json").read_text())
        mix[key] = value
        (tmp_path / "traffic" / f"with-{key}.json").write_text(json.dumps(mix))
        bench = json.loads(json.dumps(benchmark))
        bench["workloads"].append({**bench["workloads"][0], "name": f"x.with-{key}", "traffic": f"with-{key}"})
        with pytest.raises(ValueError, match=key):
            session.run_cell(Catalog(bench, [tmp_path, BENCH_DIR]), f"x.with-{key}", 1, 0.0, False, device="cpu")
    for w in benchmark["workloads"]:
        Catalog.load().traffic(w["traffic"])


def test_harness_code_names_no_cell_config_or_metric(benchmark):
    names = {w["name"] for w in benchmark["workloads"]} | {c["name"] for c in benchmark["configs"]}
    names |= {m["name"] for m in benchmark["end_to_end"] + benchmark["per_layer"]}
    names |= {w["traffic"] for w in benchmark["workloads"]}
    for path in [BENCH_DIR / "run.py", *(BENCH_DIR / "harness").glob("*.py")]:
        text = path.read_text()
        for name in names:
            assert not re.search(rf"[\"']{re.escape(name)}[\"']", text), f"{path.name} names {name!r}"


def test_import_check_compares_whole_top_level_names():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.core", "reproduce", "jaxtyping", "torch"]) == []
    assert guard.forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "flax.linen", "numpy"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole (tiny, CPU) run in a fresh process, then the import check."""
    code = (
        "import json, pathlib, sys, tempfile\n"
        "sys.path[:0] = ['src', '.', 'portbench/tests']\n"
        "from conftest import write_tiny\n"
        "from portbench.harness import guard, session\n"
        "from portbench.harness.catalog import BENCH_DIR, Catalog\n"
        "tmp = pathlib.Path(tempfile.mkdtemp())\n"
        "bench = write_tiny(tmp, json.load(open('BENCHMARK.json')))\n"
        "for cell in bench['workloads']:\n"
        "    session.run_cell(Catalog(bench, [tmp, BENCH_DIR]), cell['name'], 1, 0.0, False, device='cpu')\n"
        "print(guard.forbidden_modules(), 'repro_torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_busy_and_idle_arithmetic():
    ops = [("a", 1.0, 2.0), ("b", 1.5, 2.5), ("a", 4.0, 5.0)]
    assert devtrace.busy_seconds(ops, 0.0, 6.0) == pytest.approx(2.5)
    assert devtrace.busy_seconds(ops, 1.8, 4.5) == pytest.approx(1.2)
    assert devtrace.idle_intervals(ops, 0.0, 6.0) == [(0.0, 1.0), (2.5, 4.0), (5.0, 6.0)]
    assert devtrace.top_ops(ops) == [["a", 2.0], ["b", 1.0]]
    spans = [{"name": "compress", "t0": 0.5, "seconds": 3.0, "children": [
        {"name": "huffman", "t0": 2.6, "seconds": 0.9, "children": []}]}]
    idle = dict(map(tuple, devtrace.idle_by_host_span(ops, spans, 0.0, 6.0)))
    assert idle == pytest.approx({"compress/huffman": 0.9, "compress": 0.5 + 0.1, "harness": 0.5 + 0.5 + 1.0})


def _copy_bench(dst: pathlib.Path, with_program: bool) -> None:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, dst / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if with_program:
        shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__", "build"))


@pytest.mark.parametrize("with_program", [False, True])
def test_run_exits_without_a_result_where_it_cannot_measure(tmp_path, with_program):
    """Without the program, or (here) without a card, a run prints no
    result and exits non-zero."""
    import torch

    if with_program and torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    _copy_bench(tmp_path, with_program)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cesm-atm.auto", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == "", (out.returncode, out.stdout, out.stderr)


@pytest.mark.cuda
def test_a_tiny_cell_runs_on_the_card(cuda_device, tiny):
    catalog, bench = tiny
    for cell in _cells(bench):
        for trace in (False, True):
            result = session.run_cell(catalog, cell, 3, 0.2, trace, device=cuda_device)
            _check_result(result, bench, cell, trace)
            assert result["correct"] is True
