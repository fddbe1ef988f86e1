"""The harness on the CPU: every file found by name, the result line's
schema, the import check, each configuration's tiny stand-in, what a
traced call keeps, and throwaway cells added by new files alone."""
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
from portbench.harness.program import PortProgram, _span_tree

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


#: the new files of a 3-D configuration: a tiny stand-in, a generator, a
#: traffic mix that names the interpolation's kind, a reference that holds
#: the program to that kind as well as to the bound, and a metric that reads
#: a counter
CUBE_FILES = {
    "configs/cube.json": json.dumps({
        "name": "cube", "shape": [512, 512, 512], "tiny_shape": [12, 16, 20], "generator": "waves_3d",
        "reference": "sz3_kind", "precision": "float32", "kinds": [{"freq": 0.3}, {"freq": 0.7}], "reduced": []}),
    "traffic/interp.json": json.dumps({
        "pipeline": "sz3_interp", "options": {"kind": "cubic"}, "mode": "rel", "eb": 1e-3, "fields": 4,
        "why": "multi-level cubic interpolation on 3-D fields"}),
    "datagen/waves_3d.py": (
        "import torch\n"
        "def make(config, items, seed, device):\n"
        "    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in config['shape']]\n"
        "    i, j, k = torch.meshgrid(*axes, indexing='ij')\n"
        "    out = []\n"
        "    for fid, kind in items:\n"
        "        f = config['kinds'][kind]['freq'] * (1 + (seed + fid) % 7 / 7)\n"
        "        out.append((torch.sin(f * i) + torch.cos(f * j) * torch.sin(0.5 * f * k) + fid).contiguous())\n"
        "    return out\n"),
    "reference/sz3_kind.py": (
        "import dataclasses\n"
        "from portbench.reference import container, sz3_bound\n"
        "LIMITS = {**sz3_bound.LIMITS, 'kind_mismatch': 0}\n"
        "seal = sz3_bound.seal\n"
        "@dataclasses.dataclass\n"
        "class Verdict(sz3_bound.FieldVerdict):\n"
        "    kind_mismatch: int = 0\n"
        "def judge_field(x, decoded, blob, ratio, traffic, sealed=None):\n"
        "    v = sz3_bound.judge_field(x, decoded, blob, ratio, traffic, sealed)\n"
        "    want = traffic['options']['kind']\n"
        "    kinds = [p['header'].get('pred_meta', {}).get('kind') for p in container.leaves(blob)]\n"
        "    return Verdict(**dataclasses.asdict(v), kind_mismatch=sum(k != want for k in kinds))\n"
        "def summarize(verdicts):\n"
        "    return {**sz3_bound.summarize(verdicts), 'kind_mismatch': sum(v.kind_mismatch for v in verdicts)}\n"),
    "metrics/counted_fields.compress.py": (
        "from portbench.harness import readers\n"
        "UNIT, BETTER, SOURCE = 'fields', 'higher', 'program_counter'\n"
        "LAYER, MOVES = 'entry points', 'compress_MBps'\n"
        "def read(run):\n    return readers.counter_total(run, 'compress', 'cube.fields')\n"),
}


class _Counting(PortProgram):
    """The port with one counter of its own, which a sound compress of the
    port does not emit: one count a field compressed."""

    def compress(self, x):
        self.core.telemetry.count("cube.fields")
        return super().compress(x)


def _linear(traffic, device):
    """The port asked for the linear interpolation whatever the mix says."""
    return _Counting({**traffic, "options": {**traffic["options"], "kind": "linear"}}, device)


def test_a_3d_configuration_with_its_own_reference_needs_only_new_files(tmp_path, benchmark, tiny_writer):
    """A 3-D configuration, its tiny stand-in, its own reference with a limit
    read from the traffic's options, a traffic mix and a counter-reading
    metric go in as new files: the tiny stand-in, ``run_cell`` (traced and
    untraced) and the judge take them, and a program that ignores the
    mix's kind is caught by the new limit alone."""
    new = tmp_path / "new"
    for rel, text in CUBE_FILES.items():
        (new / rel).parent.mkdir(parents=True, exist_ok=True)
        (new / rel).write_text(text)
    bench = json.loads(json.dumps(benchmark))
    bench["configs"].append({"name": "cube", "source": "a throwaway 3-D configuration", "file": "new/configs/cube.json",
                             "reduced": [], "why": "3-D fields through sz3_interp"})
    bench["workloads"].append({"name": "cube.interp", "config": "cube", "traffic": "interp", "chips": 1,
                               "why": "a throwaway 3-D cell"})
    bench["per_layer"].append({"name": "counted_fields.compress", "unit": "fields", "better": "higher",
                               "source": "program_counter", "layer": "entry points", "moves": "compress_MBps",
                               "workloads": ["cube.interp"]})
    small = tiny_writer(tmp_path / "tiny", bench, fields=4, dirs=[new, BENCH_DIR])
    assert json.loads((tmp_path / "tiny" / "configs" / "tiny-cube.json").read_text())["shape"] == [12, 16, 20]
    catalog = Catalog(small, [tmp_path / "tiny", new, BENCH_DIR])
    for trace in (False, True):
        result = session.run_cell(catalog, "cube.interp", 2**31 + 21, 0.0, trace, device="cpu",
                                  program_factory=_Counting)
        _check_result(result, small, "cube.interp", trace)
        assert result["correct"] is True and result["attempted"] == 2
        assert result["checks"]["kind_mismatch"] == {"value": 0, "limit": 0}
        assert result["checks"]["err_over_bound"]["value"] <= 1.0
    assert result["metrics"]["counted_fields.compress"]["value"] == result["attempted"]
    wrong = session.run_cell(catalog, "cube.interp", 2**31 + 21, 0.0, True, device="cpu", program_factory=_linear)
    assert wrong["correct"] is False and wrong["failed"] == wrong["attempted"] == 2
    assert wrong["checks"]["kind_mismatch"]["value"] == 2
    assert wrong["checks"]["err_over_bound"]["value"] <= 1.0


def _config_paths():
    return sorted((BENCH_DIR / "configs").glob("*.json"))


@pytest.mark.parametrize("path", _config_paths(), ids=lambda p: p.stem)
def test_every_configuration_names_a_tiny_stand_in_of_its_shape(path):
    config = json.loads(path.read_text())
    tiny, shape = config["tiny_shape"], config["shape"]
    assert len(tiny) == len(shape) and math.prod(tiny) <= 65536
    assert all(0 < t <= s for t, s in zip(tiny, shape))


@pytest.mark.parametrize("tiny_shape, match", [(None, "must be a list"), ([96], "has 1 axes"), ([96, 0], "positive")])
def test_a_configuration_without_a_sound_tiny_shape_is_named(tmp_path, benchmark, tiny_writer, tiny_shape, match):
    new = tmp_path / "new" / "configs"
    new.mkdir(parents=True)
    config = json.loads((BENCH_DIR / "configs" / "cesm-atm.json").read_text())
    config.pop("tiny_shape")
    if tiny_shape is not None:
        config["tiny_shape"] = tiny_shape
    (new / "cesm-atm.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match=match) as err:
        tiny_writer(tmp_path / "tiny", benchmark, dirs=[new.parent, BENCH_DIR])
    assert str(new / "cesm-atm.json") in str(err.value) and "'tiny_shape'" in str(err.value)


def test_a_traced_call_keeps_span_attributes_and_counters():
    """``attrs`` holds every int, float or str attribute but ``bytes``,
    which stays where it is; the recording keeps the trace's counters."""
    import repro_torch.core as core

    program = PortProgram({"pipeline": "sz3_lorenzo", "options": {}, "mode": "rel", "eb": 1e-3}, "cpu")
    with program.traced() as rec:
        with core.telemetry.span("outer", bytes=64, order=2, kind="cubic", scale=0.5, skip=[1, 2], flag=None):
            with core.telemetry.span("inner"):
                core.telemetry.count("passes", 3)
                core.telemetry.count("passes")
    assert rec.counters == {"passes": 4}
    (outer,) = rec.spans
    assert outer["bytes"] == 64 and outer["attrs"] == {"order": 2, "kind": "cubic", "scale": 0.5}
    assert outer["children"][0]["attrs"] == {} and outer["children"][0]["bytes"] == 0
    with core.telemetry.trace("direct") as tr:
        with core.telemetry.span("s", bytes=8, n=1):
            pass
    assert _span_tree(tr.root)[0]["attrs"] == {"n": 1}


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


@pytest.mark.parametrize("kept", ["both", "start", "end"])
def test_the_trace_is_tied_to_the_host_clock_by_either_marker(kept):
    """The markers were launched at host seconds 11 and 13 and ran at device
    seconds 1 and 3: an operation at device second 1.5 is host second 11.5
    whichever marker the trace kept; a trace that kept neither is refused."""
    marks = {"start": ("spin_kernel", 1_000_000_000, 1_000_000_500),
             "end": ("spin_kernel", 3_000_000_000, 3_000_000_500)}
    ops = [("b", 2_500_000_000, 2_600_000_000), ("a", 1_500_000_000, 1_750_000_000)]
    raw = ops + [marks[k] for k in marks if kept in (k, "both")]
    got = devtrace.align(raw, [11.0, 13.0])
    assert [n for n, _, _ in got] == ["a", "b"]
    assert [s for _, s, _ in got] == pytest.approx([11.5, 12.5])
    assert got[1][2] == pytest.approx(12.6)
    with pytest.raises(RuntimeError, match="no clock marker"):
        devtrace.align(ops, [11.0, 13.0])


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
