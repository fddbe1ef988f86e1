"""The generators: deterministic in the seed, at the configured shapes, and
one group of every kind in each window."""
import json

import pytest
import torch

from portbench.harness import fields
from portbench.harness.catalog import BENCH_DIR, Catalog


def _configs():
    return sorted(p.stem for p in (BENCH_DIR / "configs").glob("*.json"))


@pytest.mark.parametrize("name", _configs())
def test_generator_is_deterministic_in_the_seed(tiny, name):
    catalog, _ = tiny
    config = catalog.json("configs", f"tiny-{name}")
    gen = catalog.module("datagen", config["generator"])
    items = fields.plan(len(config["kinds"]) * 2, len(config["kinds"]), 2**31 + 77)
    a = gen.make(config, items, 2**31 + 77, "cpu")
    b = gen.make(config, items, 2**31 + 77, "cpu")
    c = gen.make(config, items, 2**31 + 78, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    for x in a:
        assert list(x.shape) == config["shape"] and x.dtype == torch.float32
        assert x.is_contiguous() and bool(torch.isfinite(x).all())
        assert float(x.max()) > float(x.min())


@pytest.mark.parametrize("name", _configs())
def test_a_field_does_not_depend_on_the_others_made(tiny, name):
    catalog, _ = tiny
    config = catalog.json("configs", f"tiny-{name}")
    gen = catalog.module("datagen", config["generator"])
    items = fields.plan(len(config["kinds"]) * 3, len(config["kinds"]), 5)
    whole = gen.make(config, items, 5, "cpu")
    last = gen.make(config, items[-1:], 5, "cpu")
    assert torch.equal(whole[-1], last[0])


def test_every_group_holds_each_kind_once_in_the_seeds_order():
    a, b = fields.plan(79, 3, 10), fields.plan(79, 3, 11)
    assert len(a) == 78 and [i for i, _ in a] == list(range(78))
    for items in (a, b):
        for g in range(0, 78, 3):
            assert sorted(k for _, k in items[g : g + 3]) == [0, 1, 2]
    assert [k for _, k in a] != [k for _, k in b]
    assert fields.plan(79, 3, 10) == a
    assert all(fid >= fields.WARMUP_BASE for fid, _ in fields.warmup_plan(3))


def test_field_seeds_take_large_seeds_and_stay_distinct():
    seeds = {fields.field_seed(s, i) for s in (0, 1, 2**31 + 5, 2**40) for i in range(50)}
    assert len(seeds) == 200 and all(0 <= s < 2**63 for s in seeds)


def test_kinds_map_to_their_ranges(tiny):
    catalog, _ = tiny
    config = catalog.json("configs", "tiny-cesm-atm")
    gen = catalog.module("datagen", config["generator"])
    xs = gen.make(config, [(0, 0), (1, 1), (2, 2)], 3, "cpu")
    smooth, nonneg, bounded = xs
    assert 150 < float(smooth.mean()) < 350
    assert float(nonneg.min()) == 0.0 and float((nonneg == 0).float().mean()) > 0.3
    assert float(bounded.min()) >= 0.0 and float(bounded.max()) <= 1.0
    config = catalog.json("configs", "tiny-hacc")
    gen = catalog.module("datagen", config["generator"])
    pos, vel = gen.make(config, [(0, 0), (1, 1)], 3, "cpu")
    assert float(pos.min()) >= 0.0 and float(pos.max()) <= 256.0
    assert 200 < float(vel.std()) < 400


@pytest.mark.cuda
@pytest.mark.parametrize("name", _configs())
def test_generator_at_the_configured_shape_on_the_card(cuda_device, name):
    catalog = Catalog({"workloads": []}, [BENCH_DIR])
    config = catalog.json("configs", name)
    gen = catalog.module("datagen", config["generator"])
    items = fields.plan(len(config["kinds"]), len(config["kinds"]), 9)
    a, b = gen.make(config, items, 9, cuda_device), gen.make(config, items, 9, cuda_device)
    for x, y in zip(a, b):
        assert list(x.shape) == config["shape"] and x.device.type == "cuda" and torch.equal(x, y)


def test_configs_state_their_reductions(benchmark):
    for entry in benchmark["configs"]:
        config = json.loads((BENCH_DIR.parent / entry["file"]).read_text())
        assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
        assert config["source"] == entry["source"]


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 5])
def test_the_walk_is_the_running_sum_of_its_steps(n):
    """The positions' walk, summed row by row in a fixed order, is the plain
    running sum to float64 rounding."""
    walk = Catalog({"workloads": []}, [BENCH_DIR]).module("datagen", "particles_1d")._walk
    steps = torch.randn(n, generator=torch.Generator().manual_seed(n), dtype=torch.float64)
    plain = torch.cumsum(steps, 0)
    got = walk(steps)
    assert got.shape == plain.shape and got.dtype == torch.float64
    assert float((got - plain).abs().max()) <= n * 2.2e-16 * (float(plain.abs().max()) + 1.0)
    assert torch.equal(walk(steps), got)
