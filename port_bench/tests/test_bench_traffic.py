"""The traffic generator and the registry: seeds, length ranges, every
cell's files found by name, the names and units BENCHMARK.json may use,
and a cell added from files alone."""

import json
import re

import numpy as np
import pytest

from port_bench import harness
from port_bench import traffic as TR
from port_bench.tests.tiny import REPO, tiny_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
MIXES = sorted({w["traffic"] for w in BENCH["workloads"]})
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _mix(name: str, pool: int = 8) -> dict:
    """A mix file at a pool small enough for the CPU, in two batches."""
    mix = json.loads((REPO / "port_bench/traffic" / f"{name}.json").read_text())
    return dict(mix, pool=pool, batch=pool // 2)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic_other_seed_other(name):
    mix = _mix(name)
    big = 2**31 + 987654321
    a, b, c = (TR.make_pool(mix, s, "cpu") for s in (big, big, big + 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c) if len(x) == len(y))
    assert TR.batches(mix, big) == TR.batches(mix, big)
    assert TR.batches(mix, big) != TR.batches(mix, big + 1) or TR.batches(mix, big) != TR.batches(mix, big + 2)
    # every seed gets the same set of lengths, in another grouping
    assert sorted(map(len, a)) == sorted(map(len, c))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_the_mix_range(name):
    mix = json.loads((REPO / "port_bench/traffic" / f"{name}.json").read_text())
    secs = TR.pool_seconds(mix)
    spec = mix["lengths"]
    assert len(secs) == mix["pool"] and mix["pool"] % mix["batch"] == 0
    assert min(secs) >= spec["min_s"] and max(secs) <= spec["max_s"]
    assert sorted(secs)[len(secs) // 2] == pytest.approx(spec["median_s"], rel=0.05)
    parts = TR.batches(mix, 5)
    assert sorted(c for b in parts for c in b) == list(range(mix["pool"]))
    assert all(len(b) == mix["batch"] for b in parts)
    # every batch of every seed spans the range: its j-th longest clip is
    # one of the j-th run of as many lengths as there are batches
    k = len(parts)
    for seed in (5, 2**31 + 5):
        for part in TR.batches(mix, seed):
            assert [c // k for c in sorted(part)] == list(range(mix["batch"]))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    reg = harness.Registry(REPO)
    cell = reg.cell(workload)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["kind"] == "offline"
    assert reg.driver(cell.traffic["kind"]).Driver
    assert (REPO / "port_bench/traffic" / f"{cell.config['assumed']['share_mix']}.json").exists()
    for number, lim in cell.limits.items():
        assert 0 < lim["lower"] < lim["limit"] < lim["upper"], number
        assert lim.get("witness", 0) < lim["limit"], number
    for trace in (False, True):
        for m in reg.metrics(workload, trace):
            assert callable(reg.reader(m["name"]))
    e2e = [m["name"] for m in reg.metrics(workload, False)]
    assert "setup_s" in e2e and len(e2e) >= 2 and reg.metrics(workload, True)


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and "\n" not in m["layer"]
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\t" not in entry["why"] and "\n" not in entry["why"]
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({e["name"] for e in group}) == len(group)


def test_a_cell_from_files_alone_registers(tmp_path):
    root = tiny_root(tmp_path, limits={"token_gap": {"limit": 1.0}})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.throwaway", "config": "tiny", "traffic": "throwaway", "chips": 1,
                               "why": "a cell added without editing a file"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "port_bench/traffic/tiny_mix.json").read_text())
    (root / "port_bench/traffic/throwaway.json").write_text(json.dumps(dict(mix, batch=1)))
    reg = harness.Registry(root)
    cell = reg.cell("tiny.throwaway")
    assert cell.traffic["batch"] == 1 and cell.config["name"] == "tiny" and cell.limits == {}
    assert reg.cell("tiny.cell").limits["token_gap"]["limit"] == 1.0
    assert [m["name"] for m in reg.metrics("tiny.throwaway", False)] == ["rtfx", "setup_s"]
