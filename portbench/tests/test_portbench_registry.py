"""BENCHMARK.json against the contract the benchmark is checked by, and
everything it names found by name from files alone."""

import json
import os
import re

import pytest

from portbench.harness import registry

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cells():
    return [w["name"] for w in bench()["workloads"]]


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + cells() + [c["name"] for c in b["configs"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and "\n" not in m["layer"]
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("name", cells())
def test_cell_found_by_name(name):
    """Its configuration, traffic, limits, generator and metric readers are
    files named after it; it reports setup_s, another end-to-end metric and
    a per-layer metric, and has a limit for each number its generator compares."""
    cell = registry.find_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    gen = registry.generator(cell.traffic["generator"])
    assert hasattr(gen.Generator, "check")
    for m in cell.per_layer:
        assert callable(registry.metric_reader(m["name"]).read)
    assert set(cell.limits) == ({"loss_err", "grad_err", "update_err"} if cell.traffic["generator"] == "train"
                                else {"start_err", "z_err", "x_err"})


def test_cell_added_from_a_temporary_directory(tiny):
    """New configurations, traffic mixes, cells and limits added as files
    and entries of a copy of the benchmark run without an edited file."""
    for name in tiny.cells:
        cell = tiny.cell(name)
        assert cell.bench_dir == tiny.bench and cell.per_layer
    out = tiny.run("tiny.uncond")
    assert out["correct"], out["checks"]


def test_metric_added_as_a_file(tiny, tmp_path):
    """A per-layer metric is a reader file and an entry: found by name."""
    with open(os.path.join(tiny.bench, "metrics", "steps.sample.py"), "w") as fh:
        fh.write("def read(run):\n    return float(run.steps)\n")
    reader = registry.metric_reader("steps.sample", tiny.bench)
    assert reader.read(type("R", (), {"steps": 3})()) == 3.0
