"""Everything the harness runs is found by name, from files alone.

A cell of BENCHMARK.json names a configuration and a traffic mix; the
configuration's entry names its file, the traffic mix is
`<bench>/traffic/<name>.json`, the limits of the cell's comparison are
`<bench>/limits/<cell>.json`, a per-layer metric's reader is
`<bench>/metrics/<metric>.py` and a traffic's generator is
`<bench>/generators/<generator>.py`. A later cell, configuration, mix or metric is
added as new files and entries, never by editing one of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    config_name: str
    config: Dict  # the configuration file's JSON
    traffic_name: str
    traffic: Dict  # the traffic file's JSON
    chips: int
    limits: Dict[str, float]
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the per-layer metrics this cell reports
    root: str = ROOT
    bench_dir: str = BENCH_DIR


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def reports(metric: Dict, cell: str, e2e_names) -> bool:
    """Whether a cell reports a per-layer metric: it is listed under the
    metric's `workloads`, or the metric has none and moves an end-to-end
    metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def find_cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files read."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, w["config"], config, w["traffic"], traffic, int(w["chips"]), limits["limits"], e2e,
                per_layer, root, bench_dir)


def load_file_module(path: str, name: str):
    """A module from a file whose name need not be an identifier (metric
    names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(metric: str, bench_dir: str = BENCH_DIR):
    return load_file_module(os.path.join(bench_dir, "metrics", f"{metric}.py"), f"portbench_metric_{metric}")


def generator(name: str, bench_dir: str = BENCH_DIR):
    return load_file_module(os.path.join(bench_dir, "generators", f"{name}.py"), f"portbench_generator_{name}")


def subseed(seed: int, tag: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    import numpy as np

    return int(np.random.SeedSequence([int(seed) % 2**64, int(tag)]).generate_state(1, np.uint64)[0]) & (2**63 - 1)
