"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark in
a temporary directory with a tiny configuration, traffic mixes and cells of
its own, so that a run completes on the CPU in seconds.

Run them from the root of the repository:  python -m pytest portbench/tests -q
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Every width cut to a few channels: a run of 1000 steps' schedule at 20.
TINY = {"singleFeatureDimension": 32, "pairFeatureDimension": 16, "positionalEmbeddingDimension": 16,
        "chainEmbeddingDimension": 8, "timestepEmbeddingDimension": 16, "relativePositionK": 4,
        "numPairTransformLayers": 1, "triangularMultiplicativeHiddenDimension": 8, "numStructureLayers": 2,
        "ipaHiddenDimension": 4, "ipaNumHeads": 2, "ipaNumQkPoints": 2, "ipaNumVPoints": 2,
        "triangularAttentionNumHeads": 2, "triangularAttentionHiddenDimension": 4, "numTimesteps": 20,
        "maximumNumResidues": 40}

TINY_TRAFFIC = {
    "uncond": {"generator": "ancestral", "batch": 2, "scale": 0.6, "problem": {"kind": "unconditional", "length": 16},
               "warmup_steps": 2, "trace_steps": 3, "checked_steps": 3},
    "scaffold": {"generator": "ancestral", "batch": 3, "scale": 0.4,
                 "problem": {"kind": "motif", "segments": [["A", 10, 13, "A"], ["B", 40, 42, "B"]],
                             "scaffold": [3, 8], "total": [20, 30]},
                 "warmup_steps": 2, "trace_steps": 3, "checked_steps": 3},
    "train": {"generator": "train", "batch": 2, "corpus": 6, "corpus_seed": 7, "min_length": 10, "checked_steps": 3,
              "warmup_steps": 1, "trace_steps": 2},
}

SEED = 2**31 + 12345  # more than 32 signed bits hold


def tiny_config(tri_att: bool = False):
    with open(os.path.join(BENCH, "configs", "genie2-base.json")) as fh:
        cfg = json.load(fh)
    cfg["configuration"].update(TINY, includeTriangularAttention=tri_att)
    return cfg


def add_tiny_cells(root: str, bench: str):
    """Add to the benchmark at root/bench, as new files and entries only: two
    tiny configurations, a tiny mix of each traffic kind and a cell of each."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    for name, tri in (("tiny", False), ("tiny-triatt", True)):
        with open(os.path.join(bench, "configs", f"{name}.json"), "w") as fh:
            json.dump(tiny_config(tri), fh)
        b["configs"].append({"name": name, "source": "https://arxiv.org/abs/2405.15489",
                             "file": f"{os.path.relpath(bench, root)}/configs/{name}.json", "reduced": [],
                             "why": "tiny"})
    cells = {}
    for kind, traffic in TINY_TRAFFIC.items():
        with open(os.path.join(bench, "traffic", f"tiny-{kind}.json"), "w") as fh:
            json.dump(traffic, fh)
        for config in (("tiny", "tiny-triatt") if kind == "uncond" else ("tiny",)):
            name = f"{config}.{kind}"
            cells[name] = kind
            b["workloads"].append({"name": name, "config": config, "traffic": f"tiny-{kind}", "chips": 1,
                                   "why": "tiny"})
            limits = {"train": {"loss_err": 1e-4, "grad_err": 1e-4, "update_err": 1e-4}}.get(
                kind, {"start_err": 0.0, "z_err": 1e-4, "x_err": 1e-4})
            with open(os.path.join(bench, "limits", f"{name}.json"), "w") as fh:
                json.dump({"limits": limits}, fh)
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            train = m["name"].endswith(".train") or m["name"] == "train_residues_per_s"
            m["workloads"] += [c for c, k in cells.items() if (k == "train") == train
                               and (m["name"] != "tri_att_roofline.sample" or "triatt" in c)]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(b, fh)
    return cells


class Tiny:
    """A copy of the benchmark with the tiny cells added, and runs of them on the CPU."""

    def __init__(self, root: str):
        self.root = root
        self.bench = os.path.join(root, "portbench")
        shutil.copytree(BENCH, self.bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
        self.cells = add_tiny_cells(root, self.bench)

    def cell(self, name):
        from portbench.harness import registry

        return registry.find_cell(name, self.root, self.bench)

    def run(self, name, seconds=0.3, trace=False, program="port"):
        import time

        import torch

        from portbench.harness import runner

        return runner.run(self.cell(name), SEED, seconds, trace, torch.device("cpu"), time.perf_counter(),
                          program=program)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return Tiny(str(tmp_path_factory.mktemp("bench")))
