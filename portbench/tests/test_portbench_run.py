"""Whole runs of the tiny cells on the CPU: `correct`, the result line's
keys, the trace's keys, the modules loaded, and run.py's refusals."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, TINY_TRAFFIC

from portbench.harness import runner

TINY_CELLS = ["tiny.uncond", "tiny-triatt.uncond", "tiny.scaffold", "tiny.train"]


@pytest.mark.parametrize("name", TINY_CELLS)
def test_tiny_cell_is_correct(tiny, name):
    out = tiny.run(name)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["attempted"] >= 1


@pytest.mark.parametrize("name", TINY_CELLS)
def test_control_reads_the_reference(tiny, name):
    """The control (the reference in the program's place) runs the cell;
    on the CPU, where TF32 does not exist, it agrees with the reference
    exactly."""
    out = tiny.run(name, program="control")
    assert all(c["value"] == 0.0 for c in out["checks"].values()), out["checks"]


def test_result_line_keys(tiny):
    out = tiny.run("tiny.uncond")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {"samples_per_min", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


def test_trace_line_keys(tiny):
    out = tiny.run("tiny.train", trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "detail", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"]) and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "mfu.train" in out["metrics"] and "train_residues_per_s" not in out["metrics"]


def test_banned_names_compared_whole():
    assert runner.banned_modules(["genie2_tpu_torch", "genie2_tpu_torch.ops", "numpy"]) == []
    assert runner.banned_modules(["genie2_tpu.nn", "jaxlib", "flax.linen", "orbax.checkpoint"]) == \
        ["flax", "genie2_tpu", "jaxlib", "orbax"]


def test_no_banned_module_after_a_run(tiny):
    """A whole run (set-up, window, trace, reference) in a fresh process
    loads none of jax, jaxlib, flax, optax, orbax and genie2_tpu."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {tests!r}]\n"
        "from conftest import Tiny\n"
        "t = Tiny({tmp!r}); t.run('tiny.scaffold'); t.run('tiny.train', trace=True)\n"
        "from portbench.harness.runner import banned_modules\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'genie2_tpu'}}), banned_modules())\n"
    ).format(root=ROOT, tests=os.path.dirname(__file__), tmp=os.path.join(tiny.root, "fresh"))
    os.makedirs(os.path.join(tiny.root, "fresh"), exist_ok=True)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_reference_imports_nothing_of_the_program():
    """portbench/reference/ imports the standard library, numpy and torch
    alone: nothing of genie2_tpu_torch, genie2_tpu or JAX."""
    allowed = {"__future__", "contextlib", "math", "typing", "numpy", "torch"}
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if name.endswith(".py"):
            with open(os.path.join(BENCH, "reference", name)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    assert {a.name.split(".")[0] for a in node.names} <= allowed, (name, ast.dump(node))
                elif isinstance(node, ast.ImportFrom):
                    assert node.level == 0 and node.module.split(".")[0] in allowed, (name, ast.dump(node))


def test_run_refuses_without_a_card():
    """No CUDA device: exit 2 and no result line (decided inside the test)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "genie2-base.uncond-l256-b4", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_run_refuses_outside_a_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has no
    program to measure: a non-zero exit and no result line."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "genie2-base.uncond-l256-b4", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_traffic_files_are_data():
    """Every traffic mix is a data file that names a general generator."""
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        assert name.endswith(".json")
        with open(os.path.join(BENCH, "traffic", name)) as fh:
            assert os.path.isfile(os.path.join(BENCH, "generators", json.load(fh)["generator"] + ".py"))
    assert set(TINY_TRAFFIC) == {"uncond", "scaffold", "train"}
