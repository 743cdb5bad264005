"""Multi-node launch of genie2_tpu_torch's training on the CPU:
tools/torch_multinode_dryrun.py at N=2, two torchrun nodes of 2 gloo ranks
(c10d rendezvous on localhost) against one node of 4, running
cli/train.py for 3 steps. The losses are equal within 1e-6 relative; a
second two-node run with meshModel 2 (one model group a node) within 1e-5.
Every launch runs under the tool's deadline, which kills every agent and
rank and fails with their output; the test's own timeout is above it.
The counterpart of tests/test_multihost.py (genie2_tpu's two processes x 4
devices against one of 8)."""

import json
import os
import subprocess
import sys

import torch

from genie2_tpu_torch.utils import model_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_nodes_match_one_node():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_multinode_dryrun.py"), "--nproc_per_node", "2",
         "--mesh_model", "1", "2", "--deadline", "240"],
        capture_output=True, text=True, timeout=900, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-20000:] + proc.stderr[-20000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ok"] is True and result["world_size"] == 4 and len(result["baseline_losses"]) == 3
    runs = {r["mesh_model"]: r for r in result["runs"]}
    assert runs[1]["max_rel_err"] <= 1e-6 and runs[2]["max_rel_err"] <= 1e-5
    for run in runs.values():
        assert run["local_ranks_per_node"] and run["cards_node_local"] and run["model_groups_within_nodes"]
        assert sorted(r["rank"] for r in run["ranks"]) == [0, 1, 2, 3]
    assert [r["model_group"] for r in sorted(runs[2]["ranks"], key=lambda r: r["rank"])] == [[0, 1], [0, 1],
                                                                                              [2, 3], [2, 3]]


def test_bare_cuda_is_the_node_local_card(monkeypatch):
    """Under torchrun a bare "cuda" is cuda:LOCAL_RANK, the rank within its
    node, not the global RANK."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert model_io.resolve_device("cuda") == torch.device("cuda", 1)
    assert model_io.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert model_io.resolve_device("cpu") == torch.device("cpu")
