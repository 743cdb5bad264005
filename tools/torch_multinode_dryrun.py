"""Multi-node training dry run of genie2_tpu_torch on the CPU.

The port trains across nodes with torchrun: one agent a node, one process
a rank, joined by torch.distributed (NCCL on cards, gloo here). This
script proves that launch on one machine with the CPU and gloo. It runs
the port's `cli/train.py` at a tiny configuration for 3 steps

  (a) under ONE torchrun node of 2N ranks (`--standalone`), and
  (b) under TWO torchrun nodes of N ranks each on localhost (`--nnodes 2
      --node_rank 0|1 --rdzv_backend c10d --rdzv_endpoint 127.0.0.1:PORT`),
      once for each `--mesh_model` given (the model axis innermost, so a
      model group of M <= N ranks stays inside one node),

and compares the per-step losses of each run's `metrics.jsonl`: within
1e-6 relative where the model axis is 1 (the same grid as (a)), within
1e-5 where it splits the weights. On the way it checks that every rank
would take the card LOCAL_RANK of its own node (`utils/model_io.py:
resolve_device`), that each model group lies inside one node, and that the
run wrote one `version_0`. Rank 0 writes the split, the data cache, the
checkpoints and `resume_state`, and the other ranks read them after a
barrier: the nodes must share a filesystem, as they do here.

  python tools/torch_multinode_dryrun.py                      # 2 x 4 against 8
  python tools/torch_multinode_dryrun.py --nproc_per_node 2 --mesh_model 1 2

Each launch has a deadline (`--deadline` seconds); past it every agent and
every rank is killed and the script fails with their output. The last line
of its output is one JSON object with "ok"; the exit code is 0 when it is
true.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
CONFIG = """name dryrun
rootDirectory {root}
dataDirectory {data}
minimumNumResidues 10
maximumNumResidues 24
numTimesteps 8
singleFeatureDimension 16
pairFeatureDimension 8
positionalEmbeddingDimension 8
chainEmbeddingDimension 4
timestepEmbeddingDimension 8
templateDistanceNumBins 5
numPairTransformLayers 1
triangularMultiplicativeHiddenDimension 4
numStructureLayers 1
ipaHiddenDimension 4
ipaNumHeads 2
ipaNumQkPoints 2
ipaNumVPoints 2
seed 100
numEpoches 1
batchSize {batch}
logEverySteps 1
checkpointEveryEpoches 1
validationSplit 0
meshModel {mesh_model}
"""


def worker(outdir: str, argv):
    """One rank: record where the launcher put it, train, record the mesh."""
    rank = int(os.environ["RANK"])
    with open(os.path.join(outdir, f"pid.{rank}"), "w") as f:
        f.write(str(os.getpid()))
    sys.path.insert(0, REPO)
    from unittest import mock

    import torch
    import torch.distributed as dist

    from genie2_tpu_torch.cli import train
    from genie2_tpu_torch.utils.model_io import resolve_device

    # The card a bare "cuda" would give this rank on a node with cards.
    with mock.patch.object(torch.cuda, "is_available", return_value=True):
        card = str(resolve_device("cuda"))
    trainer = train.main(argv)
    mesh = trainer.mesh
    record = {
        "rank": rank, "local_rank": int(os.environ["LOCAL_RANK"]), "group_rank": int(os.environ["GROUP_RANK"]),
        "world_size": int(os.environ["WORLD_SIZE"]), "node": int(os.environ["DRYRUN_NODE"]), "card": card,
        "mesh": [mesh.n_data, mesh.n_seq, mesh.n_model],
        "model_group": dist.get_process_group_ranks(mesh.model_group) if mesh.model_group is not None else [rank],
        "steps": trainer.state.step,
    }
    with open(os.path.join(outdir, f"rank.{rank}.json"), "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_corpus(path: str, n: int):
    """`n` single-chain CA traces of 12-23 residues, seeded random walks."""
    sys.path.insert(0, REPO)
    import numpy as np

    from genie2_tpu_torch.features import create_empty_features, save_features_to_pdb

    rng = np.random.default_rng(0)
    os.makedirs(path)
    for i in range(n):
        length = int(rng.integers(12, 24))
        f = create_empty_features([length])
        steps = rng.normal(size=(length, 3))
        f["atom_positions"] = np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=-1, keepdims=True), axis=0)
        f["aatype"] = np.eye(20)[rng.integers(0, 20, length)].astype(int)
        save_features_to_pdb(f, os.path.join(path, f"walk_{i}.pdb"))


def _kill(pid: int):
    try:
        os.killpg(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def launch(label: str, nodes, argv, outdir: str, deadline: float):
    """Start one torchrun agent per entry of `nodes` ((node index, torchrun
    arguments)), each running this script's worker with `argv`, and wait
    for all of them up to `deadline` seconds. Past it, or where one fails,
    kill every agent and every rank (each rank is its own session) and
    raise with their output. Returns the seconds taken."""
    os.makedirs(outdir)
    procs = []
    start = time.monotonic()
    for node, args in nodes:
        log = open(os.path.join(outdir, f"node{node}.log"), "w")
        cmd = [sys.executable, "-m", "torch.distributed.run", *args, os.path.abspath(__file__), "--worker", outdir,
               *argv]
        env = dict(os.environ, DRYRUN_NODE=str(node), OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO,
                                       start_new_session=True), log))
    late = False
    for proc, _ in procs:
        try:
            proc.wait(timeout=max(0.0, start + deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            late = True
            break
    failed = late or any(proc.returncode != 0 for proc, _ in procs)
    if failed:
        for proc, _ in procs:
            _kill(proc.pid)
        for name in os.listdir(outdir):
            if name.startswith("pid."):
                _kill(int(open(os.path.join(outdir, name)).read()))
        for proc, _ in procs:
            proc.wait()
    for _, log in procs:
        log.close()
    if failed:
        logs = "\n".join(f"--- node {node} ---\n" + open(os.path.join(outdir, f"node{node}.log")).read()[-20000:]
                         for node, _ in nodes)
        why = f"still running after {deadline:.0f} s, killed" if late else \
            "exit codes " + str([proc.returncode for proc, _ in procs])
        raise RuntimeError(f"{label}: {why}\n{logs}")
    return time.monotonic() - start


def train_losses(root: str):
    """The weighted loss of each logged training step, in step order."""
    runs = sorted(d for d in os.listdir(os.path.join(root, "dryrun")) if d.startswith("version_"))
    if runs != ["version_0"]:
        raise RuntimeError(f"{root}: expected one version_0, found {runs}")
    records = [json.loads(line) for line in open(os.path.join(root, "dryrun", "version_0", "metrics.jsonl"))]
    return [r["weighted_loss"] for r in sorted(records, key=lambda r: r["step"]) if r.get("prefix", "train") == "train"]


def run(nproc_per_node: int, mesh_models, deadline: float, workdir: str):
    world = 2 * nproc_per_node
    data = os.path.join(workdir, "data")
    write_corpus(data, STEPS * world)

    def config(label, mesh_model):
        root = os.path.join(workdir, label)
        path = os.path.join(workdir, f"{label}.configuration")
        with open(path, "w") as f:
            f.write(CONFIG.format(root=root, data=data, batch=world, mesh_model=mesh_model))
        return root, ["-c", path, "--device", "cpu", "--distributed"]

    root, argv = config("one_node", 1)
    seconds = launch("one node", [(0, ["--standalone", "--nnodes", "1", "--nproc_per_node", str(world)])], argv,
                     os.path.join(workdir, "one_node_ranks"), deadline)
    baseline = train_losses(root)
    result = {"ok": len(baseline) == STEPS, "nodes": 2, "nproc_per_node": nproc_per_node, "world_size": world,
              "steps": STEPS, "baseline_losses": baseline, "seconds_one_node": seconds, "runs": []}
    for mesh_model in mesh_models:
        label = f"two_nodes_model{mesh_model}"
        root, argv = config(label, mesh_model)
        port = free_port()
        nodes = [(k, ["--nnodes", "2", "--node_rank", str(k), "--nproc_per_node", str(nproc_per_node),
                      "--rdzv_backend", "c10d", "--rdzv_endpoint", f"127.0.0.1:{port}", "--rdzv_id", label])
                 for k in (0, 1)]
        ranks_dir = os.path.join(workdir, f"{label}_ranks")
        seconds = launch(f"two nodes, meshModel {mesh_model}", nodes, argv, ranks_dir, deadline)
        losses = train_losses(root)
        ranks = [json.load(open(os.path.join(ranks_dir, f"rank.{r}.json"))) for r in range(world)]
        node_of = {r["rank"]: r["node"] for r in ranks}
        local_ok = all(sorted(r["local_rank"] for r in ranks if r["node"] == k) == list(range(nproc_per_node))
                       for k in (0, 1))
        cards_ok = all(r["card"] == f"cuda:{r['local_rank']}" for r in ranks)
        groups_ok = all(len({node_of[m] for m in r["model_group"]}) == 1 and len(r["model_group"]) == mesh_model
                        for r in ranks)
        rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, baseline)) if losses else float("inf")
        tol = 1e-6 if mesh_model == 1 else 1e-5
        mesh = [world // mesh_model, 1, mesh_model]
        ok = len(losses) == STEPS and rel <= tol and local_ok and cards_ok and groups_ok \
            and all(r["mesh"] == mesh and r["world_size"] == world and r["steps"] == STEPS for r in ranks)
        result["runs"].append({
            "mesh_model": mesh_model, "ok": ok, "losses": losses, "max_rel_err": rel, "tol": tol,
            "local_ranks_per_node": local_ok, "cards_node_local": cards_ok, "model_groups_within_nodes": groups_ok,
            "ranks": [{k: r[k] for k in ("rank", "node", "local_rank", "group_rank", "card", "model_group")}
                      for r in ranks],
            "seconds": seconds,
        })
        result["ok"] = result["ok"] and ok
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description="Two torchrun nodes of cli/train.py on the CPU against one")
    p.add_argument("--nproc_per_node", type=int, default=4, help="ranks a node, N (default 4: 2 x 4 against 8)")
    p.add_argument("--mesh_model", type=int, nargs="+", default=[1],
                   help="meshModel of each two-node run (each must divide N)")
    p.add_argument("--deadline", type=float, default=600.0, help="seconds each launch may take")
    args = p.parse_args(argv)
    for m in args.mesh_model:
        if m < 1 or args.nproc_per_node % m:
            raise ValueError(f"--mesh_model {m} must divide --nproc_per_node {args.nproc_per_node}")
    workdir = tempfile.mkdtemp(prefix="multinode_dryrun_")
    try:
        result = run(args.nproc_per_node, args.mesh_model, args.deadline, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3:])
    else:
        sys.exit(main())
