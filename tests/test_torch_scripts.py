"""The port's console scripts (`pyproject.toml` `[project.scripts]`, the
`genie2-torch-*` entries) run as the wrapper that pip generates runs them,
`sys.exit(target())` with the arguments in `sys.argv`, and exit with status
0 after a successful run: the training CLI, the checkpoint converter and
the AFDB fetcher for real at a tiny size, the four samplers with their
`main` standing in for a run (each returns its seconds or its summary, and
the script must drop it)."""

import importlib
import os
import sys
import tomllib

import numpy as np
import pytest
import torch

from genie2_tpu_torch.config import Config
from genie2_tpu_torch.features import create_empty_features, save_features_to_pdb
from genie2_tpu_torch.nn import Denoiser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "pyproject.toml"), "rb") as _f:
    ALL_SCRIPTS = tomllib.load(_f)["project"]["scripts"]
SCRIPTS = {name: target for name, target in ALL_SCRIPTS.items() if name.startswith("genie2-torch-")}

TINY = """name tiny
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
batchSize 2
logEverySteps 1
checkpointEveryEpoches 1
"""


def run_script(name, argv, monkeypatch):
    """`name`'s exit status when its wrapper runs it with `argv`."""
    module_name, func = SCRIPTS[name].split(":")
    target = getattr(importlib.import_module(module_name), func)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    with pytest.raises(SystemExit) as exc:
        sys.exit(target())
    return 0 if exc.value.code is None else exc.value.code


def test_one_torch_script_for_each_of_genie2_tpus():
    ours = {name.replace("genie2-torch-", "genie2-") for name in SCRIPTS}
    theirs = {name for name, target in ALL_SCRIPTS.items() if target.startswith("genie2_tpu.")}
    assert len(SCRIPTS) == 7 and ours == theirs


@pytest.mark.parametrize("name,result", [
    ("genie2-torch-sample-unconditional", {24: 1.5}),
    ("genie2-torch-sample-scaffold", {"motif": 1.5}),
    ("genie2-torch-sample-motif-smc", {"ess": [1.0], "seconds": 1.5}),
    ("genie2-torch-sample-sse", {"seconds": 1.5}),
])
def test_sampler_scripts_drop_the_result(name, result, monkeypatch):
    module = importlib.import_module(SCRIPTS[name].split(":")[0])
    seen = []
    monkeypatch.setattr(module, "main", lambda argv=None: seen.append(sys.argv[1:]) or result)
    assert run_script(name, ["--name", "x"], monkeypatch) == 0
    assert seen == [["--name", "x"]]


def test_train_script_exits_zero(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(4):
        length = int(rng.integers(12, 24))
        f = create_empty_features([length])
        steps = rng.normal(size=(length, 3))
        f["atom_positions"] = np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=-1, keepdims=True), axis=0)
        f["aatype"] = np.eye(20)[rng.integers(0, 20, length)].astype(int)
        save_features_to_pdb(f, str(data / f"walk_{i}.pdb"))
    cfg = tmp_path / "configuration"
    cfg.write_text(TINY.format(root=tmp_path / "runs", data=data))
    assert run_script("genie2-torch-train", ["-c", str(cfg), "--device", "cpu"], monkeypatch) == 0
    assert (tmp_path / "runs" / "tiny" / "version_0" / "checkpoints" / "epoch=0.ckpt").is_file()


def test_convert_script_exits_zero(tmp_path, monkeypatch):
    cfg = tmp_path / "configuration"
    cfg.write_text(TINY.format(root=tmp_path, data=tmp_path))
    torch.manual_seed(0)
    state = Denoiser.from_config(Config(str(cfg))).state_dict()
    src, dst = tmp_path / "ref.ckpt", tmp_path / "out.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()}, "epoch": 1}, src)
    assert run_script("genie2-torch-convert-checkpoint", [str(src), str(dst), "--config", str(cfg)], monkeypatch) == 0
    assert dst.is_file() and (tmp_path / "out.ckpt.meta.json").is_file()


def test_fetch_script_exits_zero(tmp_path, monkeypatch):
    index = tmp_path / "index.txt"
    index.write_text("")
    argv = ["--index", str(index), "--outdir", str(tmp_path / "pdbs"), "--base_url", "http://127.0.0.1:9"]
    assert run_script("genie2-torch-fetch-afdb", argv, monkeypatch) == 0
