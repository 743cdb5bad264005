"""Data-parallel sampling on gloo ranks against one process.

The sampling CLIs with `--num_devices N` inside N spawned ranks write the
files one process writes, byte for byte: the unconditional CLI with a
sample count the ranks do not divide (padded by repeats of row 0 under
throwaway ids), on the ancestral, DDIM, DPM-Solver++ and trajectory paths,
`--pack`, and the scaffold CLI with classifier-free guidance, as
tests/test_cli.py requires of genie2_tpu. TDS and SSE shard particles:
placements and resampling decisions identical, coordinates within 2e-5,
ESS within 1e-2 (tests/test_smc.py's contract for genie2_tpu); a particle
count the ranks do not divide raises.
"""

import json
import os

import numpy as np
import pytest
import torch

from genie2_tpu_torch.cli import sample_sse
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.features import read_ca_coords
from genie2_tpu_torch.parallel import Mesh
from genie2_tpu_torch.parallel.spawn import run_ranks
from genie2_tpu_torch.sampling import SMCSampler
from tests import torch_ranks
from tests.test_sampler import MOTIF_SPEC_PDB, _motif_atoms

CONFIG = """name tiny
maximumNumResidues 32
numTimesteps 6
singleFeatureDimension 16
pairFeatureDimension 8
positionalEmbeddingDimension 8
chainEmbeddingDimension 4
timestepEmbeddingDimension 8
relativePositionK 4
templateDistanceNumBins 5
numPairTransformLayers 1
triangularMultiplicativeHiddenDimension 4
pairTransitionN 2
numStructureLayers 1
ipaHiddenDimension 4
ipaNumHeads 2
ipaNumQkPoints 2
ipaNumVPoints 2
"""

# The MotifBench-style target of tests/test_smc.py: two segments, length 24.
MOTIF_TARGET_PDB = """HEADER    test
TITLE     tiny
REMARK    name : 24
ATOM      1  CA  ALA A   1       1.000   0.000   0.000
ATOM      2  CA  ALA A   2       4.800   0.000   0.000
ATOM      3  CA  ALA A   3       8.600   0.000   0.000
ATOM      4  CA  ALA A   4      11.900   2.000   0.500
TER
ATOM      5  CA  ALA A  10       0.000   5.000   0.000
ATOM      6  CA  ALA A  11       0.000   8.800   0.000
ATOM      7  CA  ALA A  12       1.500  12.100   1.000
TER
"""


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A release-layout checkpoint of a seeded tiny model (`closed`
    quaternions, so that TDS differentiates on the CPU), a scaffold problem
    and a TDS target. Returns (work dir, root, model's state_dict)."""
    work = tmp_path_factory.mktemp("release")
    root = work / "results"
    (root / "tiny" / "checkpoints").mkdir(parents=True)
    (root / "tiny" / "configuration").write_text(CONFIG)
    model = torch_ranks.seeded_model(Config(str(root / "tiny" / "configuration")))
    ckpt = root / "tiny" / "checkpoints" / "epoch.1.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in model.state_dict().items()}}, ckpt)
    (root / "tiny" / "checkpoints" / "epoch.1.ckpt.meta.json").write_text(json.dumps({"rot_to_quat_method": "closed"}))
    (work / "scaffold").mkdir()
    (work / "scaffold" / "p1.pdb").write_text(MOTIF_SPEC_PDB + _motif_atoms())
    (work / "tds").mkdir()
    (work / "tds" / "0_test.pdb").write_text(MOTIF_TARGET_PDB)
    return work, root, model.state_dict()


def _argv(root, outdir, *flags):
    return ["--name", "tiny", "--epoch", "1", "--rootdir", str(root), "--outdir", str(outdir), "--seed", "0",
            "--device", "cpu", *flags]


UNCOND = "genie2_tpu_torch.cli.sample_unconditional"
RUNS = {
    # name -> (CLI, flags): 3 samples a length, so two ranks pad each batch.
    "ancestral": (UNCOND, ["--scale", "0.6", "--num_samples", "3", "--batch_size", "3", "--min_length", "18",
                           "--max_length", "22", "--length_step", "4"]),
    "ddim": (UNCOND, ["--scale", "0.6", "--num_samples", "3", "--batch_size", "3", "--min_length", "20",
                      "--max_length", "20", "--ddim_steps", "4", "--ddim_eta", "0.5"]),
    "dpm": (UNCOND, ["--scale", "0.6", "--num_samples", "3", "--batch_size", "3", "--min_length", "20",
                     "--max_length", "20", "--dpm_steps", "4"]),
    "trajectory": (UNCOND, ["--scale", "0.6", "--num_samples", "3", "--batch_size", "3", "--min_length", "20",
                            "--max_length", "20", "--dump_trajectory_every", "2"]),
    "pack": (UNCOND, ["--scale", "0.6", "--num_samples", "1", "--batch_size", "3", "--min_length", "16",
                      "--max_length", "24", "--length_step", "4", "--pack"]),
    "scaffold_cfg": ("genie2_tpu_torch.cli.sample_scaffold", ["--scale", "0.4", "--num_samples", "3",
                                                              "--batch_size", "3", "--strength", "1.5",
                                                              "--ddim_steps", "4"]),
}


def _runs(work, root, label, names):
    out = []
    for name in names:
        cli, flags = RUNS[name]
        extra = ["--datadir", str(work / "scaffold")] if "scaffold" in cli else []
        out.append((cli, _argv(root, work / label / name, *flags, *extra)))
    return out


def _files(outdir):
    """{relative path: bytes} of every PDB file under `outdir`."""
    found = {}
    for base, _, names in os.walk(outdir):
        for n in names:
            if n.endswith(".pdb"):
                path = os.path.join(base, n)
                found[os.path.relpath(path, outdir)] = open(path, "rb").read()
    return found


@pytest.fixture(scope="module")
def cli_outputs(release):
    """Every run of RUNS in two ranks (with --num_devices 2) and in one
    process, the scaffold's placements from seed 7 in both."""
    work, root, _ = release
    ranks = [(cli, argv + ["--num_devices", "2"]) for cli, argv in _runs(work, root, "ranks", RUNS)]
    sizes = [res[1] for res in run_ranks(torch_ranks.cli_runs, 2, (ranks, 7))]
    alone = torch_ranks.cli_runs(0, _runs(work, root, "alone", RUNS), 7)[1]
    return work, sizes, alone


def test_cli_ranks_run_half_of_each_batch(cli_outputs):
    """Every batch of 3 is padded to 4, 2 rows a rank; one process runs 3."""
    _, sizes, alone = cli_outputs
    assert sizes == [[2], [2]] and alone == [3]


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_files_equal_one_process(cli_outputs, name):
    """The same files, byte for byte, with nothing from the padding rows."""
    work = cli_outputs[0]
    got, want = _files(work / "ranks" / name), _files(work / "alone" / name)
    assert want and got == want
    if name == "ancestral":
        assert sorted(got) == [f"pdbs/{n}_{i}.pdb" for n in (18, 22) for i in range(3)]
    if name == "trajectory":
        assert sorted(p for p in got if p.startswith("test/")) == [
            f"test/20_0/xt_predicted_test_{t}.pdb" for t in (2, 4, 6)]


def test_three_ranks_pad_two_samples(release):
    """Three ranks, two samples: one padding row, the files of one process."""
    work, root, _ = release
    flags = ["--scale", "0.6", "--num_samples", "2", "--batch_size", "2", "--min_length", "20", "--max_length", "20"]
    ranks = run_ranks(torch_ranks.cli_runs, 3, ([(UNCOND, _argv(root, work / "three", *flags, "--num_devices", "-1"))],))
    torch_ranks.cli_runs(0, [(UNCOND, _argv(root, work / "one", *flags))])
    got, want = _files(work / "three"), _files(work / "one")
    assert sorted(want) == ["pdbs/20_0.pdb", "pdbs/20_1.pdb"] and got == want
    assert [sizes for _, sizes in ranks] == [[1], [1], [1]]


@pytest.fixture(scope="module")
def tds_outputs(release, tmp_path_factory):
    work, root, state_dict = release
    cfg = str(root / "tiny" / "configuration")
    out = tmp_path_factory.mktemp("tds")
    args = (cfg, state_dict, str(work / "tds"))
    ranks = run_ranks(torch_ranks.tds_run, 2, (*args, str(out / "ranks"), 8))
    alone = torch_ranks.tds_run(0, *args, str(out / "alone"), 8, distributed=False)
    return ranks, alone, out


def test_tds_particles_over_two_ranks(tds_outputs):
    """8 particles, 4 a rank: placements, resampling decisions and each
    step's best placement identical, coordinates within 2e-5, ESS within
    1e-2, on both ranks; at least one step resamples."""
    ranks, alone, _ = tds_outputs
    assert alone["resampled"].any()
    for res in ranks:
        assert res["placements"] == alone["placements"]
        np.testing.assert_array_equal(res["resampled"], alone["resampled"])
        np.testing.assert_array_equal(res["best"], alone["best"])
        np.testing.assert_allclose(res["x"], alone["x"], atol=2e-5, rtol=0)
        np.testing.assert_allclose(res["ess"], alone["ess"], atol=1e-2, rtol=0)
        np.testing.assert_allclose(res["dist"], alone["dist"], rtol=1e-4)


def test_tds_files_written_once(tds_outputs):
    """Rank 0 writes the designs, the placement and the manifests."""
    _, _, out = tds_outputs
    for label in ("ranks", "alone"):
        assert sorted(os.listdir(out / label / "pdbs")) == [f"24_{i}.pdb" for i in range(8)]
        assert (out / label / "scaffold_info.csv").read_text().count("\n") == 9
    assert (out / "ranks" / "motif_location.txt").read_text() == (out / "alone" / "motif_location.txt").read_text()
    for i in range(8):
        np.testing.assert_allclose(read_ca_coords(str(out / "ranks" / "pdbs" / f"24_{i}.pdb")),
                                   read_ca_coords(str(out / "alone" / "pdbs" / f"24_{i}.pdb")), atol=1.01e-3)


def test_sse_particles_over_two_ranks(release):
    """SSE-guided sampling, 8 particles over two ranks, with the same
    contract; strength 200 makes the filter resample."""
    _, root, state_dict = release
    args = (str(root / "tiny" / "configuration"), state_dict, 8, 20, 200.0)
    ranks = run_ranks(torch_ranks.sse_run, 2, args)
    alone = torch_ranks.sse_run(0, *args, distributed=False)
    assert alone["resampled"].any()
    for res in ranks:
        np.testing.assert_array_equal(res["resampled"], alone["resampled"])
        np.testing.assert_allclose(res["x"], alone["x"], atol=2e-5, rtol=0)
        np.testing.assert_allclose(res["ess"], alone["ess"], atol=1e-2, rtol=0)
        np.testing.assert_allclose(res["log_w"], alone["log_w"], atol=1e-4)


def test_particle_counts_the_ranks_do_not_divide_raise(release, monkeypatch, tmp_path):
    """TDS and SSE refuse 3 particles on 2 ranks before any collective:
    particles are sharded, not padded."""
    work, root, state_dict = release
    mesh = Mesh(0, 2, torch.device("cpu"))
    sampler = SMCSampler(*torch_ranks._model(str(root / "tiny" / "configuration"), state_dict), mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        sampler.sample({"scale": 1.0, "outdir": str(tmp_path / "tds"), "num_samples": 3, "prefix": "24",
                        "offset": 0, "motif_index": 0, "motif_dir": str(work / "tds")})
    monkeypatch.setattr("genie2_tpu_torch.parallel.mesh_from_arg", lambda *args: mesh)
    with pytest.raises(ValueError, match="divisible"):
        sample_sse.main(_argv(root, tmp_path / "sse", "--length", "18", "--num_particles", "3", "--num_devices", "2"))
