"""genie2_tpu_torch's motif features, scaffold sampler and scaffold CLI.

The host-side motif code (numpy only) must equal genie2_tpu's: the same
spec files and the same numpy generator seed give identical specs, masks,
features and motif PDB bytes. The sampler and the CLI run on the CPU with
the tiny model of tests/test_torch_denoiser.py.
"""

import os

import jax
import numpy as np
import pytest
import torch

import genie2_tpu.features as jfeatures
from genie2_tpu.features.motif import save_motif_pdb as j_save_motif_pdb
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu_torch import features as tfeatures
from genie2_tpu_torch.cli import sample_scaffold
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.features import batchify, create_empty_features
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.sampling import ScaffoldSampler
from genie2_tpu_torch.utils.weights import params_from_flax
from tests.test_multimotif import MULTIMOTIF_SPEC
from tests.test_multimotif import _atoms as multimotif_atoms
from tests.test_sampler import MOTIF_SPEC_PDB
from tests.test_sampler import _motif_atoms as motif_atoms
from tests.test_torch_denoiser import CONFIG_LINES, DIMS, randomized_variables

T = 8
SPECS = {"tiny": (MOTIF_SPEC_PDB, motif_atoms, 4), "twogroups": (MULTIMOTIF_SPEC, multimotif_atoms, 6)}


@pytest.fixture(params=sorted(SPECS))
def spec_path(request, tmp_path):
    header, atoms, _ = SPECS[request.param]
    path = tmp_path / f"{request.param}.pdb"
    path.write_text(header + atoms())
    return str(path)


def test_spec_masks_and_features_equal_jax(spec_path):
    spec = tfeatures.load_motif_spec(spec_path)
    assert spec == jfeatures.load_motif_spec(spec_path)
    assert tfeatures.parse_pdb(spec_path) == jfeatures.parse_pdb(spec_path)
    assert tfeatures.summarize_pdb(spec_path) == jfeatures.summarize_pdb(spec_path)
    for seed in range(5):
        got = tfeatures.sample_motif_mask(spec, np.random.default_rng(seed))
        want = jfeatures.sample_motif_mask(spec, np.random.default_rng(seed))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
        f_t = tfeatures.features_from_motif_pdb(spec_path, np.random.default_rng(seed))
        f_j = jfeatures.features_from_motif_pdb(spec_path, np.random.default_rng(seed))
        assert f_t.keys() == f_j.keys()
        for k in f_t:
            np.testing.assert_array_equal(f_t[k], f_j[k], err_msg=k)


def test_motif_and_coords_pdb_bytes_equal_jax(spec_path, tmp_path):
    feats = tfeatures.features_from_motif_pdb(spec_path, np.random.default_rng(3))
    tfeatures.save_motif_pdb(spec_path, feats["fixed_sequence_mask"], str(tmp_path / "t.pdb"))
    j_save_motif_pdb(spec_path, feats["fixed_sequence_mask"], str(tmp_path / "j.pdb"))
    assert (tmp_path / "t.pdb").read_bytes() == (tmp_path / "j.pdb").read_bytes()
    assert len((tmp_path / "t.pdb").read_text().splitlines()) == int(feats["fixed_sequence_mask"].sum())

    tfeatures.save_features_to_pdb(feats, str(tmp_path / "ft.pdb"))
    jfeatures.save_features_to_pdb(feats, str(tmp_path / "fj.pdb"))
    assert (tmp_path / "ft.pdb").read_bytes() == (tmp_path / "fj.pdb").read_bytes()
    coords = np.random.default_rng(0).normal(size=(9, 3)) * 5
    tfeatures.save_coords_to_pdb(coords, str(tmp_path / "ct.pdb"))
    jfeatures.save_coords_to_pdb(coords, str(tmp_path / "cj.pdb"))
    assert (tmp_path / "ct.pdb").read_bytes() == (tmp_path / "cj.pdb").read_bytes()
    with pytest.raises(ValueError, match="fixes"):
        tfeatures.save_motif_pdb(spec_path, np.zeros(30, bool), str(tmp_path / "bad.pdb"))


def test_unsatisfiable_spec_raises(tmp_path):
    path = tmp_path / "bad.pdb"
    path.write_text(MOTIF_SPEC_PDB.replace("LENGTH      20", "LENGTH      40").replace("LENGTH      28", "LENGTH      48")
                    + motif_atoms())
    with pytest.raises(ValueError, match="unsatisfiable"):
        tfeatures.features_from_motif_pdb(str(path), np.random.default_rng(0))


@pytest.fixture(scope="module")
def tiny_release(tmp_path_factory):
    """The tiny model with randomised weights in the release layout."""
    dims = dict(DIMS, n_timestep=T)
    batch = batchify([create_empty_features([24]), create_empty_features([19])])
    variables = randomized_variables(FlaxDenoiser(remat=False, **dims), batch)
    port = Denoiser(**dims)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    root = tmp_path_factory.mktemp("results")
    (root / "tiny" / "checkpoints").mkdir(parents=True)
    (root / "tiny" / "configuration").write_text(CONFIG_LINES.replace("numTimesteps 50", f"numTimesteps {T}"))
    torch.save({"state_dict": {f"model.{k}": v for k, v in port.state_dict().items()}},
               root / "tiny" / "checkpoints" / "epoch.1.ckpt")
    return root, port.eval()


def _check_outputs(outdir, name, n_samples, n_motif, lo, hi):
    for i in range(n_samples):
        xyz = tfeatures.read_ca_coords(os.path.join(outdir, "pdbs", f"{name}_{i}.pdb"))
        assert lo <= len(xyz) <= hi and np.isfinite(xyz).all() and np.abs(xyz).max() > 0
        motif_lines = [l for l in open(os.path.join(outdir, "motif_pdbs", f"{name}_{i}.pdb")) if l.startswith("ATOM")]
        assert len(motif_lines) == n_motif
        # The design marks the motif residues with their group as segment id.
        design = [l for l in open(os.path.join(outdir, "pdbs", f"{name}_{i}.pdb")) if l.startswith("ATOM")]
        placed = [int(l[22:26]) for l in design if l[72] != " "]
        assert placed == [int(l[22:26]) for l in motif_lines]


@pytest.mark.parametrize("flags", [[], ["--strength", "1.5", "--ddim_steps", "4", "--ddim_eta", "0.5"], ["--dpm_steps", "5"]],
                         ids=["ancestral", "ddim_cfg", "dpm"])
def test_scaffold_cli_cpu_writes_designs_and_motifs(tiny_release, tmp_path, flags):
    root, _ = tiny_release
    datadir = tmp_path / "problems"
    datadir.mkdir()
    for name, (header, atoms, _) in SPECS.items():
        (datadir / f"{name}.pdb").write_text(header + atoms())
    out = tmp_path / "out"
    seconds = sample_scaffold.main([
        "--name", "tiny", "--epoch", "1", "--rootdir", str(root), "--outdir", str(out), "--scale", "0.4",
        "--datadir", str(datadir), "--num_samples", "3", "--batch_size", "2", "--device", "cpu", *flags])
    assert sorted(seconds) == ["tiny", "twogroups"]
    _check_outputs(str(out / "motif=tiny"), "tiny", 3, 4, 20, 28)
    _check_outputs(str(out / "motif=twogroups"), "twogroups", 3, 6, 24, 34)

    only = tmp_path / "only"
    sample_scaffold.main([
        "--name", "tiny", "--epoch", "1", "--rootdir", str(root), "--outdir", str(only), "--scale", "0.4",
        "--datadir", str(datadir), "--motif_name", "tiny", "--num_samples", "1", "--device", "cpu", "--dpm_steps", "2"])
    assert os.listdir(only) == ["motif=tiny"]


def test_scaffold_cli_without_problems_raises(tiny_release, tmp_path):
    root, _ = tiny_release
    with pytest.raises(FileNotFoundError, match="no motif problems"):
        sample_scaffold.main(["--name", "tiny", "--epoch", "1", "--rootdir", str(root), "--outdir", str(tmp_path / "o"),
                              "--scale", "0.4", "--datadir", str(tmp_path), "--device", "cpu"])


def test_placement_seed_reproduces_and_guidance_changes_samples(tiny_release, spec_path, tmp_path):
    root, port = tiny_release
    config = Config(str(root / "tiny" / "configuration"))

    def run(strength, placement_seed=11):
        sampler = ScaffoldSampler(port, config, placement_seed=placement_seed)
        return sampler.sample({"scale": 0.4, "outdir": str(tmp_path / "o"), "num_samples": 2, "prefix": "m",
                               "offset": 0, "filepath": spec_path, "strength": strength, "seed": 1, "dpm_steps": 3})

    a, b, steered = run(0), run(0), run(2.0)
    for fa, fb, fg in zip(a, b, steered):
        np.testing.assert_array_equal(fa["fixed_sequence_mask"], fb["fixed_sequence_mask"])
        np.testing.assert_array_equal(fa["atom_positions"], fb["atom_positions"])
        np.testing.assert_array_equal(fa["fixed_sequence_mask"], fg["fixed_sequence_mask"])
        assert np.isfinite(fg["atom_positions"]).all()
        assert np.abs(fg["atom_positions"] - fa["atom_positions"]).max() > 1e-4
    lengths = {int(f["num_residues"]) for s in range(6) for f in run(0, placement_seed=s)}
    assert len(lengths) > 1  # placements vary with the seed


def test_smoke_script_motif_problem_and_kernel_bounds(tmp_path):
    """chip_smoke.py's own motif problem parses like any other (and equally
    on the genie2_tpu side), and its byte / operation counts give the bounds
    the kernels' notes state."""
    import chip_smoke

    path = str(tmp_path / "smoke_motif.pdb")
    chip_smoke.write_motif_problem(path)
    spec = tfeatures.load_motif_spec(path)
    assert spec == jfeatures.load_motif_spec(path)
    assert [s["type"] for s in spec["structures"]] == ["scaffold", "motif", "scaffold", "motif", "scaffold"]
    assert (spec["min_total_length"], spec["max_total_length"]) == chip_smoke.TOTAL_RANGE
    assert [len(s) for s in tfeatures.parse_pdb(path)[0]] == [12, 9]
    feats = tfeatures.features_from_motif_pdb(path, np.random.default_rng(0))
    assert int(feats["fixed_sequence_mask"].sum()) == chip_smoke.N_MOTIF == 21
    assert chip_smoke.TOTAL_RANGE[0] <= int(feats["num_residues"]) <= chip_smoke.TOTAL_RANGE[1]
    assert set(np.unique(feats["fixed_group"])) == {0, 1, 2}
    coords = np.array(tfeatures.parse_pdb(path)[1][0])
    np.testing.assert_allclose(np.linalg.norm(np.diff(coords, axis=0), axis=1), 3.8, atol=2e-3)

    # B=2, N=256, fp32: IPA is bound by bytes (z read once), the contractions by operations.
    bytes_, ops = chip_smoke.kernel_bytes_ops("ipa_attention", 2, 256, 128, 128, 4)
    assert ops == 2 * 2 * 12 * 256 * 256 * (2 * 16 + 12 + 24 + 128)
    assert 2 * 256 * 256 * (128 + 12) * 4 < bytes_ < 1.10 * 2 * 256 * 256 * (128 + 12) * 4
    assert bytes_ / chip_smoke.PEAK_BYTES_PER_S > ops / chip_smoke.PEAK_OPS_PER_S["float32"]
    for name in chip_smoke.OFF_PATH:
        bytes_, ops = chip_smoke.kernel_bytes_ops(name, 2, 256, 128, 128, 4)
        assert (bytes_, ops) == (3 * 2 * 128 * 256 * 256 * 4, 2 * 2 * 128 * 256 ** 3)
