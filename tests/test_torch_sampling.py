"""The genie2_tpu_torch reverse loop, its RNG and the unconditional CLI.

The injected-noise loop is held against genie2_tpu's
`ancestral_sample_injected` with the same weights, x_T and per-step noise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.diffusion import Schedule as JSchedule
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu.sampling import ancestral_sample_injected as j_injected
from genie2_tpu_torch.cli import sample_unconditional
from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import batchify, create_empty_features, read_ca_coords, to_device
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.sampling import ancestral_sample, ancestral_sample_injected, step_noise
from genie2_tpu_torch.utils.weights import params_from_flax
from tests.test_torch_denoiser import CONFIG_LINES, DIMS, randomized_variables

T = 8


@pytest.fixture(scope="module")
def models():
    dims = dict(DIMS, n_timestep=T)
    batch = batchify([create_empty_features([24]), create_empty_features([19])])
    flax_model = FlaxDenoiser(use_pallas=False, remat=False, **dims)
    variables = randomized_variables(flax_model, batch)
    port = Denoiser(**dims)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return flax_model, variables, port.eval(), batch


def test_injected_trajectory_matches(models):
    flax_model, variables, port, batch = models
    rng = np.random.default_rng(0)
    mask = batch["residue_mask"][..., None].astype(np.float32)
    init = rng.normal(size=batch["atom_positions"].shape).astype(np.float32) * mask
    noises = rng.normal(size=(T, *init.shape)).astype(np.float32)
    scale = 0.6

    final_j, traj_j = j_injected(
        flax_model.apply, variables, JSchedule.create(T), jto_device(batch),
        jnp.asarray(init), jnp.asarray(noises), jnp.float32(scale),
    )
    feats = to_device(batch, "cpu")
    with torch.inference_mode():
        final_t, traj_t = ancestral_sample_injected(
            lambda frames, t: port(frames, t, feats)["z"], Schedule.create(T), feats,
            torch.tensor(init), torch.tensor(noises), scale,
        )
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), atol=1e-4)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(final_j), atol=1e-4)


def test_noise_streams_are_per_sample():
    a = step_noise(3, [0, 1, 2], 17, 5)
    b = step_noise(3, [2], 17, 5)
    torch.testing.assert_close(a[2], b[0], rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(step_noise(3, [0], 16, 5), step_noise(3, [0], 17, 5))
    assert not torch.equal(step_noise(4, [0], 17, 5), step_noise(3, [0], 17, 5))


def test_sample_independent_of_batch_composition(models):
    """Sample id 6 comes out the same alone or beside sample 5."""
    _, _, port, _ = models
    schedule = Schedule.create(T)

    def run(ids):
        feats = to_device(batchify([create_empty_features([20]) for _ in ids]), "cpu")
        with torch.inference_mode():
            return ancestral_sample(lambda f, t: port(f, t, feats)["z"], schedule, feats, 11, ids, 0.6)

    pair, alone = run([5, 6]), run([6])
    torch.testing.assert_close(pair[1], alone[0], rtol=0, atol=1e-5)
    assert not torch.allclose(pair[0], pair[1])


def test_cli_cpu_writes_pdbs(models, tmp_path):
    _, _, port, _ = models
    root = tmp_path / "results"
    (root / "tiny" / "checkpoints").mkdir(parents=True)
    (root / "tiny" / "configuration").write_text(CONFIG_LINES.replace("numTimesteps 50", f"numTimesteps {T}"))
    torch.save({"state_dict": {f"model.{k}": v for k, v in port.state_dict().items()}},
               root / "tiny" / "checkpoints" / "epoch.1.ckpt")
    out = tmp_path / "out"
    argv = ["--name", "tiny", "--epoch", "1", "--rootdir", str(root), "--outdir", str(out),
            "--scale", "0.6", "--num_samples", "3", "--min_length", "18",
            "--max_length", "22", "--length_step", "4", "--device", "cpu"]
    sample_unconditional.main(argv + ["--batch_size", "2"])
    names = sorted(os.listdir(out / "pdbs"))
    assert names == ["18_0.pdb", "18_1.pdb", "18_2.pdb", "22_0.pdb", "22_1.pdb", "22_2.pdb"]
    xyz = read_ca_coords(str(out / "pdbs" / "22_2.pdb"))
    assert xyz.shape == (22, 3) and np.isfinite(xyz).all() and np.abs(xyz).max() > 0

    # The same seed reproduces a sample whatever batch it shares.
    os.remove(out / "pdbs" / "22_2.pdb")
    sample_unconditional.main(argv + ["--batch_size", "3"])
    np.testing.assert_allclose(read_ca_coords(str(out / "pdbs" / "22_2.pdb")), xyz, atol=2e-3)


@pytest.mark.parametrize("flag", [["--ddim_steps", "10"], ["--dpm_steps", "5"], ["--pack"],
                                  ["--dump_trajectory_every", "2"], ["--mesh_seq", "2"],
                                  ["--mesh_model", "2"], ["--num_devices", "2"]])
def test_cli_refuses_unported_flags(flag, tmp_path):
    argv = ["--name", "x", "--epoch", "1", "--outdir", str(tmp_path), "--scale", "1", "--device", "cpu"]
    with pytest.raises(NotImplementedError):
        sample_unconditional.main(argv + flag)


def test_cli_without_card_raises_unless_cpu(models, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--name", "x", "--epoch", "1", "--outdir", str(tmp_path), "--scale", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_unconditional.main(argv)
