"""The genie2_tpu_torch reverse loops, their RNG, classifier-free guidance
and the unconditional CLI.

The injected-noise loops are held against genie2_tpu with the same weights,
x_T and per-step noise: the ancestral loop against
`ancestral_sample_injected`, DDIM against genie2_tpu's step functions
(`ddim_step_from_eps` on the flax denoiser's eps, the body of its scan),
DPM-Solver++ against `_dpm_segment` called one step at a time.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genie2_tpu.sampling.ddpm as jddpm
from genie2_tpu.config import Config as JConfig
from genie2_tpu.diffusion import Schedule as JSchedule
from genie2_tpu.diffusion import ddim_step_from_eps as j_ddim_step
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.geometry import frenet_frames as jfrenet
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu.sampling import UnconditionalSampler as JUnconditionalSampler
from genie2_tpu.sampling import ancestral_sample_injected as j_injected
from genie2_tpu.sampling.dpm_solver import _dpm_segment as j_dpm_segment
from genie2_tpu_torch.cli import sample_scaffold, sample_sse, sample_unconditional
from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import batchify, create_empty_features, read_ca_coords, to_device
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.geometry import Rigid, frenet_frames
from genie2_tpu_torch.sampling import (
    UnconditionalSampler,
    ancestral_sample,
    ancestral_sample_injected,
    ddim_sample,
    ddim_sample_injected,
    ddim_schedule,
    dpm_solver_sample_injected,
    eta_schedule_below,
    pad_residues,
    step_noise,
)
from genie2_tpu_torch.utils.weights import params_from_flax
from tests.test_torch_denoiser import CONFIG_LINES, DIMS, make_batch, randomized_variables

T = 8


@pytest.fixture(scope="module")
def models():
    dims = dict(DIMS, n_timestep=T)
    batch = batchify([create_empty_features([24]), create_empty_features([19])])
    flax_model = FlaxDenoiser(remat=False, **dims)
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


def test_injected_trajectory_with_triangle_attention_matches():
    """Ten injected-noise steps of the small model with triangle attention
    in its pair layers, one sample padded."""
    steps = 10
    dims = dict(DIMS, n_timestep=steps, include_tri_att=True)
    batch = batchify([create_empty_features([24]), create_empty_features([19])])
    flax_model = FlaxDenoiser(remat=False, **dims)
    variables = randomized_variables(flax_model, batch)
    port = Denoiser(**dims)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    init, noises = _injected_inputs(batch, steps, 3)

    final_j, traj_j = j_injected(
        flax_model.apply, variables, JSchedule.create(steps), jto_device(batch),
        jnp.asarray(init), jnp.asarray(noises), jnp.float32(0.6),
    )
    feats = to_device(batch, "cpu")
    with torch.inference_mode():
        final_t, traj_t = ancestral_sample_injected(
            lambda frames, t: port.eval()(frames, t, feats)["z"], Schedule.create(steps), feats,
            torch.tensor(init), torch.tensor(noises), 0.6,
        )
    assert traj_t.shape[0] == steps
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


@pytest.mark.parametrize("flag", [
    (sample_unconditional, ["--mesh_seq", "2"]), (sample_unconditional, ["--mesh_model", "2"]),
    (sample_unconditional, ["--num_devices", "2"]), (sample_unconditional, ["--num_devices", "-1"]),
    (sample_scaffold, ["--mesh_seq", "2"]), (sample_scaffold, ["--mesh_model", "2"]),
    (sample_scaffold, ["--num_devices", "4"]),
    (sample_sse, ["--mesh_model", "2"]), (sample_sse, ["--num_devices", "2"]), (sample_sse, ["--num_devices", "-1"]),
    (sample_sse, ["--mesh_seq", "2"]),
])
def test_cli_refuses_unported_flags(flag, tmp_path):
    """--num_devices, --mesh_seq and --mesh_model other than 1 need a
    torchrun launch, and without one are an error naming it (the launched
    runs: tests/test_torch_seq_cli.py, tests/test_torch_tp.py)."""
    cli, flags = flag
    argv = ["--name", "x", "--epoch", "1", "--outdir", str(tmp_path), "--scale", "1", "--device", "cpu"]
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(argv + flags)


def test_cli_without_card_raises_unless_cpu(models, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--name", "x", "--epoch", "1", "--outdir", str(tmp_path), "--scale", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_unconditional.main(argv)


# ------------------------------------------------------------------ #
# DDIM, DPM-Solver++, classifier-free guidance, --pack, trajectory dumps
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("n_timestep,n_steps,spacing", [
    (1000, 50, "uniform"), (1000, 25, "sqrt"), (8, 8, "sqrt"), (8, 5, "uniform"), (10, 9, "sqrt"), (1000, 1, "uniform"),
])
def test_ddim_schedule_equals_jax(n_timestep, n_steps, spacing):
    """Uniform and sqrt spacing; (8, 8, sqrt) and (10, 9, sqrt) round
    neighbouring steps onto each other (the collision case)."""
    got = ddim_schedule(n_timestep, n_steps, spacing)
    np.testing.assert_array_equal(got, jddpm.ddim_schedule(n_timestep, n_steps, spacing))
    assert got[0, 0] == n_timestep and got[-1, 1] == 0 and len(set(got[:, 0].tolist())) == n_steps
    np.testing.assert_array_equal(
        eta_schedule_below(n_timestep, n_steps, n_timestep // 3, eta_low=0.7, spacing=spacing),
        np.asarray(jddpm.eta_schedule_below(n_timestep, n_steps, n_timestep // 3, eta_low=0.7, spacing=spacing)),
    )


def test_ddim_schedule_refuses_bad_arguments():
    with pytest.raises(ValueError, match="not in"):
        ddim_schedule(8, 9)
    with pytest.raises(ValueError, match="spacing"):
        ddim_schedule(8, 4, "cosine")


def _injected_inputs(batch, n_steps, seed):
    rng = np.random.default_rng(seed)
    mask = batch["residue_mask"][..., None].astype(np.float32)
    init = rng.normal(size=batch["atom_positions"].shape).astype(np.float32) * mask
    noises = rng.normal(size=(n_steps, *init.shape)).astype(np.float32)
    return init, noises


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_injected_trajectory_matches(models, eta):
    flax_model, variables, port, batch = models
    pairs = ddim_schedule(T, 4)
    init, noises = _injected_inputs(batch, len(pairs), 1)
    scale = 0.6

    jf, jsch = jto_device(batch), JSchedule.create(T)
    mask = jf["residue_mask"].astype(jnp.float32)[..., None]
    trans, traj_j = jnp.asarray(init), []
    for (t, t_prev), noise in zip(pairs.tolist(), noises):
        t_vec = jnp.full((init.shape[0],), t, jnp.int32)
        rots = jfrenet(trans, jf["chain_index"], jf["residue_mask"])
        eps = flax_model.apply(variables, JRigid(rots, trans), t_vec, jf)["z"]
        trans = j_ddim_step(jsch, trans, t_vec, jnp.full_like(t_vec, t_prev), eps, jnp.asarray(noise) * scale, eta) * mask
        traj_j.append(np.asarray(trans))

    feats = to_device(batch, "cpu")
    with torch.inference_mode():
        final_t, traj_t = ddim_sample_injected(
            lambda frames, t: port(frames, t, feats)["z"], Schedule.create(T), feats,
            torch.tensor(init), torch.tensor(noises), pairs, [eta] * len(pairs), scale,
        )
    np.testing.assert_allclose(traj_t.numpy(), np.stack(traj_j), atol=1e-4)
    np.testing.assert_allclose(final_t.numpy(), traj_j[-1], atol=1e-4)


def test_dpm_injected_trajectory_matches(models):
    flax_model, variables, port, batch = models
    pairs = ddim_schedule(T, 5)
    init, _ = _injected_inputs(batch, 1, 2)

    jf, jsch = jto_device(batch), JSchedule.create(T)
    carry = (jnp.asarray(init), jnp.zeros_like(jnp.asarray(init)), jnp.float32(0.0), jnp.bool_(False))
    traj_j = []
    for pair in pairs:
        carry = j_dpm_segment(flax_model.apply, variables, jsch, jf, carry, jnp.asarray(pair[None]))
        traj_j.append(np.asarray(carry[0]))

    feats = to_device(batch, "cpu")
    with torch.inference_mode():
        final_t, traj_t = dpm_solver_sample_injected(
            lambda frames, t: port(frames, t, feats)["z"], Schedule.create(T), feats, torch.tensor(init), pairs
        )
    np.testing.assert_allclose(traj_t.numpy(), np.stack(traj_j), atol=1e-4)
    np.testing.assert_allclose(final_t.numpy(), traj_j[-1], atol=1e-4)


def test_ddim_sample_independent_of_batch_composition(models):
    """DDIM noise comes from the per-(seed, sample id, t) streams too."""
    _, _, port, _ = models
    schedule = Schedule.create(T)

    def run(ids):
        feats = to_device(batchify([create_empty_features([20]) for _ in ids]), "cpu")
        with torch.inference_mode():
            return ddim_sample(lambda f, t: port(f, t, feats)["z"], schedule, feats, 11, ids, 4, eta=0.8, scale=0.6)

    pair, alone = run([5, 6]), run([6])
    torch.testing.assert_close(pair[1], alone[0], rtol=0, atol=1e-5)
    assert not torch.allclose(pair[0], pair[1])


@pytest.fixture
def tiny_release(models, tmp_path):
    """The tiny model in the release layout, T = 8 steps."""
    _, _, port, _ = models
    root = tmp_path / "results"
    (root / "tiny" / "checkpoints").mkdir(parents=True)
    (root / "tiny" / "configuration").write_text(CONFIG_LINES.replace("numTimesteps 50", f"numTimesteps {T}"))
    torch.save({"state_dict": {f"model.{k}": v for k, v in port.state_dict().items()}},
               root / "tiny" / "checkpoints" / "epoch.1.ckpt")
    return root


def test_cfg_z_matches_jax(models, tiny_release):
    """The noise prediction under guidance, eps_u + (1 + s)(eps_c - eps_u) on a
    motif-conditioned batch padded to its bucket, against genie2_tpu's
    `_cfg_apply_fn`; real rows, 1e-4. strength 0 is the conditional model."""
    flax_model, variables, port, _ = models
    path = str(tiny_release / "tiny" / "configuration")
    batch = pad_residues(make_batch(True, True), 32)
    rng = np.random.default_rng(5)
    trans_np = (rng.normal(size=batch["atom_positions"].shape) * 3 * batch["residue_mask"][..., None]).astype(np.float32)
    t_np = np.array([3, 7], np.int32)

    jsampler = JUnconditionalSampler(flax_model, variables, JConfig(path))
    jf = jto_device(batch)
    uncond = {**jf, "fixed_sequence_mask": jnp.zeros_like(jf["fixed_sequence_mask"]),
              "fixed_structure_mask": jnp.zeros_like(jf["fixed_structure_mask"])}
    jf_cfg = {**jf, "static_pair_bias": jsampler._static_bias_fn(jsampler.params, jf), "cfg_uncond": {
        "fixed_sequence_mask": uncond["fixed_sequence_mask"], "fixed_structure_mask": uncond["fixed_structure_mask"],
        "static_pair_bias": jsampler._static_bias_fn(jsampler.params, uncond)}}
    tj = jnp.asarray(trans_np)
    frames_j = JRigid(jfrenet(tj, jf["chain_index"], jf["residue_mask"]), tj)
    z_j = np.asarray(jsampler._cfg_apply_fn(1.5)(jsampler.params, frames_j, jnp.asarray(t_np), jf_cfg)["z"])

    sampler = UnconditionalSampler(port, Config(path))
    tf = to_device(batch, "cpu")
    tt = torch.tensor(trans_np)
    frames_t = Rigid(frenet_frames(tt, tf["chain_index"], tf["residue_mask"]), tt)
    with torch.inference_mode():
        z_t = sampler.make_model_fn(tf, 1.5)(frames_t, torch.tensor(t_np).long()).numpy()
        z_c = sampler.make_model_fn(tf, 0.0)(frames_t, torch.tensor(t_np).long()).numpy()
        z_plain = port(frames_t, torch.tensor(t_np).long(), tf)["z"].numpy()
    real = batch["residue_mask"].astype(bool)
    np.testing.assert_allclose(z_t[real], z_j[real], atol=1e-4)
    np.testing.assert_allclose(z_c[real], z_plain[real], atol=1e-6)
    assert np.abs(z_t[real] - z_c[real]).max() > 1e-3  # guidance changes the prediction


def _cli_argv(root, out, *extra):
    return ["--name", "tiny", "--epoch", "1", "--rootdir", str(root), "--outdir", str(out), "--scale", "0.6",
            "--device", "cpu", *extra]


def test_cli_pack_writes_every_length(tiny_release, tmp_path):
    out = tmp_path / "out"
    seconds = sample_unconditional.main(_cli_argv(
        tiny_release, out, "--pack", "--num_samples", "2", "--batch_size", "3",
        "--min_length", "14", "--max_length", "22", "--length_step", "4"))
    assert list(seconds) == ["packed"]
    names = sorted(os.listdir(out / "pdbs"))
    assert names == ["14_0.pdb", "14_1.pdb", "18_0.pdb", "18_1.pdb", "22_0.pdb", "22_1.pdb"]
    for name in names:
        xyz = read_ca_coords(str(out / "pdbs" / name))
        assert xyz.shape == (int(name.split("_")[0]), 3) and np.isfinite(xyz).all()


def test_cli_dump_trajectory_writes_snapshots(tiny_release, tmp_path):
    out = tmp_path / "out"
    sample_unconditional.main(_cli_argv(
        tiny_release, out, "--dump_trajectory_every", "3", "--num_samples", "3", "--batch_size", "2",
        "--min_length", "18", "--max_length", "18"))
    # Steps 6 and 3 of T = 8, one directory per sample() call, trimmed to the real length.
    for offset in (0, 2):
        names = sorted(os.listdir(out / "test" / f"18_{offset}"))
        assert names == ["xt_predicted_test_3.pdb", "xt_predicted_test_6.pdb"]
        xyz = read_ca_coords(str(out / "test" / f"18_{offset}" / names[0]))
        assert xyz.shape == (18, 3) and np.isfinite(xyz).all()
    assert len(os.listdir(out / "pdbs")) == 3


@pytest.mark.parametrize("flags", [["--ddim_steps", "4", "--ddim_eta", "0.5"], ["--dpm_steps", "5", "--fast_spacing", "sqrt"],
                                   ["--ddim_steps", "6", "--ddim_eta_switch_t", "4"]])
def test_cli_accelerated_samplers_write_pdbs(tiny_release, tmp_path, flags):
    out = tmp_path / "out"
    sample_unconditional.main(_cli_argv(
        tiny_release, out, *flags, "--num_samples", "2", "--batch_size", "2", "--min_length", "20", "--max_length", "20"))
    for i in range(2):
        xyz = read_ca_coords(str(out / "pdbs" / f"20_{i}.pdb"))
        assert xyz.shape == (20, 3) and np.isfinite(xyz).all() and np.abs(xyz).max() > 0


@pytest.mark.parametrize("params", [
    {"ddim_steps": 4, "dpm_steps": 4}, {"ddim_steps": 4, "dump_trajectory_every": 2},
    {"dpm_steps": 4, "dump_trajectory_every": 2}, {"ddim_eta_switch_t": 3}, {"dpm_steps": 4, "ddim_eta_switch_t": 3},
])
def test_sampler_refuses_illegal_combinations(models, tiny_release, tmp_path, params):
    """The sampler itself raises, not only the CLI."""
    _, _, port, _ = models
    sampler = UnconditionalSampler(port, Config(str(tiny_release / "tiny" / "configuration")))
    base = {"scale": 0.6, "outdir": str(tmp_path), "num_samples": 1, "prefix": "x", "offset": 0, "length": 12}
    with pytest.raises(ValueError):
        sampler.sample({**base, **params})
    with pytest.raises(ValueError, match="missing required"):
        sampler.sample({k: v for k, v in base.items() if k != "length"})
