"""genie2_tpu_torch's particle machinery and SSE-guided sampling against
genie2_tpu: the resamplers with the uniform draws passed in (exact
indices), the soft SSE statistic (1e-6), the hard P-SEA annotator (equal),
the Feynman-Kac filter and the guided sampler on a tiny model with injected
proposal noise and injected resampling offsets (particles and ESS trace
within 1e-4, the same resampling steps), and the CLI on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genie2_tpu.features.secstruct as j_secstruct
import genie2_tpu.sampling.resampling as j_resampling
from genie2_tpu.diffusion import Schedule as JSchedule
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu.sampling import smc_feynman_kac as j_smc_feynman_kac
from genie2_tpu.sampling import soft_sse_fraction as j_soft_sse_fraction
from genie2_tpu.sampling.ddpm import reverse_step as j_reverse_step
from genie2_tpu_torch.cli import sample_sse
from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import batchify, create_empty_features, read_ca_coords, secstruct, to_device
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.sampling import (
    RESAMPLERS,
    ess_from_log_weights,
    normalize_log_weights,
    resampling_draws,
    resampling_generator,
    smc_feynman_kac,
    soft_sse_fraction,
    sse_guided_sample,
    sse_guided_sample_injected,
)
from genie2_tpu_torch.utils.weights import params_from_flax
from tests.test_aux import ideal_helix, ideal_strand
from tests.test_torch_denoiser import CONFIG_LINES, DIMS, randomized_variables

T = 6
P = 4
N_RES = 16


# ------------------------------------------------------------------ #
# Weights, ESS, resamplers
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("shape,axis", [((7,), 0), ((5, 3), 0), ((5, 3), 1)])
def test_log_weight_helpers_match_jax(shape, axis):
    log_w = (np.random.default_rng(0).normal(size=shape) * 4).astype(np.float32)
    np.testing.assert_allclose(
        normalize_log_weights(torch.tensor(log_w), dim=axis).numpy(),
        np.asarray(j_resampling.normalize_log_weights(jnp.asarray(log_w), axis=axis)), atol=1e-6)
    np.testing.assert_allclose(
        ess_from_log_weights(torch.tensor(log_w), dim=axis).numpy(),
        np.asarray(j_resampling.ess_from_log_weights(jnp.asarray(log_w), axis=axis)), rtol=1e-5)


def _jax_draws(scheme, key, n):
    """The uniform numbers the JAX resampler draws from `key`."""
    if scheme == "systematic":
        return jax.random.uniform(key, (), minval=0.0, maxval=1.0 / n)
    return jax.random.uniform(key, (n,))  # stratified; jax.random.choice draws the same for "multinomial"


@pytest.mark.parametrize("scheme", ["systematic", "stratified", "multinomial"])
@pytest.mark.parametrize("n,seed", [(8, 0), (8, 1), (33, 2), (5, 3)])
def test_resamplers_give_jax_indices(scheme, n, seed):
    rng = np.random.default_rng(seed)
    weights = np.exp(rng.normal(size=n) * 2).astype(np.float32)  # unnormalised, skewed
    key = jax.random.PRNGKey(seed + 10)
    want = np.asarray(j_resampling.RESAMPLERS[scheme](jnp.asarray(weights), key))
    draws = torch.tensor(np.asarray(_jax_draws(scheme, key, n)))
    got = RESAMPLERS[scheme](torch.tensor(weights), draws).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < n
    assert set(RESAMPLERS) == set(j_resampling.RESAMPLERS)


def test_resampling_draws_and_generator():
    g = resampling_generator(5)
    off = resampling_draws("systematic", 8, g, steps=100)
    assert off.shape == (100,) and (off >= 0).all() and (off < 1 / 8).all()
    assert resampling_draws("stratified", 8, g).shape == (8,)
    assert resampling_draws("multinomial", 8, g, steps=3).shape == (3, 8)
    again = resampling_draws("systematic", 8, resampling_generator(5), steps=100)
    torch.testing.assert_close(off, again, rtol=0, atol=0)
    assert not torch.equal(off, resampling_draws("systematic", 8, resampling_generator(6), steps=100))
    with pytest.raises(ValueError, match="unknown resampling"):
        resampling_draws("residual", 8, g)
    # A degenerate weight vector sends every particle to the one with mass.
    idx = RESAMPLERS["systematic"](torch.tensor([0.0, 0.0, 1.0, 0.0]), off[0] * 2)
    assert idx.tolist() == [2, 2, 2, 2]


# ------------------------------------------------------------------ #
# The SSE statistics
# ------------------------------------------------------------------ #


def _traces():
    rng = np.random.default_rng(1)
    return {
        "helix": np.asarray(ideal_helix(30), np.float32),
        "strand": np.asarray(ideal_strand(30), np.float32),
        "noise": (rng.normal(size=(30, 3)) * 6).astype(np.float32),
    }


@pytest.mark.parametrize("trace", ["helix", "strand", "noise"])
@pytest.mark.parametrize("target", ["helix", "strand"])
def test_soft_sse_fraction_matches_jax(trace, target):
    xyz = np.concatenate([_traces()[trace], np.zeros((6, 3), np.float32)])[None]
    mask = np.concatenate([np.ones(30), np.zeros(6)]).astype(np.float32)[None]
    want = np.asarray(j_soft_sse_fraction(jnp.asarray(xyz), jnp.asarray(mask), target))
    got = soft_sse_fraction(torch.tensor(xyz), torch.tensor(mask), target).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert 0.0 <= got[0] <= 1.0
    if trace == target:
        assert got[0] > 0.5


def test_soft_sse_fraction_is_differentiable():
    x = torch.tensor(np.asarray(ideal_helix(20), np.float32))[None].requires_grad_(True)
    soft_sse_fraction(x, torch.ones(1, 20), "helix").sum().backward()
    assert x.grad.abs().max() > 0


@pytest.mark.parametrize("trace", ["helix", "strand", "noise"])
def test_secstruct_equals_jax_package(trace):
    xyz = _traces()[trace].astype(np.float64)
    np.testing.assert_array_equal(secstruct.assign_secstruct(xyz), j_secstruct.assign_secstruct(xyz))
    assert secstruct.sec_struct_frac(xyz) == j_secstruct.sec_struct_frac(xyz)
    assert secstruct.helix_statistic(xyz) == j_secstruct.helix_statistic(xyz)
    assert secstruct.sec_struct_frac(np.zeros((0, 3))) == (0.0, 0.0, 0.0)


# ------------------------------------------------------------------ #
# The particle filter and the guided sampler
# ------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def models():
    dims = dict(DIMS, n_timestep=T)
    batch = batchify([create_empty_features([N_RES]) for _ in range(P)])
    flax_model = FlaxDenoiser(remat=False, **dims)
    two = batchify([create_empty_features([N_RES]) for _ in range(2)])
    variables = randomized_variables(flax_model, two)
    port = Denoiser(**dims)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return flax_model, variables, port.eval(), batch


def _jax_keys(key, n_steps, n_particles):
    """The resampling offsets `smc_feynman_kac` draws from `key`: its body
    splits the carried key three ways every step."""
    offsets = []
    for _ in range(n_steps):
        key, _, r_key = jax.random.split(key, 3)
        offsets.append(np.asarray(jax.random.uniform(r_key, (), minval=0.0, maxval=1.0 / n_particles)))
    return np.stack(offsets).astype(np.float32)


@pytest.mark.parametrize("ess_threshold,expect", [(0.5, None), (1.1, True), (-1.0, False)])
def test_sse_guided_injected_matches_jax(models, ess_threshold, expect):
    """The same x_T, per-step noise and resampling offsets through
    genie2_tpu's `smc_feynman_kac` (with the proposal and potential of its
    `sse_guided_sample`) and through the port."""
    flax_model, variables, port, batch = models
    rng = np.random.default_rng(7)
    init = (rng.normal(size=(P, N_RES, 3)) * 3).astype(np.float32)
    noises = rng.normal(size=(T, P, N_RES, 3)).astype(np.float32)
    strength, scale = 400.0, 0.6
    key = jax.random.PRNGKey(3)
    offsets = _jax_keys(key, T, P)

    jf, jsch = jto_device(batch), JSchedule.create(T)
    jnoises = jnp.asarray(noises)

    def M(m_key, particles, extra, t):
        return j_reverse_step(flax_model.apply, variables, jsch, jf, particles, t, jnoises[T - t], jnp.float32(scale)), None

    def G(new, old, extra, t):
        mask = jf["residue_mask"]
        return jnp.float32(strength) * (j_soft_sse_fraction(new, mask, "helix") - j_soft_sse_fraction(old, mask, "helix"))

    want = j_smc_feynman_kac(M, G, jnp.asarray(init), None, key, T, P, ess_threshold=ess_threshold)

    feats = to_device(batch, "cpu")
    trans, got = sse_guided_sample_injected(
        lambda frames, t: port(frames, t, feats)["z"], Schedule.create(T), feats, torch.tensor(init),
        torch.tensor(noises), torch.tensor(offsets), "helix", strength, scale, ess_threshold)
    resampled = np.asarray(want.resampled_trace)
    np.testing.assert_array_equal(got.resampled_trace.numpy(), resampled)
    np.testing.assert_allclose(got.ess_trace.numpy(), np.asarray(want.ess_trace), atol=1e-4)
    np.testing.assert_allclose(trans.numpy(), np.asarray(want.particles), atol=1e-4)
    np.testing.assert_allclose(got.log_weights.numpy(), np.asarray(want.log_weights), atol=1e-4)
    assert got.ess_trace.shape == (T,) and (got.ess_trace >= 1 - 1e-5).all() and (got.ess_trace <= P + 1e-5).all()
    if expect is None:
        assert resampled.any() and not resampled.all()  # both branches are exercised
    else:
        assert (resampled == expect).all()


def test_feynman_kac_on_a_dict_of_particles():
    """The seeded form on a toy problem: particles are a dict, the extra
    state is gathered with them, and the weights follow the potential."""
    n, steps = 6, 5
    init = {"x": torch.arange(n, dtype=torch.float32), "tag": torch.arange(n)}

    def M(noise, particles, extra, t):
        return {"x": particles["x"] + noise, "tag": particles["tag"]}, particles["tag"].clone()

    def G(new, old, extra, t):
        assert torch.equal(extra, new["tag"])
        return 3.0 * (new["tag"] == 4).float()  # only particle 4 gains weight

    res = smc_feynman_kac(M, G, init, None, lambda t: torch.full((n,), float(t)), resampling_generator(0), steps, n,
                          ess_threshold=0.9)
    assert res.resampled_trace.any()
    assert (res.particles["tag"] == 4).sum() >= 4  # the population moved onto it
    torch.testing.assert_close(res.particles["x"], res.particles["tag"].float() + sum(range(1, steps + 1)))
    never = smc_feynman_kac(M, G, init, None, lambda t: torch.zeros(n), resampling_generator(0), steps, n,
                            ess_threshold=-1.0)
    assert not never.resampled_trace.any() and never.particles["tag"].tolist() == list(range(n))
    np.testing.assert_allclose(torch.exp(never.log_weights).sum().item(), n, rtol=1e-5)


def test_sse_guided_sample_is_seeded_and_masked(models):
    _, _, port, _ = models
    batch = batchify([create_empty_features([N_RES - 3]) for _ in range(P)])
    from genie2_tpu_torch.sampling import pad_residues

    feats = to_device(pad_residues(batch, N_RES), "cpu")
    model_fn = lambda frames, t: port(frames, t, feats)["z"]
    a, res = sse_guided_sample(model_fn, Schedule.create(T), feats, 11, P, strength=50.0)
    b, _ = sse_guided_sample(model_fn, Schedule.create(T), feats, 11, P, strength=50.0)
    c, _ = sse_guided_sample(model_fn, Schedule.create(T), feats, 12, P, strength=50.0)
    assert a.shape == (P, N_RES, 3) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    assert a[:, N_RES - 3:].abs().max() == 0  # padded residues stay at the origin
    assert res.ess_trace.shape == (T,)
    with pytest.raises(ValueError, match="feature rows"):
        sse_guided_sample_injected(model_fn, Schedule.create(T), feats, a[:2], torch.zeros(T, 2, N_RES, 3), torch.zeros(T))


# ------------------------------------------------------------------ #
# The CLI
# ------------------------------------------------------------------ #


def test_cli_cpu_writes_pdbs(models, tmp_path, capsys):
    _, _, port, _ = models
    root = tmp_path / "results"
    (root / "tiny" / "checkpoints").mkdir(parents=True)
    (root / "tiny" / "configuration").write_text(CONFIG_LINES.replace("numTimesteps 50", f"numTimesteps {T}"))
    torch.save({"state_dict": {f"model.{k}": v for k, v in port.state_dict().items()}},
               root / "tiny" / "checkpoints" / "epoch.1.ckpt")
    out = tmp_path / "out"
    result = sample_sse.main([
        "--name", "tiny", "--epoch", "1", "--rootdir", str(root), "--outdir", str(out), "--length", "18",
        "--num_particles", "3", "--target", "strand", "--strength", "30", "--device", "cpu"])
    assert sorted(os.listdir(out / "pdbs")) == ["18_0.pdb", "18_1.pdb", "18_2.pdb"]
    for i in range(3):
        xyz = read_ca_coords(str(out / "pdbs" / f"18_{i}.pdb"))
        assert xyz.shape == (18, 3) and np.isfinite(xyz).all() and np.abs(xyz).max() > 0
    assert len(result["ess_trace"]) == T and len(result["soft"]) == 3
    assert 1.0 - 1e-5 <= result["ess_min"] <= result["ess_mean"] <= 3.0 + 1e-5
    assert 0.0 <= result["soft_mean"] <= result["soft_max"] <= 1.0 and 0.0 <= result["hard_mean"] <= 1.0
    assert 0 <= result["resamples"] <= T
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("3 particles, target=strand strength=30.0: soft strand mean=") and "resamples=" in line


def test_cli_without_card_raises_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_sse.main(["--name", "x", "--epoch", "1", "--outdir", str(tmp_path)])
