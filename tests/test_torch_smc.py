"""genie2_tpu_torch's TDS/SMC motif scaffolding against genie2_tpu.

The placement machinery (identical tables for the same generator), the
twisting potentials (values and gradients within 1e-5), the motif target
loader and the manifests (equal outputs, byte-equal files), an 8-step TDS
trajectory on a tiny model with x_T, the noise and the resampling offsets
replayed from genie2_tpu's key splits (translations, scores and ESS within
1e-4, resampling flags and placements exact) for both proposals, with and
without the rotation term, and at the default tausq (the ESS within 1e-3
there), and the CLI on the CPU.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genie2_tpu.sampling.manifest as j_manifest
import genie2_tpu.sampling.motif_target as j_motif_target
import genie2_tpu.sampling.twisting as j_twisting
from genie2_tpu.diffusion import Schedule as JSchedule
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu.sampling.smc import tds_sample as j_tds_sample
from genie2_tpu_torch.cli import sample_motif_smc
from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import batchify, create_empty_features, read_ca_coords, to_device
from genie2_tpu_torch.geometry import frenet_frames
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.sampling import (
    TDSTrace,
    enumerate_motif_placements,
    load_motif_target,
    load_motif_target_info,
    motif_distance,
    motif_frame_rotations,
    parse_motif_target_pdb,
    placements_to_positions,
    tds_sample,
    tds_sample_injected,
    twisting_log_prob,
    twisting_log_prob_frames,
    write_benchmark_manifests,
    xstart_variance,
)
from genie2_tpu_torch.utils.weights import params_from_flax
from tests.test_torch_denoiser import CONFIG_LINES, DIMS, randomized_variables

T = 8
P = 4
L = 24
# One pair layer and one structure layer: the TDS cases compile genie2_tpu's
# forward and backward scan once each.
DIMS_TDS = dict(DIMS, n_timestep=T, n_pair_transform_layer=1, n_structure_layer=1)
CONFIG_TDS = (CONFIG_LINES.replace("numTimesteps 50", "numTimesteps 6")
              .replace("numPairTransformLayers 2", "numPairTransformLayers 1")
              .replace("numStructureLayers 2", "numStructureLayers 1"))

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


def _helix(n, offset=(0.0, 0.0, 0.0)):
    t = np.arange(n) * np.radians(100.0)
    xyz = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(n)], axis=-1)
    return (xyz + np.asarray(offset)).astype(np.float32)


# ------------------------------------------------------------------ #
# Placements, potentials, targets, manifests
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("length,segs,max_offsets", [(10, [3], 1000), (12, [2, 3], 1000), (40, [3, 4, 2], 50),
                                                     (100, [5], 10)])
def test_placements_equal_jax(length, segs, max_offsets):
    got = enumerate_motif_placements(length, segs, max_offsets, rng=np.random.default_rng(3))
    want = j_twisting.enumerate_motif_placements(length, segs, max_offsets, rng=np.random.default_rng(3))
    assert got == want and len(got) <= max_offsets
    np.testing.assert_array_equal(placements_to_positions(got), j_twisting.placements_to_positions(want))


@pytest.mark.parametrize("var_type", [1, 2, 4, 5, 6])
def test_xstart_variance_matches_jax(var_type):
    abar = np.float32(0.37)
    beta = np.float32(0.02)
    got = xstart_variance(torch.tensor(abar), 0.05, var_type, beta_t=torch.tensor(beta))
    want = j_twisting.xstart_variance(jnp.float32(abar), 0.05, var_type, beta_t=jnp.float32(beta))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _potential_inputs(seed=0):
    rng = np.random.default_rng(seed)
    segs = [_helix(5, (3.0, 0.0, 0.0)), _helix(4, (0.0, 6.0, 1.0))]
    target = np.concatenate(segs)
    target = target - target.mean(0, keepdims=True)
    positions = placements_to_positions(enumerate_motif_placements(20, [5, 4]))
    x0 = (rng.normal(size=(3, 20, 3)) * 4).astype(np.float32)
    x0[0, 2:7] = segs[0] + 1.0  # particle 0 carries the first segment
    return segs, target, positions, x0


def _torch_grad(fn, x0_np):
    x = torch.tensor(x0_np, requires_grad=True)
    lp, score = fn(x)
    (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach().numpy(), score.detach().numpy(), g.numpy()


def _assert_close_rel(got, want, tol=1e-5):
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("frames", [False, True])
def test_twisting_potentials_match_jax(frames):
    """log p~, the per-placement scores and d(sum log p~)/dx0 (through the
    Frenet frames of x0 where the rotation term is on)."""
    segs, target, positions, x0 = _potential_inputs()
    # float32 rounds a score s to about 6e-8 |s|, and the gradient of the
    # logsumexp moves with the score differences: variances that keep |s|
    # in the tens leave that below the 1e-5 compared here.
    var, rot_var = 2.0, 1.0
    pos_t, tgt_t = torch.from_numpy(positions), torch.from_numpy(target)
    chain, mask = np.zeros((3, 20), np.int64), np.ones((3, 20), np.int64)
    if frames:
        rots_np, rmask_np = motif_frame_rotations(segs)
        j_rots, j_rmask = j_twisting.motif_frame_rotations(segs)
        np.testing.assert_allclose(rots_np, j_rots, atol=1e-6)
        np.testing.assert_array_equal(rmask_np, j_rmask)

        def t_fn(x):
            r0 = frenet_frames(x, torch.from_numpy(chain), torch.from_numpy(mask))
            return twisting_log_prob_frames(x, r0, pos_t, tgt_t, var, torch.from_numpy(rots_np),
                                            torch.from_numpy(rmask_np), rot_var)

        def j_fn(x):
            from genie2_tpu.geometry import frenet_frames as jfrenet

            r0 = jfrenet(x, jnp.asarray(chain, jnp.int32), jnp.asarray(mask, jnp.int32))
            return j_twisting.twisting_log_prob_frames(x, r0, jnp.asarray(positions), jnp.asarray(target), var,
                                                       jnp.asarray(j_rots), jnp.asarray(j_rmask), rot_var)
    else:
        def t_fn(x):
            return twisting_log_prob(x, pos_t, tgt_t, var)

        def j_fn(x):
            return j_twisting.twisting_log_prob(x, jnp.asarray(positions), jnp.asarray(target), var)

    lp, score, grad = _torch_grad(t_fn, x0)
    (j_lp, j_score), j_grad = jax.jit(j_fn)(jnp.asarray(x0)), jax.jit(jax.grad(lambda x: jnp.sum(j_fn(x)[0])))(
        jnp.asarray(x0))
    _assert_close_rel(lp, np.asarray(j_lp))
    _assert_close_rel(score, np.asarray(j_score))
    _assert_close_rel(grad, np.asarray(j_grad))
    assert int(score[0].argmax()) == int(np.asarray(j_score)[0].argmax())
    np.testing.assert_allclose(float(motif_distance(torch.tensor(x0), pos_t, tgt_t)),
                               float(j_twisting.motif_distance(jnp.asarray(x0), jnp.asarray(positions),
                                                               jnp.asarray(target))), rtol=1e-5)


def test_motif_target_and_manifests_equal_jax(tmp_path):
    d = tmp_path / "motifs"
    d.mkdir()
    (d / "0_test.pdb").write_text(MOTIF_TARGET_PDB)
    (d / "1_other.pdb").write_text(MOTIF_TARGET_PDB.replace(": 24", ": 30"))
    for idx in (0, 1):
        segs, length = load_motif_target(idx, str(d))
        j_segs, j_length = j_motif_target.load_motif_target(idx, str(d))
        assert length == j_length and len(segs) == len(j_segs)
        for a, b in zip(segs, j_segs):
            np.testing.assert_array_equal(a, b)
        assert load_motif_target_info(idx, str(d)) == j_motif_target.load_motif_target_info(idx, str(d))
    segs, length = parse_motif_target_pdb(str(d / "0_test.pdb"))
    assert length == 24 and [len(s) for s in segs] == [4, 3]

    placements = [((0, 3), (10, 12)), ((5, 8), (20, 22)), ((14, 17), (18, 20))]
    info = load_motif_target_info(0, str(d))
    for seg_info in (info, None):
        mine, theirs = tmp_path / "mine", tmp_path / "theirs"
        write_benchmark_manifests(str(mine), "0", 24, placements, seg_info)
        j_manifest.write_benchmark_manifests(str(theirs), "0", 24, placements, seg_info)
        for name in ("scaffold_info.csv", "motif_info.csv"):
            assert filecmp.cmp(mine / name, theirs / name, shallow=False)


# ------------------------------------------------------------------ #
# The TDS trajectory against genie2_tpu's tds_sample
# ------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def models():
    flax_model = FlaxDenoiser(remat=False, **DIMS_TDS)
    two = batchify([create_empty_features([L]) for _ in range(2)])
    variables = randomized_variables(flax_model, two, jit=True)
    port = Denoiser(**DIMS_TDS)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return flax_model, variables, port.eval().requires_grad_(False)


def _jax_draws(key, n_steps, n_particles, shape):
    """x_T, the per-step noise and the resampling offsets that genie2_tpu's
    tds_sample draws from `key`: one split for x_T, then three ways every
    step (carry, noise, resampling)."""
    key, init_key = jax.random.split(key)
    init = np.asarray(jax.random.normal(init_key, shape, dtype=jnp.float32))
    noises, offsets = [], []
    for _ in range(n_steps):
        key, noise_key, r_key = jax.random.split(key, 3)
        noises.append(np.asarray(jax.random.normal(noise_key, shape, dtype=jnp.float32)))
        offsets.append(np.asarray(jax.random.uniform(r_key, (), minval=0.0, maxval=1.0 / n_particles)))
    return init, np.stack(noises), np.stack(offsets).astype(np.float32)


def _problem():
    """Two segments of 4 and 3 residues, centred, and every placement in
    a chain of L = 24 (171 of them)."""
    segs = [_helix(4, (4.0, 0.0, 0.0)), _helix(3, (0.0, 5.0, 2.0))]
    target = np.concatenate(segs)
    target = target - target.mean(0, keepdims=True)
    positions = placements_to_positions(enumerate_motif_placements(L, [4, 3]))
    return segs, target, positions


# (proposal, score_grad_cap, twist_rotations, ess_frac, seed, tausq): each
# proposal, the rotation term on and off; the ESS thresholds were chosen so
# that every step's ESS stays clear of them. tausq 1.0 keeps a random
# model's scores near 1e2, so that the comparison below resolves 1e-4 in the
# ESS; the default 0.012 (the posterior proposal, the sampler's ess_frac
# 0.5) takes them to 2e5, where float32 rounding of the log weights alone
# moves the ESS by up to 1.8e-4 (relative) between two summation orders
# (measured over both proposals, with and without rotations), so its ESS is
# held within 1e-3 and everything else as in the other cases.
TDS_CASES = [
    ("posterior", 0.0, False, 0.9, 0, 1.0),
    ("posterior", 0.0, True, 0.2, 1, 1.0),
    ("score", 0.0, True, 0.9, 3, 1.0),
    ("score", 5.0, False, 0.2, 4, 1.0),
    ("posterior", 0.0, False, 0.5, 0, 0.012),
    ("posterior", 0.0, True, 0.5, 1, 0.012),
]
ESS_RTOL = {1.0: 1e-4, 0.012: 1e-3}
_RESAMPLED = {}


@pytest.mark.parametrize("proposal,cap,rotations,ess_frac,seed,tausq", TDS_CASES)
def test_tds_trajectory_matches_jax(models, proposal, cap, rotations, ess_frac, seed, tausq):
    flax_model, variables, port = models
    segs, target, positions = _problem()
    motif_rots = rot_mask = None
    if rotations:
        motif_rots, rot_mask = motif_frame_rotations(segs)
    batch = batchify([create_empty_features([L]) for _ in range(P)])
    key = jax.random.PRNGKey(100 + seed)
    kw = dict(untwist_below=2, tausq=tausq, ess_frac=ess_frac, rot_tausq=0.3, proposal=proposal, score_grad_cap=cap)

    j_trans, j_score, j_trace, _ = j_tds_sample(
        flax_model.apply, variables, JSchedule.create(T), jto_device(batch), jnp.asarray(positions),
        jnp.asarray(target), key, jnp.float32(1.0), T, steps_per_dispatch=None,
        motif_rots=None if motif_rots is None else jnp.asarray(motif_rots),
        rot_mask=None if rot_mask is None else jnp.asarray(rot_mask), **kw)

    init, noises, offsets = _jax_draws(key, T, P, (P, L, 3))
    feats = to_device(batch, "cpu")
    trans, score, trace, _ = tds_sample_injected(
        lambda frames, t: port(frames, t, feats)["z"], Schedule.create(T), feats, torch.from_numpy(positions),
        torch.from_numpy(target), torch.from_numpy(init), torch.from_numpy(noises), torch.from_numpy(offsets),
        1.0, motif_rots=None if motif_rots is None else torch.from_numpy(motif_rots),
        rot_mask=None if rot_mask is None else torch.from_numpy(rot_mask), **kw)

    ess, j_ess = trace.ess.numpy(), np.asarray(j_trace.ess)
    # The threshold test ess < ess_frac P must not sit on a rounding edge.
    assert np.abs(j_ess - ess_frac * P).min() >= 1e-3 * ess_frac * P
    np.testing.assert_array_equal(trace.resampled.numpy(), np.asarray(j_trace.resampled))
    np.testing.assert_array_equal(trace.best_placement.numpy(), np.asarray(j_trace.best_placement))
    np.testing.assert_array_equal(score.numpy().argmax(-1), np.asarray(j_score).argmax(-1))
    np.testing.assert_allclose(ess, j_ess, rtol=ESS_RTOL[tausq])
    # 1e-4, relative where the uncapped score proposal takes coordinates far above 1.
    np.testing.assert_allclose(trans.numpy(), np.asarray(j_trans), atol=1e-4 * max(1.0, np.abs(j_trans).max()))
    _assert_close_rel(score.numpy(), np.asarray(j_score), 1e-4)
    _assert_close_rel(trace.motif_dist.numpy(), np.asarray(j_trace.motif_dist), 1e-4)
    assert np.isfinite(trans.numpy()).all() and trace.ess.shape == (T,)
    _RESAMPLED[(proposal, cap, rotations, tausq)] = bool(np.asarray(j_trace.resampled).any())


def test_tds_cases_cover_resampling_and_none():
    """Run after the trajectory cases (one file runs in one worker, in
    order): at least one of them resampled and at least one never did."""
    if len(_RESAMPLED) != len(TDS_CASES):
        pytest.skip("the trajectory cases did not all run in this process")
    assert any(_RESAMPLED.values()) and not all(_RESAMPLED.values())


def test_tds_sample_is_seeded_and_checks_its_arguments(models):
    _, _, port = models
    segs, target, positions = _problem()
    feats = to_device(batchify([create_empty_features([L]) for _ in range(P)]), "cpu")
    model_fn = lambda frames, t: port(frames, t, feats)["z"]  # noqa: E731
    args = (model_fn, Schedule.create(T), feats, torch.from_numpy(positions), torch.from_numpy(target))
    a = tds_sample(*args, 11, record_every=4)
    b = tds_sample(*args, 11, record_every=4)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert isinstance(a[2], TDSTrace) and sorted(a[3]) == [4, 8]
    assert a[3][8][0].shape == (P, L, 3) and a[3][8][1].shape == (P, L, 3)
    with pytest.raises(ValueError, match="proposal"):
        tds_sample(*args, 11, proposal="mean")
    with pytest.raises(ValueError, match="feature rows"):
        tds_sample_injected(*args, torch.zeros(2, L, 3), torch.zeros(T, 2, L, 3), torch.zeros(T))


def test_tds_first_step_runs_a_part_of_the_trajectory(models):
    """A run from `first_step` T with one step's noise is the full run's
    first step: its translations are the full run's snapshot at step T and
    its trace the full run's first entry."""
    _, _, port = models
    segs, target, positions = _problem()
    feats = to_device(batchify([create_empty_features([L]) for _ in range(P)]), "cpu")
    model_fn = lambda frames, t: port(frames, t, feats)["z"]  # noqa: E731
    rng = np.random.default_rng(5)
    init, noises = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((P, L, 3), (T, P, L, 3)))
    offsets = torch.from_numpy(rng.uniform(0, 1.0 / P, size=T).astype(np.float32))
    args = (model_fn, Schedule.create(T), feats, torch.from_numpy(positions), torch.from_numpy(target), init)
    kw = dict(untwist_below=2, tausq=1.0)
    _, _, full, snaps = tds_sample_injected(*args, noises, offsets, record_every=T, **kw)
    trans, _, part, _ = tds_sample_injected(*args, noises[:1], offsets[:1], first_step=T, **kw)
    torch.testing.assert_close(trans, torch.from_numpy(snaps[T][1]), rtol=0, atol=0)
    for got, want in zip(part, full):
        torch.testing.assert_close(got, want[:1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="steps down from step"):
        tds_sample_injected(*args, noises[:3], offsets[:3], first_step=2, **kw)


# ------------------------------------------------------------------ #
# The CLI
# ------------------------------------------------------------------ #


def _release(tmp_path, port):
    root = tmp_path / "results"
    (root / "tiny" / "checkpoints").mkdir(parents=True)
    (root / "tiny" / "configuration").write_text(CONFIG_TDS)
    ckpt = root / "tiny" / "checkpoints" / "epoch.1.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in port.state_dict().items()}}, ckpt)
    # The CPU gradient runs with `closed` quaternions (see tests/test_torch_grad.py).
    (root / "tiny" / "checkpoints" / "epoch.1.ckpt.meta.json").write_text(json.dumps({"rot_to_quat_method": "closed"}))
    return root


def test_cli_cpu_writes_designs_manifests_trace_and_dumps(models, tmp_path, capsys):
    _, _, port = models
    root = _release(tmp_path, port)
    motifs = tmp_path / "motifs"
    motifs.mkdir()
    (motifs / "0_test.pdb").write_text(MOTIF_TARGET_PDB)
    out = tmp_path / "out"
    result = sample_motif_smc.main([
        "--name", "tiny", "--epoch", "1", "--rootdir", str(root), "--outdir", str(out), "--motif_index", "0",
        "--motif_dir", str(motifs), "--num_particles", "3", "--dump_trajectory_every", "3", "--twist_rotations",
        "--device", "cpu"])
    assert sorted(os.listdir(out / "pdbs")) == ["0_0.pdb", "0_1.pdb", "0_2.pdb"]
    for i in range(3):
        xyz = read_ca_coords(str(out / "pdbs" / f"0_{i}.pdb"))
        assert xyz.shape == (24, 3) and np.isfinite(xyz).all()
    lines = [ln.split("\t") for ln in (out / "motif_location.txt").read_text().strip().split("\n")]
    (s1, e1), (s2, e2) = [(int(a), int(b)) for a, b in lines]
    assert e1 - s1 == 3 and e2 - s2 == 2 and 0 <= s1 and e1 < s2 and e2 < 24
    assert (out / "scaffold_info.csv").read_text().count("\n") == 4
    assert (out / "motif_info.csv").read_text().splitlines()[1].startswith("0,0,")
    records = [json.loads(ln) for ln in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["t"] for r in records] == [6, 5, 4, 3, 2, 1]
    assert all(1.0 - 1e-5 <= r["ess"] <= 3.0 + 1e-5 for r in records)
    for step in (6, 3):
        for tag in ("x0", "xt"):
            assert read_ca_coords(str(out / "test" / f"{tag}_predicted_test_{step}.pdb")).shape == (24, 3)
    assert result["n_placements"] == len(enumerate_motif_placements(24, [4, 3])) == 171
    assert len(result["ess_trace"]) == 6
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("motif 0: placement=((") and "ess(min/mean)=" in line and "resamples=" in line


def test_sampler_leaves_the_callers_model_as_it_was(models, tmp_path):
    """The sampler differentiates through a copy whose parameters need no
    grad: the caller's values and requires_grad flags stay as they were."""
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.sampling import SMCSampler

    _, _, port = models
    root = _release(tmp_path, port)
    model = Denoiser(**dict(DIMS_TDS, n_timestep=6))
    model.load_state_dict(port.state_dict())
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    flags = {k: p.requires_grad for k, p in model.named_parameters()}
    assert all(flags.values())
    motifs = tmp_path / "motifs"
    motifs.mkdir()
    (motifs / "0_test.pdb").write_text(MOTIF_TARGET_PDB)
    sampler = SMCSampler(model, Config(str(root / "tiny" / "configuration")))
    assert sampler.model is not model
    sampler.untwist_below = 2
    sampler.sample({"scale": 1.0, "outdir": str(tmp_path / "out"), "num_samples": 2, "prefix": "0", "offset": 0,
                    "motif_index": 0, "motif_dir": str(motifs)})
    assert {k: p.requires_grad for k, p in model.named_parameters()} == flags
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert all(p.grad is None for p in model.parameters())


def test_cli_without_card_raises_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_motif_smc.main(["--name", "x", "--epoch", "1", "--outdir", str(tmp_path), "--motif_index", "0",
                               "--motif_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="--mesh_seq 2 needs a torchrun launch"):
        sample_motif_smc.main(["--name", "x", "--epoch", "1", "--outdir", str(tmp_path), "--motif_index", "0",
                               "--motif_dir", str(tmp_path), "--mesh_seq", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="torchrun"):
        sample_motif_smc.main(["--name", "x", "--epoch", "1", "--outdir", str(tmp_path), "--motif_index", "0",
                               "--motif_dir", str(tmp_path), "--num_devices", "2", "--device", "cpu"])
