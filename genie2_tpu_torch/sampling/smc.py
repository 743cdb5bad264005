"""Twisted Diffusion Sampler (TDS) / SMC motif scaffolding with unknown
motif placement.

Counterpart of genie2_tpu/sampling/smc.py. Particles are the batch axis.
Each reverse step computes the twisting potential log p~(y | x_t) by
marginalising the placed-and-centred x-start prediction over all candidate
motif placements, takes its gradient through the whole denoiser with
respect to x_t (autograd: on the card the kernels' Functions, ops/), caps
it, twists the posterior mean, accumulates importance weights, and
resamples systematically when the effective sample size drops below a
threshold.

The loop is plain Python over t = T..1; resampling is a `where`-selected
gather computed every step, and snapshots stay on the device until the
end, so no step waits for the host. The gradient is taken at the steps
that use it (t >= untwist_below); genie2_tpu's scan computes it at every
step and discards it below, with the same results.

Randomness: particle p draws x_T and its per-step noise from the (seed, p,
step) streams of sampling/ddpm.py, the resampling offsets come from
`resampling_generator(seed)`.

Data parallel (`mesh`): the particles shard over the ranks (a count that
does not divide raises: a padded particle would join the resampling
population). The gradient through the denoiser stays on its rank; the
twist's norms are all-reduced, and each step's proposals, log weights and
monitors are gathered, so every rank computes the same ESS, resampling
decision and indices and takes its selected rows. Placements and
decisions are those of one process; coordinates agree up to the
reduction order of the norms.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import (
    batchify,
    create_empty_features,
    debatchify,
    save_coords_to_pdb,
    save_features_to_pdb,
    to_device,
    to_host,
)
from genie2_tpu_torch.geometry import Rigid, frenet_frames
from genie2_tpu_torch.nn.policy import without_grad
from genie2_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    check_particles,
    data_axis_size,
    gather_rows,
    local_rows,
    shard_batch,
)
from genie2_tpu_torch.sampling.base import BaseSampler
from genie2_tpu_torch.sampling.ddpm import ModelFn, init_translations, trajectory_noise
from genie2_tpu_torch.sampling.manifest import write_benchmark_manifests
from genie2_tpu_torch.sampling.motif_target import load_motif_target, load_motif_target_info
from genie2_tpu_torch.sampling.resampling import (
    ess_from_log_weights,
    normalize_log_weights,
    resampling_draws,
    resampling_generator,
    systematic_resample_indices,
)
from genie2_tpu_torch.sampling.twisting import (
    enumerate_motif_placements,
    motif_distance,
    motif_frame_rotations,
    placements_to_positions,
    twisting_log_prob,
    twisting_log_prob_frames,
    xstart_variance,
)
from genie2_tpu_torch.utils.profiling import host_sync, span

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
PROPOSALS = ("posterior", "score")


def _log_normal(x, mean, var):
    return -0.5 * ((x - mean) ** 2) / var - 0.5 * torch.log(var) - _LOG_SQRT_2PI


def _particle_norm(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The norm of `x` over every particle, this rank's and the others'."""
    if mesh is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(all_reduce_sum(x.square().sum(), mesh))


class TDSTrace(NamedTuple):
    """Per-step monitoring, one entry per reverse step t = T..1."""

    ess: Any  # [T]
    resampled: Any  # [T] bool
    motif_dist: Any  # [T]
    best_placement: Any  # [T] argmax placement of particle 0


def tds_sample_injected(
    model_fn: ModelFn,
    schedule: Schedule,
    features: Dict[str, Any],
    positions: torch.Tensor,
    motif_target: torch.Tensor,
    init_trans: torch.Tensor,
    noises: torch.Tensor,
    offsets: torch.Tensor,
    scale: float = 1.0,
    untwist_below: int = 50,
    grad_alpha: float = 0.012,
    tausq: float = 0.012,
    ess_frac: float = 0.5,
    motif_rots: Optional[torch.Tensor] = None,
    rot_mask: Optional[torch.Tensor] = None,
    rot_tausq: float = 0.1,
    proposal: str = "posterior",
    score_grad_cap: float = 0.0,
    record_every: Optional[int] = None,
    first_step: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor, TDSTrace, Dict[int, Tuple[np.ndarray, np.ndarray]]]:
    """The twisted SMC reverse trajectory from a supplied x_T [P, L, 3],
    supplied per-step noise [T, P, L, 3] (noises[0] is used at step T) and
    resampling offsets [T] in [0, 1/P). With `first_step` the run starts at
    that step instead, init_trans taking the place of x_t there, and takes
    the len(noises) steps from it down (a part of the trajectory, weights
    starting anew). `features` is a batch whose leading
    axis is the particle axis; positions [O, M] is the placement table,
    motif_target [M, 3] the centred motif.

    `proposal` selects where the twisting gradient g (of the sum over
    particles of log p~) enters the proposal mean mu_t:
      "posterior": mu + coef1 g a|g|/(a + |g|), a = grad_alpha, |g| the
          norm over all particles (every rank's);
      "score": mu + (beta/sqrt(alpha)) g/(var P), g taken with the x-start
          variance 1 - abar_t, with the optional soft cap
          |delta| < score_grad_cap.
    With `motif_rots` / `rot_mask` the potential gains the rotation term on
    the Frenet frames of x0. Twisting applies where t >= untwist_below.

    Returns (final translations [P, L, 3], the last step's per-placement
    scores [P, O], TDSTrace of device tensors, snapshots {step: (x0, x_{t-1})
    as numpy arrays} every `record_every` steps).

    With a `mesh`, `features`, `init_trans` and `noises` hold this rank's
    particles (its rows of the P = rows x world size) and the results are
    every particle's, on every rank."""
    if proposal not in PROPOSALS:
        raise ValueError(f"proposal must be 'posterior' or 'score', got {proposal!r}")
    n_local = init_trans.shape[0]
    if features["residue_mask"].shape[0] != n_local:
        raise ValueError(f"{features['residue_mask'].shape[0]} feature rows for {n_local} particles")
    n_particles = n_local * data_axis_size(mesh)
    rows = local_rows(n_particles, mesh)
    device = init_trans.device
    mask = features["residue_mask"].float()[..., None]
    chain_index, residue_mask = features["chain_index"], features["residue_mask"]
    positions = positions.long().to(device)
    motif_target = motif_target.float().to(device)
    if motif_rots is not None:
        motif_rots, rot_mask = motif_rots.float().to(device), rot_mask.float().to(device)
    offsets = offsets.to(device)
    noises = noises.to(device)
    first_step = noises.shape[0] if first_step is None else int(first_step)
    if not noises.shape[0] <= first_step <= schedule.n_timestep:
        raise ValueError(f"{noises.shape[0]} steps down from step {first_step} of {schedule.n_timestep}")
    s = schedule

    def potential(x, t, t_vec, var, rot_var, grad_var):
        """(sum over particles of the log-prob the gradient is taken of, x0,
        log_prob [P], scores [P, O]). `var` is the x-start variance the
        weights use, `grad_var` (score proposal) the one of the gradient."""
        rots = frenet_frames(x, chain_index, residue_mask)
        eps = model_fn(Rigid(rots, x), t_vec)
        x0 = (x - s.sqrt_one_minus_alphas_cumprod[t] * eps) / s.sqrt_alphas_cumprod[t]
        if motif_rots is None:
            def log_prob_at(v):
                return twisting_log_prob(x0, positions, motif_target, v)
        else:
            rots0 = frenet_frames(x0, chain_index, residue_mask)

            def log_prob_at(v):
                return twisting_log_prob_frames(x0, rots0, positions, motif_target, v, motif_rots, rot_mask, rot_var)
        log_prob_g, score_g = log_prob_at(var if grad_var is None else grad_var)
        log_prob, score = (log_prob_g, score_g) if grad_var is None else log_prob_at(var)
        return log_prob_g.sum(), x0, log_prob, score

    trans = init_trans
    log_proposal = (-0.5 * (math.log(2 * math.pi) + trans ** 2)).sum(dim=(1, 2))
    log_w_acc = torch.zeros(n_local, dtype=torch.float32, device=device)
    identity = torch.arange(n_particles, device=device)
    traces: List[Tuple[torch.Tensor, ...]] = []
    snaps: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    score = None
    for i, t in enumerate(range(first_step, first_step - noises.shape[0], -1)):
        t_vec = torch.full((n_local,), t, dtype=torch.long, device=device)
        abar = s.alphas_cumprod[t]
        var, rot_var = xstart_variance(abar, tausq), xstart_variance(abar, rot_tausq)
        grad_var = s.one_minus_alphas_cumprod[t] if proposal == "score" else None
        twisted = t >= untwist_below
        if twisted:
            with span("twist"), torch.enable_grad():
                x = trans.detach().requires_grad_(True)
                target, x0, log_prob, score = potential(x, t, t_vec, var, rot_var, grad_var)
                (grad,) = torch.autograd.grad(target, x)
            x0, log_prob, score = x0.detach(), log_prob.detach(), score.detach()
        else:
            with torch.no_grad():
                _, x0, log_prob, score = potential(trans, t, t_vec, var, rot_var, grad_var)

        with torch.no_grad():
            coef1 = s.sqrt_alphas_cumprod_prev[t] * s.betas[t] / s.one_minus_alphas_cumprod[t]
            coef2 = s.sqrt_alphas[t] * (1.0 - s.alphas_cumprod_prev[t]) / s.one_minus_alphas_cumprod[t]
            mean_untwisted = coef1 * x0 + coef2 * trans
            mean_twisted = mean_untwisted
            if twisted:
                if proposal == "score":
                    delta = (s.betas[t] / s.sqrt_alphas[t]) * (grad / (var * n_particles))
                    if score_grad_cap:
                        delta = delta * (score_grad_cap / (score_grad_cap + _particle_norm(delta, mesh)))
                else:
                    norm = _particle_norm(grad, mesh)
                    delta = coef1 * grad * grad_alpha * norm / (grad_alpha + norm)
                mean_twisted = mean_untwisted + delta

            sigma = s.sqrt_betas[t]
            proposed = (mean_twisted + scale * sigma * noises[i]) * mask

            # Importance weights.
            sigmasq = sigma ** 2
            log_reverse = _log_normal(proposed, mean_untwisted, sigmasq).sum(dim=(1, 2))
            log_twisted = _log_normal(proposed, mean_twisted, sigmasq).sum(dim=(1, 2))
            log_w_new = log_reverse + log_prob - log_twisted - log_proposal + log_w_acc

            # The resampling population is every rank's particles.
            proposed_all, log_prob_all, log_w_all, x0_all, best_all = gather_rows(
                mesh, proposed, log_prob, log_w_new, x0, torch.argmax(score, dim=1))
            with span("resample"):
                ess = ess_from_log_weights(log_w_all)
                do_resample = ess < ess_frac * n_particles
                idx = systematic_resample_indices(torch.softmax(log_w_all, dim=0), offsets[i])
                sel = torch.where(do_resample, idx, identity)[rows]
            if t > 1:
                trans = proposed_all[sel]
                log_proposal = log_prob_all[sel]
                log_w_acc = torch.where(do_resample, torch.zeros_like(log_w_all),
                                        normalize_log_weights(log_w_all) + math.log(float(n_particles)))[rows]
            else:  # the last step takes the twisted mean and leaves the weights as they are
                trans = mean_twisted
            traces.append((ess, do_resample & (t > 1), motif_distance(x0_all, positions, motif_target), best_all[0]))
            if record_every and t % record_every == 0:
                snaps[t] = (x0_all, gather_rows(mesh, trans)[0])
    trace = TDSTrace(*(torch.stack(parts) for parts in zip(*traces)))
    for x0, _ in snaps.values():
        host_sync("tds_snapshots", x0, 2)
    snapshots = {t: (x0.cpu().numpy(), xt.cpu().numpy()) for t, (x0, xt) in snaps.items()}
    trans, score = gather_rows(mesh, trans, score)
    return trans, score, trace, snapshots


def tds_sample(
    model_fn: ModelFn,
    schedule: Schedule,
    features: Dict[str, Any],
    positions: torch.Tensor,
    motif_target: torch.Tensor,
    seed: int,
    scale: float = 1.0,
    mesh: Optional[Mesh] = None,
    **kwargs,
):
    """The twisted SMC trajectory over the schedule's T steps, with x_T and
    each step's noise from the (seed, particle, step) streams and the
    resampling offsets from `resampling_generator(seed)`. With a mesh,
    `features` holds this rank's particles. Keyword arguments and the
    result as `tds_sample_injected`."""
    n_particles = features["residue_mask"].shape[0] * data_axis_size(mesh)
    rows = local_rows(n_particles, mesh)
    ids = list(range(rows.start, rows.stop))
    trans = init_translations(features, seed, ids)
    noises = trajectory_noise(seed, ids, schedule.n_timestep, trans.shape[1])
    offsets = resampling_draws("systematic", n_particles, resampling_generator(seed), steps=schedule.n_timestep)
    return tds_sample_injected(model_fn, schedule, features, positions, motif_target, trans, noises, offsets,
                               scale, mesh=mesh, **kwargs)


class SMCSampler(BaseSampler):
    """Host orchestration: load a MotifBench problem, enumerate placements,
    run the TDS loop, save the designs, the inferred motif placement
    (`motif_location.txt`), the benchmark manifests and, with
    `dump_trajectory_every`, x0 / x_t snapshots of particle 0.

    Particles are real rows (no bucket padding: a padded particle would
    join the resampling population). The model is evaluated through a copy
    whose parameters do not require grad where the caller's do
    (`nn/policy.py:without_grad`), so the gradient with respect to x_t
    computes no weight gradients and the caller's model stays as it is.

    Optional sampling parameters: `seed`, `twist_rotations`, `rot_tausq`,
    `proposal`, `score_grad_cap`. With a mesh the particles shard over the
    ranks: a count the world size does not divide raises."""

    def setup(self):
        self.add_required_parameter("motif_index")
        self.add_required_parameter("motif_dir")
        self.max_offsets = 1000
        self.untwist_below = 50
        # Set to e.g. 50 to dump x0 / x_t PDB snapshots every 50 steps.
        self.dump_trajectory_every = None
        self._rng = np.random.default_rng(0)
        self.model = without_grad(self.model)

    def on_sample_start(self, params: Dict[str, Any]):
        os.makedirs(os.path.join(params["outdir"], "pdbs"), exist_ok=True)

    def create_np_features(self, params: Dict[str, Any]):
        return create_empty_features([params["length"]])

    def _sample(self, params: Dict[str, Any]):
        seed = int(params.get("seed", 0)) + int(params["offset"])
        segments, protein_length = load_motif_target(params["motif_index"], params["motif_dir"])
        params["length"] = protein_length
        motif_target = torch.from_numpy(np.concatenate(segments, axis=0))

        motif_rots = rot_mask = None
        if params.get("twist_rotations"):
            rots_np, mask_np = motif_frame_rotations(segments)
            motif_rots, rot_mask = torch.from_numpy(rots_np), torch.from_numpy(mask_np)

        placements = enumerate_motif_placements(
            protein_length, [len(s) for s in segments], max_offsets=self.max_offsets, rng=self._rng)
        self.placements = placements
        positions = torch.from_numpy(placements_to_positions(placements))

        check_particles(params["num_samples"], self.mesh)
        batch = batchify(self.create_np_features_batch(params))
        features = to_device(shard_batch(batch, self.mesh), self.device)
        with torch.no_grad():  # the static pair bias, outside any graph
            model_fn = self.make_model_fn(features)
        trans, final_score, trace, snapshots = tds_sample(
            model_fn, self.schedule, features, positions, motif_target, seed, float(params["scale"]),
            untwist_below=self.untwist_below, record_every=self.dump_trajectory_every, motif_rots=motif_rots,
            rot_mask=rot_mask, rot_tausq=float(params.get("rot_tausq") or 0.1),
            proposal=params.get("proposal") or "posterior",
            score_grad_cap=float(params.get("score_grad_cap") or 0.0), mesh=self.mesh,
        )

        host_sync("tds_trace", final_score, len(trace))
        self.trace = TDSTrace(*(t.cpu().numpy() for t in trace))
        self.snapshots = snapshots
        host_sync("tds_score", final_score)
        score_np = final_score.cpu().numpy()
        # Per-particle inferred placements (sample i = particle i); particle
        # 0's is the one written to motif_location.txt.
        self.final_placements = [placements[int(score_np[p].argmax())] for p in range(score_np.shape[0])]
        self.final_placement = self.final_placements[0]
        self._protein_length = protein_length
        self._seg_info = load_motif_target_info(params["motif_index"], params["motif_dir"])

        out = to_device(batch, "cpu")
        out["atom_positions"] = trans
        host_sync("tds_output", trans)
        return debatchify(to_host(out))

    def on_sample_end(self, params: Dict[str, Any], list_np_features: List[Dict]):
        for i, np_features in enumerate(list_np_features):
            name = f"{params['prefix']}_{params['offset'] + i}"
            save_features_to_pdb(np_features, os.path.join(params["outdir"], "pdbs", f"{name}.pdb"))
        with open(os.path.join(params["outdir"], "motif_location.txt"), "w") as f:
            for start, end in self.final_placement:
                f.write(f"{start}\t{end}\n")
        write_benchmark_manifests(
            params["outdir"], pdb_name=params["prefix"], length=self._protein_length,
            placements=self.final_placements[: len(list_np_features)], seg_info=self._seg_info,
        )
        if self.snapshots:
            dump_dir = os.path.join(params["outdir"], "test")
            os.makedirs(dump_dir, exist_ok=True)
            for step, (x0, xt) in sorted(self.snapshots.items()):
                for tag, arr in (("x0", x0), ("xt", xt)):
                    save_coords_to_pdb(np.asarray(arr[0][: self._protein_length]),
                                       os.path.join(dump_dir, f"{tag}_predicted_test_{step}.pdb"))
