"""The ancestral DDPM reverse loop.

Each reverse step recomputes the Frenet frames from the current
translations, calls the denoiser, and takes the posterior mean plus scaled
noise (no noise at t == 1). Noise is drawn per (seed, sample_id, step) from
its own seeded generator, so a sample's trajectory depends only on its
seed, its id and the padded length, never on which other samples share
its batch. Step index 0 is the draw of x_T; reverse steps use t in 1..T.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from genie2_tpu_torch.diffusion import Schedule, posterior_mean_from_eps
from genie2_tpu_torch.geometry import Rigid, frenet_frames

# model_fn(frames, timesteps [B]) -> predicted noise z [B, N, 3] (float32)
ModelFn = Callable[[Rigid, torch.Tensor], torch.Tensor]


def stream_seed(seed: int, sample_id: int, step: int) -> int:
    """The seed of one (seed, sample_id, step) noise stream."""
    state = np.random.SeedSequence([int(seed), int(sample_id), int(step)]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def step_noise(seed: int, sample_ids: Sequence[int], step: int, n_res: int) -> torch.Tensor:
    """[B, n_res, 3] standard normal noise on the CPU, one stream per sample."""
    out = []
    for sid in sample_ids:
        gen = torch.Generator().manual_seed(stream_seed(seed, sid, step))
        out.append(torch.randn((n_res, 3), generator=gen))
    return torch.stack(out)


def trajectory_noise(seed: int, sample_ids: Sequence[int], n_timestep: int, n_res: int) -> torch.Tensor:
    """[T, B, n_res, 3] noise for steps T..1 (index 0 is step T)."""
    return torch.stack([step_noise(seed, sample_ids, t, n_res) for t in range(n_timestep, 0, -1)])


def reverse_step(model_fn: ModelFn, schedule: Schedule, features, trans: torch.Tensor, t: int,
                 noise: torch.Tensor, scale: float) -> torch.Tensor:
    """One reverse-diffusion step x_t -> x_{t-1}; `noise` is ignored at t == 1."""
    mask = features["residue_mask"].to(trans.dtype)[..., None]
    t_vec = torch.full((trans.shape[0],), t, dtype=torch.long, device=trans.device)
    rots = frenet_frames(trans, features["chain_index"], features["residue_mask"])
    z_pred = model_fn(Rigid(rots, trans), t_vec)
    mean = posterior_mean_from_eps(schedule, trans, t_vec, z_pred) * mask
    if t > 1:
        sigma = schedule.sqrt_betas[t_vec][:, None, None]
        return mean + scale * sigma * noise * mask
    return mean


def init_translations(features, seed: int, sample_ids: Sequence[int]) -> torch.Tensor:
    """x_T ~ N(0, I) from each sample's step-0 stream, masked."""
    mask = features["residue_mask"].float()[..., None]
    noise = step_noise(seed, sample_ids, 0, mask.shape[1]).to(mask.device)
    return noise * mask


def ancestral_sample(model_fn: ModelFn, schedule: Schedule, features, seed: int,
                     sample_ids: Sequence[int], scale: float) -> torch.Tensor:
    """The full reverse trajectory from x_T; returns final translations [B, N, 3]."""
    trans = init_translations(features, seed, sample_ids)
    # All steps' noise is drawn up front and moved to the card once, so the
    # loop enqueues work without waiting on host-to-device copies.
    noises = trajectory_noise(seed, sample_ids, schedule.n_timestep, trans.shape[1]).to(trans.device)
    for i, t in enumerate(range(schedule.n_timestep, 0, -1)):
        trans = reverse_step(model_fn, schedule, features, trans, t, noises[i], scale)
    return trans


def ancestral_sample_injected(model_fn: ModelFn, schedule: Schedule, features, init_trans: torch.Tensor,
                              noises: torch.Tensor, scale: float):
    """Reverse trajectory with supplied x_T and per-step noise [T, B, N, 3]
    (noises[0] is used at step T). Returns (final, trajectory [T, B, N, 3]);
    the fixed-noise harness for comparing with genie2_tpu."""
    trans = init_trans
    trajectory = []
    for i, t in enumerate(range(noises.shape[0], 0, -1)):
        trans = reverse_step(model_fn, schedule, features, trans, t, noises[i], scale)
        trajectory.append(trans)
    return trans, torch.stack(trajectory)
