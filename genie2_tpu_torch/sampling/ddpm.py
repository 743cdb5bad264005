"""The ancestral DDPM reverse loop and the accelerated DDIM loop.

Each reverse step recomputes the Frenet frames from the current
translations, calls the denoiser, and takes the posterior mean plus scaled
noise (no noise at t == 1). Noise is drawn per (seed, sample_id, step) from
its own seeded generator, so a sample's trajectory depends only on its
seed, its id and the padded length, never on which other samples share
its batch. Step index 0 is the draw of x_T; reverse steps use t in 1..T.
A DDIM step from t draws from the same stream t. The loops are plain Python
under the caller's `torch.inference_mode()`: PyTorch runs eagerly, so the
scan segments of the JAX package have no counterpart here.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from genie2_tpu_torch.diffusion import Schedule, ddim_step_from_eps, posterior_mean_from_eps
from genie2_tpu_torch.geometry import Rigid, frenet_frames
from genie2_tpu_torch.utils.profiling import host_sync, span, spanned

# model_fn(frames, timesteps [B]) -> predicted noise z [B, N, 3] (float32)
ModelFn = Callable[[Rigid, torch.Tensor], torch.Tensor]


def stream_seed(seed: int, sample_id: int, step: int) -> int:
    """The seed of one (seed, sample_id, step) noise stream. A negative id
    (a row that only pads a batch to a multiple of the ranks) is taken
    modulo 2^64, as SeedSequence takes no negative entropy."""
    state = np.random.SeedSequence([int(seed), int(sample_id) % 2**64, int(step)]).generate_state(1, np.uint64)
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


@spanned("sample_step")
def reverse_step(model_fn: ModelFn, schedule: Schedule, features, trans: torch.Tensor, t: int,
                 noise: torch.Tensor, scale: float) -> torch.Tensor:
    """One reverse-diffusion step x_t -> x_{t-1}; `noise` is ignored at t == 1."""
    mask = features["residue_mask"].to(trans.dtype)[..., None]
    t_vec = torch.full((trans.shape[0],), t, dtype=torch.long, device=trans.device)
    rots = frenet_frames(trans, features["chain_index"], features["residue_mask"])
    z_pred = model_fn(Rigid(rots, trans), t_vec)
    with span("posterior"):
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


def ancestral_sample_with_trajectory(model_fn: ModelFn, schedule: Schedule, features, seed: int,
                                     sample_ids: Sequence[int], scale: float, record_every: int = 50
                                     ) -> Tuple[torch.Tensor, np.ndarray, List[int]]:
    """`ancestral_sample` that also keeps x_{t-1} after every step t with
    t % record_every == 0. Returns (final, snapshots [K, B, N, 3] on the
    host, their steps)."""
    trans = init_translations(features, seed, sample_ids)
    noises = trajectory_noise(seed, sample_ids, schedule.n_timestep, trans.shape[1]).to(trans.device)
    snaps, snap_steps = [], []
    for i, t in enumerate(range(schedule.n_timestep, 0, -1)):
        trans = reverse_step(model_fn, schedule, features, trans, t, noises[i], scale)
        if t % record_every == 0:
            host_sync("trajectory_snapshot", trans)
            snaps.append(trans.cpu().numpy())
            snap_steps.append(t)
    return trans, (np.stack(snaps) if snaps else np.zeros((0,))), snap_steps


def ddim_schedule(n_timestep: int, n_steps: int, spacing: str = "uniform") -> np.ndarray:
    """[K, 2] (t, t_prev) pairs starting at T (the first model call must see
    x_T at its true noise level) and ending at t_prev = 0, the clean state.
    "uniform" is the standard DDIM subsequence; "sqrt" puts more steps at
    high t (t_i ~ T sqrt(i / K))."""
    if not 1 <= n_steps <= n_timestep:
        raise ValueError(f"sampler steps {n_steps} not in [1, {n_timestep}]")
    u = np.linspace(1.0, 0.0, n_steps, endpoint=False)[::-1]  # (0, 1]
    if spacing == "uniform":
        raw = n_timestep * u
    elif spacing == "sqrt":
        raw = n_timestep * np.sqrt(u)
    else:
        raise ValueError(f"unknown spacing {spacing!r} (uniform|sqrt)")
    # Rounding can make neighbouring steps collide; each collided step is
    # moved down by one, so there are always n_steps model calls. Valid
    # because n_steps <= n_timestep and raw starts at T: ts[i] >= T - i >= 1.
    raw_desc = np.clip(raw[::-1].round().astype(np.int64), 1, n_timestep)
    ts = np.empty(n_steps, dtype=np.int64)
    prev = n_timestep + 1
    for i, r in enumerate(raw_desc):
        ts[i] = min(int(r), prev - 1)
        prev = ts[i]
    return np.stack([ts, np.concatenate([ts[1:], [0]])], axis=1)


def eta_schedule_below(n_timestep: int, n_steps: int, switch_t: int, eta_low: float = 1.0,
                       eta_high: float = 0.0, spacing: str = "uniform") -> np.ndarray:
    """Per-step eta [n_steps] for `ddim_sample`: eta_high while t > switch_t,
    eta_low at or below it. The default runs the deterministic ODE through
    the high-noise steps and injects noise again on the last ones."""
    ts = ddim_schedule(n_timestep, n_steps, spacing)[:, 0]
    return np.where(ts <= switch_t, eta_low, eta_high).astype(np.float32)


def ddim_sample_injected(model_fn: ModelFn, schedule: Schedule, features, init_trans: torch.Tensor,
                         noises: torch.Tensor, pairs: np.ndarray, etas: Sequence[float], scale: float):
    """DDIM over the (t, t_prev) `pairs` from a supplied x_T with supplied
    noise [K, B, N, 3] (noises[i] is used by pairs[i]) and one eta per
    step. Returns (final, trajectory [K, B, N, 3])."""
    mask = features["residue_mask"].to(init_trans.dtype)[..., None]
    trans = init_trans
    trajectory = []
    for (t, t_prev), eta, noise in zip(pairs.tolist(), etas, noises):
        with span("sample_step"):
            t_vec = torch.full((trans.shape[0],), t, dtype=torch.long, device=trans.device)
            tp_vec = torch.full_like(t_vec, t_prev)
            rots = frenet_frames(trans, features["chain_index"], features["residue_mask"])
            eps = model_fn(Rigid(rots, trans), t_vec)
            # The noise scale applies to the injected noise as in the ancestral
            # loop; at eta = 0 nothing is injected.
            with span("posterior"):
                trans = ddim_step_from_eps(schedule, trans, t_vec, tp_vec, eps, noise * scale, float(eta)) * mask
        trajectory.append(trans)
    return trans, torch.stack(trajectory)


def ddim_sample(model_fn: ModelFn, schedule: Schedule, features, seed: int, sample_ids: Sequence[int],
                n_steps: int, eta: Union[float, Sequence[float]] = 0.0, scale: float = 1.0,
                spacing: str = "uniform") -> torch.Tensor:
    """Accelerated DDIM sampling over an n_steps subsequence of the T-step
    schedule. `eta` is a scalar or one value per model call, aligned with
    the descending steps (`eta_schedule_below` makes the hybrid one).
    Noise comes from the per-(seed, sample id, t) streams of the ancestral
    loop, so a sample does not depend on its batch."""
    trans = init_translations(features, seed, sample_ids)
    pairs = ddim_schedule(schedule.n_timestep, n_steps, spacing)
    etas = np.broadcast_to(np.asarray(eta, np.float32).reshape(-1), (len(pairs),))
    noises = torch.stack([step_noise(seed, sample_ids, t, trans.shape[1]) for t in pairs[:, 0].tolist()])
    return ddim_sample_injected(model_fn, schedule, features, trans, noises.to(trans.device), pairs, etas, scale)[0]
