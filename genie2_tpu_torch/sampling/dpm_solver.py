"""DPM-Solver++(2M): deterministic second-order multistep sampling.

Like DDIM this runs a K-step subsequence of the T-step schedule, but each
update uses the current and the previous x0-prediction in a second-order
multistep rule in log-SNR (lambda) time (Lu et al. 2022, data-prediction 2M
variant), at one denoiser call per step.

Update from time s (noisier) to t (cleaner), h = lambda_t - lambda_s:

    first order  : x_t = (sigma_t / sigma_s) x_s - alpha_t (e^{-h} - 1) x0_s
    second order : ... - 0.5 alpha_t (e^{-h} - 1) (x0_s - x0_prev) / r,
                   r = (lambda_s - lambda_prev) / h

The first step (no history) is first order. The last step (t = 0, where
lambda diverges) takes the exact limit x_0 = x0_s.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.geometry import Rigid, frenet_frames
from genie2_tpu_torch.sampling.ddpm import ModelFn, ddim_schedule, init_translations
from genie2_tpu_torch.utils.profiling import span


def _alpha_sigma_lambda(schedule: Schedule, t: int):
    abar = schedule.alphas_cumprod[t]
    alpha = torch.sqrt(abar)
    sigma = torch.sqrt(torch.clamp(1.0 - abar, min=1e-20))
    return alpha, sigma, torch.log(alpha / sigma)


def dpm_solver_sample_injected(model_fn: ModelFn, schedule: Schedule, features, init_trans: torch.Tensor,
                               pairs: np.ndarray):
    """The solver over the (t, t_prev) `pairs` from a supplied x_T. Returns
    (final, trajectory [K, B, N, 3])."""
    mask = features["residue_mask"].float()[..., None]
    trans = init_trans
    prev_x0, prev_lam = None, None
    trajectory = []
    for t, t_prev in pairs.tolist():
        with span("sample_step"):
            t_vec = torch.full((trans.shape[0],), t, dtype=torch.long, device=trans.device)
            rots = frenet_frames(trans, features["chain_index"], features["residue_mask"])
            eps = model_fn(Rigid(rots, trans), t_vec)
            with span("posterior"):
                a_s, s_s, lam_s = _alpha_sigma_lambda(schedule, t)
                x0 = (trans - s_s * eps) / a_s
                if t_prev == 0:
                    stepped = x0  # the h -> inf limit
                else:
                    a_t, s_t, lam_t = _alpha_sigma_lambda(schedule, t_prev)
                    h = lam_t - lam_s
                    em1 = torch.expm1(-h)
                    stepped = (s_t / s_s) * trans - a_t * em1 * x0
                    if prev_x0 is not None:
                        r = (lam_s - prev_lam) / torch.where(h == 0, torch.ones_like(h), h)
                        d1 = (x0 - prev_x0) / torch.where(r == 0, torch.ones_like(r), r)
                        stepped = stepped - 0.5 * a_t * em1 * d1
                trans = stepped * mask
        prev_x0, prev_lam = x0, lam_s
        trajectory.append(trans)
    return trans, torch.stack(trajectory)


def dpm_solver_sample(model_fn: ModelFn, schedule: Schedule, features, seed: int, sample_ids: Sequence[int],
                      n_steps: int, spacing: str = "uniform") -> torch.Tensor:
    """Deterministic DPM-Solver++(2M) over an n_steps subsequence; x_T comes
    from each sample's own stream, as in the other samplers."""
    trans = init_translations(features, seed, sample_ids)
    pairs = ddim_schedule(schedule.n_timestep, n_steps, spacing)
    return dpm_solver_sample_injected(model_fn, schedule, features, trans, pairs)[0]
