"""Variance schedule and DDPM coefficient tables.

All tables have length n_timestep + 1 and are indexed by the one-based
diffusion step t (index 0 is the un-noised stage, beta_0 = 0). They are
derived in numpy float32, op for op as the reference does, and held as
float32 tensors on one device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def cosine_beta_schedule(n_timestep: int) -> np.ndarray:
    """Nichol-Dhariwal cosine schedule; length n_timestep + 1 with
    beta_0 = 0, betas clipped to 0.999."""
    steps = n_timestep + 1
    x = np.linspace(0, n_timestep, steps, dtype=np.float32)
    alphas_cumprod = np.cos((x / np.float32(steps)) * np.float32(math.pi * 0.5)) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = np.float32(1) - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.concatenate([np.zeros(1, np.float32), np.clip(betas, 0, 0.999).astype(np.float32)])


def get_betas(n_timestep: int, schedule: str) -> np.ndarray:
    if schedule == "cosine":
        return cosine_beta_schedule(n_timestep)
    raise ValueError(f"Invalid schedule: {schedule}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """All derived coefficient tables, each a float32 tensor [n_timestep + 1]."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    one_minus_alphas_cumprod: torch.Tensor
    sqrt_betas: torch.Tensor
    sqrt_alphas: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod_prev: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    posterior_variance: torch.Tensor

    @property
    def n_timestep(self) -> int:
        return self.betas.shape[0] - 1

    @staticmethod
    def create(n_timestep: int, schedule: str = "cosine", device="cpu") -> "Schedule":
        betas = get_betas(n_timestep, schedule).astype(np.float32)
        alphas = np.float32(1.0) - betas
        alphas_cumprod = np.cumprod(alphas, dtype=np.float32)
        alphas_cumprod_prev = np.concatenate([np.ones(1, np.float32), alphas_cumprod[:-1]])
        one_minus = np.float32(1.0) - alphas_cumprod

        def t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

        with np.errstate(divide="ignore", invalid="ignore"):
            # Index 0 of the posterior coefficients is 0/0 (betas[0] = 0,
            # 1 - alphas_cumprod[0] = 0); it is never read (t >= 1).
            pmc1 = np.where(one_minus > 0, betas * alphas_cumprod_prev / one_minus, 0.0)
            pmc2 = np.where(
                one_minus > 0, np.sqrt(alphas) * (1.0 - alphas_cumprod_prev) / one_minus, 0.0
            )
            pvar = np.where(one_minus > 0, betas * (1.0 - alphas_cumprod_prev) / one_minus, 0.0)

        return Schedule(
            betas=t(betas),
            alphas=t(alphas),
            alphas_cumprod=t(alphas_cumprod),
            alphas_cumprod_prev=t(alphas_cumprod_prev),
            one_minus_alphas_cumprod=t(one_minus),
            sqrt_betas=t(np.sqrt(betas)),
            sqrt_alphas=t(np.sqrt(alphas)),
            sqrt_alphas_cumprod=t(np.sqrt(alphas_cumprod)),
            sqrt_alphas_cumprod_prev=t(np.sqrt(alphas_cumprod_prev)),
            sqrt_one_minus_alphas_cumprod=t(np.sqrt(one_minus)),
            sqrt_one_minus_alphas_cumprod_prev=t(np.sqrt(1.0 - alphas_cumprod_prev)),
            sqrt_recip_alphas_cumprod=t(1.0 / np.sqrt(alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=t(np.sqrt(1.0 / alphas_cumprod - 1.0)),
            posterior_mean_coef1=t(pmc1),
            posterior_mean_coef2=t(pmc2),
            posterior_variance=t(pvar),
        )


def q_sample(schedule: Schedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor):
    """Forward noising x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps;
    t [B] one-based steps, x0/noise [B, N, 3]."""
    a = schedule.sqrt_alphas_cumprod[t][:, None, None]
    b = schedule.sqrt_one_minus_alphas_cumprod[t][:, None, None]
    return a * x0 + b * noise


def posterior_mean_from_eps(schedule: Schedule, xt: torch.Tensor, t: torch.Tensor, eps: torch.Tensor):
    """mu_t = 1/sqrt(a_t) (x_t - (1 - a_t)/sqrt(1 - abar_t) eps)."""
    w_z = (1.0 - schedule.alphas[t]) / schedule.sqrt_one_minus_alphas_cumprod[t]
    return (1.0 / schedule.sqrt_alphas[t])[:, None, None] * (xt - w_z[:, None, None] * eps)


def x0_from_eps(schedule: Schedule, xt: torch.Tensor, t: torch.Tensor, eps: torch.Tensor):
    """E[x_0 | x_t] from the predicted noise."""
    return (
        xt - schedule.sqrt_one_minus_alphas_cumprod[t][:, None, None] * eps
    ) / schedule.sqrt_alphas_cumprod[t][:, None, None]


def ddim_step_from_eps(schedule: Schedule, xt: torch.Tensor, t: torch.Tensor, t_prev: torch.Tensor,
                       eps: torch.Tensor, noise: torch.Tensor, eta):
    """One DDIM update x_t -> x_{t_prev} (Song et al. 2021, eq. 12) for any
    step subsequence t > t_prev >= 0. Index 0 of the tables is the clean
    state (abar_0 = 1), so t_prev = 0 lands on x_0 with no injected noise
    for any eta. eta = 0 is the deterministic ODE; eta = 1 recovers the
    DDPM posterior variance on the full step sequence."""
    abar_t = schedule.alphas_cumprod[t][:, None, None]
    abar_p = schedule.alphas_cumprod[t_prev][:, None, None]
    x0 = x0_from_eps(schedule, xt, t, eps)
    sigma = eta * torch.sqrt((1.0 - abar_p) / (1.0 - abar_t)) * torch.sqrt(1.0 - abar_t / abar_p)
    dir_xt = torch.sqrt(torch.clamp(1.0 - abar_p - sigma**2, min=0.0)) * eps
    return torch.sqrt(abar_p) * x0 + dir_xt + sigma * noise


def posterior_mean_from_x0(schedule: Schedule, xt: torch.Tensor, t: torch.Tensor, x0: torch.Tensor):
    """mu_t = coef1 x_0 + coef2 x_t with coef1 = sqrt(abar_{t-1}) beta_t /
    (1 - abar_t) and coef2 = sqrt(a_t) (1 - abar_{t-1}) / (1 - abar_t)."""
    coef1 = (
        schedule.sqrt_alphas_cumprod_prev[t] * schedule.betas[t] / schedule.one_minus_alphas_cumprod[t]
    )[:, None, None]
    coef2 = (
        schedule.sqrt_alphas[t] * (1.0 - schedule.alphas_cumprod_prev[t]) / schedule.one_minus_alphas_cumprod[t]
    )[:, None, None]
    return coef1 * x0 + coef2 * xt
