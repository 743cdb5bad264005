"""Particle-filter utilities: effective sample size and resampling schemes.

Counterparts of genie2_tpu/sampling/resampling.py. Each scheme is an
inverse-CDF lookup (`torch.searchsorted` on the cumulative weights) of
points built from uniform numbers that the caller passes in:
`resampling_draws` makes them from an explicit `torch.Generator`, and a
test hands both packages the same ones. Everything stays on the weights'
device and nothing synchronises with the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def normalize_log_weights(log_w: torch.Tensor, dim: int = 0) -> torch.Tensor:
    log_w = log_w - log_w.amax(dim=dim, keepdim=True)
    return log_w - torch.logsumexp(log_w, dim=dim, keepdim=True)


def ess_from_log_weights(log_w: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """ESS = (sum w)^2 / sum w^2 of the normalized weights."""
    w = torch.exp(normalize_log_weights(log_w, dim=dim))
    return w.sum(dim) ** 2 / (w ** 2).sum(dim)


def _inverse_cdf(weights: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    n = weights.shape[0]
    cumsum = torch.cumsum(weights / weights.sum(), dim=0)
    return torch.searchsorted(cumsum, points.to(cumsum), right=False).clamp(0, n - 1)


def _comb(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=like.device) / n


def systematic_resample_indices(weights: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Systematic resampling: one uniform `offset` in [0, 1/N), comb points
    offset + i/N."""
    return _inverse_cdf(weights, offset + _comb(weights.shape[0], weights))


def stratified_resample_indices(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stratified resampling: one uniform u[i] in [0, 1) per stratum."""
    n = weights.shape[0]
    return _inverse_cdf(weights, u.to(weights) / n + _comb(n, weights))


def multinomial_resample_indices(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """N independent draws from the weights, by inverse CDF at the points
    (1 - u[i]) for uniforms u in [0, 1)."""
    n = weights.shape[0]
    cumsum = torch.cumsum(weights / weights.sum(), dim=0)
    return torch.searchsorted(cumsum, cumsum[-1] * (1 - u.to(cumsum)), right=False).clamp(0, n - 1)


RESAMPLERS = {
    "systematic": systematic_resample_indices,
    "stratified": stratified_resample_indices,
    "multinomial": multinomial_resample_indices,
}


def resampling_generator(seed: int) -> torch.Generator:
    """The stream of a run's resampling draws: seeded from `seed` under its
    own spawn key, so it shares nothing with the per-(seed, sample, step)
    noise streams of sampling/ddpm.py."""
    state = np.random.SeedSequence([int(seed)], spawn_key=(1,)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2**63 - 1))


def resampling_draws(scheme: str, n: int, generator: torch.Generator, steps: Optional[int] = None) -> torch.Tensor:
    """The uniform numbers `RESAMPLERS[scheme]` takes for n particles, on
    the CPU: an offset in [0, 1/n) for "systematic", n uniforms in [0, 1)
    otherwise. With `steps`, that many draws stacked on a leading axis."""
    if scheme not in RESAMPLERS:
        raise ValueError(f"unknown resampling scheme {scheme!r} ({'|'.join(RESAMPLERS)})")
    lead = () if steps is None else (steps,)
    if scheme == "systematic":
        return torch.rand(lead, generator=generator) / n
    return torch.rand((*lead, n), generator=generator)
