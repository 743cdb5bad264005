"""Secondary-structure-guided SMC sampling.

Counterpart of genie2_tpu/sampling/sse_guided.py: a differentiable soft
SSE statistic on the C-alpha trace is the potential G of the Feynman-Kac
particle filter (sampling/feynman_kac.py), the DDPM reverse step
(sampling/ddpm.py:reverse_step) its proposal M. The per-step potential is
the tempered increment

    log G_t = strength * (h(x_t) - h(x_{t+1}))

which telescopes over the trajectory to exp(strength * h(x_0)): the filter
tilts the sampler toward structures with the requested SSE content, and
resampling triggered by the effective sample size keeps the population
healthy. No gradient through the model is needed; the whole loop runs under
`torch.inference_mode()`.

The soft statistics use the canonical CA-geometry signatures (P-SEA
thresholds, Labesse et al. 1997, the criteria features/secstruct.py applies
as hard cut-offs): alpha helix d(i,i+3) ~ 5.3 A / d(i,i+4) ~ 6.2 A;
extended strand d(i,i+3) ~ 9.9 A / d(i,i+4) ~ 13.1 A.

Randomness: particle p draws its x_T and its per-step noise from the
(seed, p, step) streams of sampling/ddpm.py, the resampling offsets come
from `resampling_generator(seed)`. With a mesh each rank runs its rows of
the particles (the filter's contract, sampling/feynman_kac.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.parallel.mesh import Mesh, data_axis_size, local_rows
from genie2_tpu_torch.sampling.ddpm import ModelFn, init_translations, reverse_step, trajectory_noise
from genie2_tpu_torch.sampling.feynman_kac import FKResult, smc_feynman_kac_injected
from genie2_tpu_torch.sampling.resampling import resampling_draws, resampling_generator

# (d3 center, d4 center, gaussian width) per SSE class, in Angstrom.
_SSE_SIGNATURES = {
    "helix": (5.3, 6.2, 1.0),
    "strand": (9.9, 13.1, 1.5),
}


def soft_sse_fraction(trans: torch.Tensor, mask: torch.Tensor, target: str = "helix") -> torch.Tensor:
    """Differentiable fraction of 5-residue windows matching an SSE class.
    trans [..., N, 3] CA coordinates, mask [..., N] -> [...] in [0, 1]."""
    d3_c, d4_c, width = _SSE_SIGNATURES[target]
    d3 = torch.linalg.norm(trans[..., 3:, :] - trans[..., :-3, :], dim=-1)
    d4 = torch.linalg.norm(trans[..., 4:, :] - trans[..., :-4, :], dim=-1)
    s = torch.exp(-(((d3[..., :-1] - d3_c) / width) ** 2)) * torch.exp(-(((d4 - d4_c) / width) ** 2))
    m = mask.to(trans.dtype)
    # A window starting at i needs residues i..i+4 all real.
    wmask = m[..., :-4] * m[..., 1:-3] * m[..., 2:-2] * m[..., 3:-1] * m[..., 4:]
    return (s * wmask).sum(-1) / wmask.sum(-1).clamp_min(1.0)


@torch.inference_mode()
def sse_guided_sample_injected(model_fn: ModelFn, schedule: Schedule, features: Dict[str, Any],
                               init_trans: torch.Tensor, noises: torch.Tensor, offsets: torch.Tensor,
                               target: str = "helix", strength: float = 20.0, scale: float = 0.6,
                               ess_threshold: float = 0.5, mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, FKResult]:
    """The guided filter from a supplied x_T [P, N, 3] with supplied
    per-step noise [T, P, N, 3] (noises[0] is used at step T; masked here)
    and resampling offsets [T]. `features` is a batch whose leading axis is
    the particle axis. Returns (final translations [P, N, 3], FKResult).
    With a mesh, `features`, `init_trans` and `noises` hold this rank's
    rows and the results every particle."""
    n_local = init_trans.shape[0]
    if features["residue_mask"].shape[0] != n_local:
        raise ValueError(f"{features['residue_mask'].shape[0]} feature rows for {n_local} particles")
    mask = features["residue_mask"]
    fmask = mask.float()[..., None]

    def M(noise, particles, extra, t):
        return reverse_step(model_fn, schedule, features, particles, t, noise * fmask, scale), None

    def G(new_particles, old_particles, extra, t):
        return strength * (soft_sse_fraction(new_particles, mask, target) - soft_sse_fraction(old_particles, mask, target))

    result = smc_feynman_kac_injected(M, G, init_trans, None, noises, offsets, n_local * data_axis_size(mesh),
                                      ess_threshold, mesh)
    return result.particles, result


def sse_guided_sample(model_fn: ModelFn, schedule: Schedule, features: Dict[str, Any], seed: int,
                      n_particles: int, target: str = "helix", strength: float = 20.0, scale: float = 0.6,
                      ess_threshold: float = 0.5, mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, FKResult]:
    """SSE-guided generation: `n_particles` particles of one design target
    (the same features replicated per particle) through the DDPM reverse
    process, reweighted toward the requested SSE class. With a mesh,
    `features` holds this rank's rows of the particles."""
    rows = local_rows(n_particles, mesh)
    ids = list(range(rows.start, rows.stop))
    trans = init_translations(features, seed, ids)
    # All noise is drawn up front and moved to the device once, as in the
    # ancestral loop.
    noises = trajectory_noise(seed, ids, schedule.n_timestep, trans.shape[1]).to(trans.device)
    offsets = resampling_draws("systematic", n_particles, resampling_generator(seed), steps=schedule.n_timestep)
    return sse_guided_sample_injected(model_fn, schedule, features, trans, noises, offsets, target, strength,
                                      scale, ess_threshold, mesh)
