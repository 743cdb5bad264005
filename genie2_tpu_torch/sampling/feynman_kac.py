"""Generic reverse-time Feynman-Kac particle filter (Chopin's formulation).

Counterpart of genie2_tpu/sampling/feynman_kac.py. The proposal M and the
potential G are callables:

    M(noise, particles, extra, t) -> (particles, extra)
    G(particles_new, particles_old, extra, t) -> log potential [P]

The loop is plain Python over t = n_steps..1 under the caller's
`torch.inference_mode()` (there are no scan segments: PyTorch runs eagerly).
When the effective sample size falls below `ess_threshold * P` the particles
are resampled systematically; as in the JAX package that is a `where`-selected
gather, computed every step, so no step waits for the host to read the ESS.
`smc_feynman_kac_injected` takes each step's proposal noise and resampling
offset from the caller; `smc_feynman_kac` draws the offsets from a generator
and asks `noise_fn(t)` for the noise.

Data parallel (`mesh`): each rank holds its rows of the particles; each
step's log weights and proposals are gathered, so every rank computes the
same ESS, decision and indices and takes its selected rows, and the
result holds every particle, on every rank.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from genie2_tpu_torch.parallel.mesh import Mesh, data_axis_size, gather_rows, local_rows

from genie2_tpu_torch.sampling.resampling import (
    ess_from_log_weights,
    normalize_log_weights,
    resampling_draws,
    systematic_resample_indices,
)
from genie2_tpu_torch.utils.profiling import span


class FKResult(NamedTuple):
    particles: Any
    log_weights: torch.Tensor  # [P]
    ess_trace: torch.Tensor  # [n_steps], before each step's resampling
    resampled_trace: torch.Tensor  # [n_steps] bool


def _first_tensor(tree) -> torch.Tensor:
    if isinstance(tree, torch.Tensor):
        return tree
    return _first_tensor(next(iter(tree.values() if isinstance(tree, dict) else tree)))


def _tree_map(fn: Callable, tree):
    """fn on a tensor or on every tensor in a dict / list / tuple of them;
    None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def _gather(tree, idx: torch.Tensor):
    """Index the leading (particle) axis of a tensor or of every tensor in
    a dict / list / tuple of them; None stays None."""
    return _tree_map(lambda x: x[idx], tree)


def _all_particles(tree, mesh: Optional[Mesh]):
    """Every rank's rows of each tensor in `tree` (the tree without a mesh)."""
    return _tree_map(lambda x: gather_rows(mesh, x)[0], tree)


def smc_feynman_kac_injected(M: Callable, G: Callable, init_particles: Any, init_extra: Any,
                             noises: Sequence[Any], offsets: torch.Tensor, n_particles: int,
                             ess_threshold: float = 0.5, mesh: Optional[Mesh] = None) -> FKResult:
    """The particle filter for steps len(noises)..1: `noises[i]` goes to M
    and `offsets[i]` (in [0, 1/P)) to the systematic resampler at step
    len(noises) - i. With a mesh, the particles, extras and noises are this
    rank's rows of the `n_particles`."""
    n_steps = len(noises)
    particles, extra = init_particles, init_extra
    device = _first_tensor(particles).device
    rows = local_rows(n_particles, mesh)
    log_w = torch.zeros(n_particles // data_axis_size(mesh), dtype=torch.float32, device=device)
    keep = torch.arange(n_particles, device=device)
    offsets = offsets.to(device)
    ess_trace, resampled_trace = [], []
    for i, t in enumerate(range(n_steps, 0, -1)):
        new_particles, new_extra = M(noises[i], particles, extra, t)
        log_w_new = gather_rows(mesh, log_w + G(new_particles, particles, new_extra, t))[0]

        with span("resample"):
            ess = ess_from_log_weights(log_w_new)
            do_resample = ess < ess_threshold * n_particles
            idx = systematic_resample_indices(torch.softmax(log_w_new, dim=0), offsets[i])
            sel = torch.where(do_resample, idx, keep)[rows]

        particles = _gather(_all_particles(new_particles, mesh), sel)
        extra = _gather(_all_particles(new_extra, mesh), sel)
        log_w = torch.where(do_resample, torch.zeros_like(log_w_new),
                            normalize_log_weights(log_w_new) + math.log(float(n_particles)))[rows]
        ess_trace.append(ess)
        resampled_trace.append(do_resample)
    return FKResult(_all_particles(particles, mesh), gather_rows(mesh, log_w)[0], torch.stack(ess_trace),
                    torch.stack(resampled_trace))


def smc_feynman_kac(M: Callable, G: Callable, init_particles: Any, init_extra: Any, noise_fn: Callable[[int], Any],
                    generator: torch.Generator, n_steps: int, n_particles: int,
                    ess_threshold: float = 0.5) -> FKResult:
    """`smc_feynman_kac_injected` with the noise of step t from `noise_fn(t)`
    and the resampling offsets drawn from `generator`."""
    offsets = resampling_draws("systematic", n_particles, generator, steps=n_steps)
    noises = [noise_fn(t) for t in range(n_steps, 0, -1)]
    return smc_feynman_kac_injected(M, G, init_particles, init_extra, noises, offsets, n_particles, ess_threshold)
