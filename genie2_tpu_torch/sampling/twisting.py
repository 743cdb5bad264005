"""The twisting potential of the Twisted Diffusion Sampler and the motif
placement machinery.

Counterpart of genie2_tpu/sampling/twisting.py. Placements are enumerated on
the host into a dense [n_offsets, n_motif_res] position table (numpy, with
the same generator semantics, so a seeded generator gives the same table in
both packages); on the device the potential is a gather, a centring, a
squared distance and a logsumexp over placements. The gather is
`x0[:, positions]`, whose gradient is an index-add; the JAX package writes
it as a one-hot product, which the TPU prefers to a batched gather.
Autograd differentiates through it, the Frenet frames and the denoiser.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from genie2_tpu_torch.geometry import frenet_frames


def enumerate_motif_placements(
    length: int,
    segment_lengths: Sequence[int],
    max_offsets: int = 1000,
    rng: Optional[np.random.Generator] = None,
) -> List[Tuple[Tuple[int, int], ...]]:
    """All non-overlapping, in-order placements of the given segments in a
    sequence of `length` residues, as ((start, end), ...) tuples (inclusive
    ends); uniformly subsampled to max_offsets by `rng.choice` when there
    are more."""

    def recurse(L, seg_lens):
        first = seg_lens[0]
        out = []
        for st in range(0, L - sum(seg_lens) + 1):
            end = st + first - 1
            if len(seg_lens) == 1:
                out.append(((st, end),))
            else:
                for later in recurse(L - (end + 1), seg_lens[1:]):
                    shifted = tuple((s + end + 1, e + end + 1) for s, e in later)
                    out.append(((st, end),) + shifted)
        return out

    placements = recurse(length, list(segment_lengths))
    if len(placements) > max_offsets:
        rng = rng or np.random.default_rng()
        idx = rng.choice(len(placements), max_offsets, replace=False)
        placements = [placements[i] for i in idx]
    return placements


def placements_to_positions(placements: List[Tuple[Tuple[int, int], ...]]) -> np.ndarray:
    """[n_offsets, n_motif_res] int32 residue indices, segments concatenated
    in order."""
    rows = []
    for placement in placements:
        row = []
        for start, end in placement:
            row.extend(range(start, end + 1))
        rows.append(row)
    return np.asarray(rows, dtype=np.int32)


def xstart_variance(alphas_cumprod_t, tausq: float = 0.012, var_type: int = 6, beta_t=None):
    """The x-start variance heuristic, sigma^2 = (1 - abar)/abar:

      1: sigma^2                    (plain)
      2: sigma^2/(sigma^2 + 1)      (pseudoinverse-guided, tau^2 = 1)
      5: shrunk with tau^2 = 0.30
      4: beta_t / sqrt(abar)        (pseudoinverse-guided Alg. 1)
      6: sigma^2 tau^2/(sigma^2+tau^2) with the caller's tau^2 (default 0.012)
    """
    sigmasq = (1.0 - alphas_cumprod_t) / alphas_cumprod_t
    if var_type == 1:
        return sigmasq
    if var_type == 2:
        return sigmasq / (sigmasq + 1.0)
    if var_type == 5:
        return (sigmasq * 0.30) / (sigmasq + 0.30)
    if var_type == 4:
        if beta_t is None:
            raise ValueError("var_type 4 needs beta_t")
        return beta_t / torch.sqrt(torch.as_tensor(alphas_cumprod_t))
    if var_type == 6:
        return (sigmasq * tausq) / (sigmasq + tausq)
    raise ValueError(f"unknown var_type: {var_type}")


def _centred_placements(x0: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """[P, L, 3] coordinates + [O, M] placement table -> the placed residues,
    centred per placement, [P, O, M, 3]."""
    sel = x0[:, positions]
    return sel - sel.mean(dim=-2, keepdim=True)


def _log_mean_exp(score: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(score, dim=-1) - math.log(float(score.shape[-1]))


def twisting_log_prob(x0: torch.Tensor, positions: torch.Tensor, motif_target: torch.Tensor,
                      variance) -> Tuple[torch.Tensor, torch.Tensor]:
    """log p~(y | x_t) = logsumexp_o [ -|| center(x0[o-placement]) - y ||^2
    / (2 sigma~^2) ] - log O.

    x0 [P, L, 3] predicted x-start per particle, positions [O, M] (long),
    motif_target [M, 3] centred, variance a scalar sigma~^2. Returns
    (log_prob [P], per-placement scores [P, O])."""
    sel = _centred_placements(x0, positions)
    score = -((sel - motif_target) ** 2).sum(dim=(-1, -2)) / (2.0 * variance)
    return _log_mean_exp(score), score


def motif_frame_rotations(segments: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Frenet frames of the motif target, per segment, and the interior
    weighting mask.

    Each segment is its own chain for the frame computation (its boundary
    residues copy their neighbour's frame). The mask is 1 only on
    segment-interior residues: a boundary residue's frame in the placed
    structure depends on unknown scaffold neighbours. Segments shorter than
    3 residues contribute no rotation term.

    Returns (rots [M, 3, 3] float32, interior_mask [M] float32)."""
    coords = np.concatenate(segments, axis=0).astype(np.float32)
    chain_index = np.concatenate([np.full(len(s), i, np.int64) for i, s in enumerate(segments)])
    mask = np.ones(len(coords), np.int64)
    rots = frenet_frames(torch.from_numpy(coords)[None], torch.from_numpy(chain_index)[None],
                         torch.from_numpy(mask)[None])[0].numpy()
    interior = []
    for s in segments:
        m = np.zeros(len(s), np.float32)
        if len(s) >= 3:
            m[1:-1] = 1.0
        interior.append(m)
    return rots, np.concatenate(interior)


def twisting_log_prob_frames(x0: torch.Tensor, rots0: torch.Tensor, positions: torch.Tensor,
                             motif_target: torch.Tensor, variance, motif_rots: torch.Tensor,
                             rot_mask: torch.Tensor, rot_variance) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translation + rotation twisting potential:

    log p~(y | x_t) = logsumexp_o [ -||center(x0[o]) - y||^2 / (2 s~^2)
                                    -||R(x0)[o] - R_y||_F^2 m / (4 s~_R^2) ]
                      - log O

    rots0 [P, L, 3, 3] are the Frenet frames of x0 (computed by the caller,
    so the gradient runs through one frame computation), motif_rots
    [M, 3, 3] the motif's (`motif_frame_rotations`), rot_mask [M] its
    interior weighting. Returns (log_prob [P], scores [P, O])."""
    sel = _centred_placements(x0, positions)
    score = -((sel - motif_target) ** 2).sum(dim=(-1, -2)) / (2.0 * variance)
    diff2 = ((rots0[:, positions] - motif_rots) ** 2).sum(dim=(-1, -2))  # [P, O, M]
    score = score - (diff2 * rot_mask).sum(-1) / (4.0 * rot_variance)
    return _log_mean_exp(score), score


def motif_distance(x0: torch.Tensor, positions: torch.Tensor, motif_target: torch.Tensor) -> torch.Tensor:
    """Mean squared deviation between placed-and-centred x0 and the motif,
    over particles, placements and residues (monitoring)."""
    return ((_centred_placements(x0, positions) - motif_target) ** 2).mean()
