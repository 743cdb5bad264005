"""Frenet-Serret frames from C-alpha traces, vectorized, and distograms.

Residue j (1 <= j <= length-2) gets the frame built from residues
(j-1, j, j+1): tangent t = normalized forward difference, binormal
b = normalized t_{j-1} x t_j, normal n = b x t_j, rotation = [t, b, n] as
columns. The first residue of each chain copies its successor's frame, the
last copies its predecessor's (after the start fix); positions beyond the
(prefix) residue mask are identity.
"""

from __future__ import annotations

import torch

from genie2_tpu_torch.utils.profiling import spanned


@spanned("frames")
def frenet_frames(
    coords: torch.Tensor,
    chain_index: torch.Tensor,
    mask: torch.Tensor,
    eps: float = 1e-10,
) -> torch.Tensor:
    """coords [B, N, 3], chain_index [B, N], mask [B, N] -> rots [B, N, 3, 3]."""
    B, N = mask.shape
    device, dtype = coords.device, coords.dtype

    # Tangents between consecutive residues, stored at the left residue.
    d = coords[:, 1:] - coords[:, :-1]  # [B, N-1, 3]
    t = d / torch.sqrt(eps + (d * d).sum(-1, keepdim=True))
    t0, t1 = t[:, :-1], t[:, 1:]  # [B, N-2, 3]
    b = torch.linalg.cross(t0, t1, dim=-1)
    b = b / torch.sqrt(eps + (b * b).sum(-1, keepdim=True))
    n = torch.linalg.cross(b, t1, dim=-1)

    # Interior frame for residue j uses (t1, b, n)[j-1]: [B, N-2, 3, 3]
    # with columns (t, b, n), padded by one residue on each side.
    interior_rots = torch.stack([t1, b, n], dim=-1)
    rots = torch.nn.functional.pad(interior_rots, (0, 0, 0, 0, 1, 1))  # [B, N, 3, 3]

    eye = torch.eye(3, dtype=dtype, device=device)
    length = mask.to(torch.int64).sum(-1)  # [B]
    pos = torch.arange(N, device=device)[None, :]
    in_range = pos < length[:, None]
    interior = (pos >= 1) & (pos <= length[:, None] - 2)

    false_col = torch.zeros((B, 1), dtype=torch.bool, device=device)
    same_as_prev = torch.cat([false_col, chain_index[:, 1:] == chain_index[:, :-1]], dim=1)
    same_as_next = torch.cat([chain_index[:, :-1] == chain_index[:, 1:], false_col], dim=1)
    is_start = in_range & (~same_as_prev | (pos == 0))
    # The last in-range residue is always an end: its successor is padding,
    # whose chain id may collide with a real chain id.
    is_end = in_range & (~same_as_next | (pos == length[:, None] - 1))

    def where(cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    c0 = where(interior, rots, eye)
    succ = torch.cat([c0[:, 1:], c0[:, -1:]], dim=1)
    c1 = where(is_start, succ, c0)
    pred = torch.cat([c1[:, :1], c1[:, :-1]], dim=1)
    c2 = where(is_end, pred, c1)
    return where(in_range, c2, eye)


def distogram(coords_i: torch.Tensor, coords_j: torch.Tensor, eps: float = 1e-10):
    """All-pairs distances: [.., N, 3] x [.., M, 3] -> [.., N, M]."""
    diff = coords_i[..., :, None, :] - coords_j[..., None, :, :]
    return torch.sqrt(eps + (diff * diff).sum(-1))
