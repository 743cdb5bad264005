"""Quaternion <-> rotation-matrix conversions; quaternions are (w, x, y, z).

`rot_to_quat` has two methods:
  * "eigh"   — top eigenvector of the 4x4 Davenport K-matrix, the
               reference algorithm. The eigenvector sign is up to the
               solver, so results may differ by a sign per matrix. Its
               gradient is that of the top eigenvector alone
               (`TopEigenvector`).
  * "closed" — branchless Shepperd extraction with a canonical sign
               (largest-|component| positive), purely elementwise.
"""

from __future__ import annotations

import torch

from genie2_tpu_torch.utils.profiling import host_sync, span

# cuSOLVER's batched symmetric eigensolver refuses a batch of 32768 4x4
# matrices and takes 16384 (H100, CUDA 12.8), so "eigh" goes in chunks.
_EIGH_BATCH = 16384


def quat_to_rot(quat: torch.Tensor) -> torch.Tensor:
    """[*, 4] (w,x,y,z) -> [*, 3, 3]; exact for unit quaternions."""
    a, b, c, d = quat.unbind(-1)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    ab, ac, ad = a * b, a * c, a * d
    bc, bd, cd = b * c, b * d, c * d
    row0 = torch.stack([aa + bb - cc - dd, 2 * bc - 2 * ad, 2 * bd + 2 * ac], dim=-1)
    row1 = torch.stack([2 * bc + 2 * ad, aa - bb + cc - dd, 2 * cd - 2 * ab], dim=-1)
    row2 = torch.stack([2 * bd - 2 * ac, 2 * cd + 2 * ab, aa - bb - cc + dd], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _k_matrix(rot: torch.Tensor) -> torch.Tensor:
    xx, xy, xz = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    yx, yy, yz = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    zx, zy, zz = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    k = torch.stack(
        [
            torch.stack([xx + yy + zz, zy - yz, xz - zx, yx - xy], dim=-1),
            torch.stack([zy - yz, xx - yy - zz, xy + yx, xz + zx], dim=-1),
            torch.stack([xz - zx, xy + yx, yy - xx - zz, yz + zy], dim=-1),
            torch.stack([yx - xy, xz + zx, yz + zy, zz - xx - yy], dim=-1),
        ],
        dim=-2,
    )
    return k / 3.0


class TopEigenvector(torch.autograd.Function):
    """The eigenvector of the largest eigenvalue of symmetric [B, 4, 4]
    matrices, [B, 4], from `torch.linalg.eigh` in chunks.

    The K-matrix of a rotation has eigenvalues 1 and, three times, -1/3:
    the top one is simple, so its eigenvector has a well-defined derivative,
    dv = sum_{i != top} v_i (v_i . dK v) / (l_top - l_i). eigh's own
    backward (torch's and jax's alike) differentiates the whole
    decomposition and divides by every pair's eigenvalue gap; where the
    solver returns two of the triple exactly equal, as it does for about a
    third of these matrices in float32, it computes 0 / 0 in a block that
    carries no cotangent, and the gradient is NaN. This backward computes
    the top eigenvector's term only: the same numbers wherever eigh's own
    backward is finite."""

    @staticmethod
    def forward(ctx, k):
        with span("eigh"):
            chunks = k.split(_EIGH_BATCH)
            # torch reads each call's status on the host: one sync a chunk.
            host_sync("eigh_status", k, len(chunks))
            w, v = zip(*(torch.linalg.eigh(chunk) for chunk in chunks))
            w, v = torch.cat(w), torch.cat(v)
        ctx.save_for_backward(w, v)
        return v[..., -1]

    @staticmethod
    def backward(ctx, g):
        w, v = ctx.saved_tensors
        top, rest = v[..., -1], v[..., :-1]
        c = (rest * g[..., :, None]).sum(-2) / (w[..., -1:] - w[..., :-1])  # [B, 3]
        d = (rest * c[..., None, :]).sum(-1)  # sum_i c_i v_i, [B, 4]
        gk = d[..., :, None] * top[..., None, :]
        return 0.5 * (gk + gk.transpose(-1, -2))


def _first_max_onehot(x: torch.Tensor) -> torch.Tensor:
    """One-hot of the first maximum along the last axis."""
    is_best = x >= x.amax(dim=-1, keepdim=True)
    return is_best & (torch.cumsum(is_best.to(torch.int32), dim=-1) == 1)


def rot_to_quat(rot: torch.Tensor, method: str = "closed") -> torch.Tensor:
    """[*, 3, 3] -> [*, 4] unit quaternion (w,x,y,z)."""
    if method == "eigh":
        # The solvers take fp32/fp64 only; a bf16 policy rounds afterwards.
        k = _k_matrix(rot.float()).reshape(-1, 4, 4)
        return TopEigenvector.apply(k).reshape(*rot.shape[:-2], 4).to(rot.dtype)
    if method != "closed":
        raise ValueError(f"unknown rot_to_quat method: {method}")

    xx, xy, xz = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    yx, yy, yz = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    zx, zy, zz = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]

    # Four candidate extractions, each stable in a different region;
    # candidate i carries 4*q_i^2 on its diagonal entry.
    tr = xx + yy + zz
    qw = torch.stack([1.0 + tr, zy - yz, xz - zx, yx - xy], dim=-1)
    qx = torch.stack([zy - yz, 1.0 + xx - yy - zz, xy + yx, xz + zx], dim=-1)
    qy = torch.stack([xz - zx, xy + yx, 1.0 + yy - xx - zz, yz + zy], dim=-1)
    qz = torch.stack([yx - xy, xz + zx, yz + zy, 1.0 + zz - xx - yy], dim=-1)

    diags = torch.stack([qw[..., 0], qx[..., 1], qy[..., 2], qz[..., 3]], dim=-1)
    w = _first_max_onehot(diags).to(qw.dtype)
    q = w[..., 0:1] * qw + w[..., 1:2] * qx + w[..., 2:3] * qy + w[..., 3:4] * qz
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    # Canonical sign: the largest-magnitude component is positive.
    sel = _first_max_onehot(q.abs())
    lead = torch.where(sel, q, torch.zeros_like(q)).sum(-1, keepdim=True)
    return q * torch.sign(lead)
