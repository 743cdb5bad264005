"""Rigid transforms (rotation + translation).

Rotations are stored as [..., 3, 3] matrices, translations as [..., 3];
x -> rots @ x + trans.
"""

from __future__ import annotations

import torch


def rot_vec_mul(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """r [..., 3, 3] @ v [..., 3] -> [..., 3], broadcasting batch dims."""
    return (r * v[..., None, :]).sum(-1)


def rot_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., 3, 3] @ b [..., 3, 3], broadcasting batch dims (elementwise,
    so no TF32 tensor-core rounding on the card)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


class Rigid:
    """A rigid transform x -> rots @ x + trans."""

    __slots__ = ("rots", "trans")

    def __init__(self, rots: torch.Tensor, trans: torch.Tensor):
        self.rots = rots
        self.trans = trans

    def compose(self, other: "Rigid") -> "Rigid":
        """self ∘ other: rot = R1 R2, trans = R1 t2 + t1."""
        return Rigid(
            rot_matmul(self.rots, other.rots),
            rot_vec_mul(self.rots, other.trans) + self.trans,
        )

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return rot_vec_mul(self.rots, pts) + self.trans

    def invert_apply(self, pts: torch.Tensor) -> torch.Tensor:
        return rot_vec_mul(self.rots.transpose(-1, -2), pts - self.trans)

    def scale_translation(self, factor) -> "Rigid":
        return Rigid(self.rots, self.trans * factor)

    def unsqueeze(self, axis: int) -> "Rigid":
        """Insert a batch axis (axis counted in batch dims)."""
        return Rigid(
            self.rots.unsqueeze(axis if axis >= 0 else axis - 2),
            self.trans.unsqueeze(axis if axis >= 0 else axis - 1),
        )

    def to(self, dtype) -> "Rigid":
        return Rigid(self.rots.to(dtype), self.trans.to(dtype))
