"""Pair-representation stack: triangle multiplicative updates and the pair
transition, residual and masked. Triangle attention is a later slice.

`TriangleMultiplicativeUpdate` always runs as the three-stage pipeline of
`ops/trimul.py`: on a CUDA tensor through the three kernels, on a CPU tensor
through their plain versions. The kernels take any N and any hidden width,
so there is no shape gate.
"""

from __future__ import annotations

import torch
from torch import nn

from genie2_tpu_torch.nn.primitives import Linear, layer_norm
from genie2_tpu_torch.ops import trimul


class TriangleMultiplicativeUpdate(nn.Module):
    """AF2 Algorithms 11/12; `outgoing` picks the contracted index."""

    def __init__(self, c_z: int, c_hidden: int, outgoing: bool = True):
        super().__init__()
        self.outgoing = outgoing
        self.layer_norm_in = layer_norm(c_z)
        self.linear_a_p = Linear(c_z, c_hidden)
        self.linear_a_g = Linear(c_z, c_hidden, init="gating")
        self.linear_b_p = Linear(c_z, c_hidden)
        self.linear_b_g = Linear(c_z, c_hidden, init="gating")
        self.layer_norm_out = layer_norm(c_hidden)
        self.linear_z = Linear(c_hidden, c_z, init="final")
        self.linear_g = Linear(c_z, c_z, init="gating")

    def fused_weights(self) -> trimul.Weights:
        w = {
            "ln_in_scale": self.layer_norm_in.weight, "ln_in_bias": self.layer_norm_in.bias,
            "ln_out_scale": self.layer_norm_out.weight, "ln_out_bias": self.layer_norm_out.bias,
        }
        for key, lin in (("ap", self.linear_a_p), ("ag", self.linear_a_g), ("bp", self.linear_b_p),
                         ("bg", self.linear_b_g), ("z", self.linear_z), ("g", self.linear_g)):
            w[f"w_{key}"], w[f"b_{key}"] = lin.weight, lin.bias
        return w

    def forward(self, z: torch.Tensor, res_mask: torch.Tensor) -> torch.Tensor:
        """z [B,N,N,C], res_mask [B,N] -> the update before the residual."""
        return trimul.trimul(z.contiguous(), res_mask.to(z.dtype), self.fused_weights(), self.outgoing)


class PairTransition(nn.Module):
    """AF2 Algorithm 15."""

    def __init__(self, c_z: int, n: int):
        super().__init__()
        self.layer_norm = layer_norm(c_z)
        self.linear_1 = Linear(c_z, n * c_z, init="relu")
        self.linear_2 = Linear(n * c_z, c_z, init="final")

    def forward(self, z, mask):
        z = self.linear_1(self.layer_norm(z))
        return self.linear_2(torch.relu(z)) * mask[..., None].to(z.dtype)


class PairTransformLayer(nn.Module):
    """TriMulOut + TriMulIn + PairTransition, residual, masked."""

    def __init__(self, c_p, include_mul_update, include_tri_att, c_hidden_mul, pair_transition_n):
        super().__init__()
        if include_tri_att:
            raise NotImplementedError("triangle attention is not ported yet")
        self.include_mul_update = include_mul_update
        if include_mul_update:
            self.tri_mul_out = TriangleMultiplicativeUpdate(c_p, c_hidden_mul, outgoing=True)
            self.tri_mul_in = TriangleMultiplicativeUpdate(c_p, c_hidden_mul, outgoing=False)
        self.pair_transition = PairTransition(c_p, pair_transition_n)

    def forward(self, p, pair_mask, res_mask):
        if self.include_mul_update:
            p = p + self.tri_mul_out(p, res_mask)
            p = p + self.tri_mul_in(p, res_mask)
        p = p + self.pair_transition(p, pair_mask)
        return p * pair_mask[..., None].to(p.dtype)


class PairTransformNet(nn.Module):
    def __init__(self, c_p, n_pair_transform_layer, include_mul_update, include_tri_att,
                 c_hidden_mul, pair_transition_n):
        super().__init__()
        self.net = nn.ModuleList(
            PairTransformLayer(c_p, include_mul_update, include_tri_att, c_hidden_mul, pair_transition_n)
            for _ in range(n_pair_transform_layer)
        )

    def forward(self, p, features):
        mask = features["residue_mask"].to(p.dtype)
        pair_mask = mask[:, :, None] * mask[:, None, :]
        for layer in self.net:
            p = layer(p, pair_mask, mask)
        return p
