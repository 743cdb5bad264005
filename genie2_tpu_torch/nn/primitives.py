"""Linear layers with the reference's initializer table, and LayerNorm.

The reference's fan formula is idiosyncratic: for an [out, in] weight it
takes fan_in = out^2 * in and fan_out = out * in^2. Its checkpoints were
trained with it, so `Linear` reproduces it rather than the textbook fan.
`"gating"` layers start at weight 0 / bias 1 and `"final"` layers at 0 / 0.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of the standard normal truncated to [-2, 2]
_TRUNCNORM_STD = 0.8796256610342398

SOFTPLUS_INVERSE_1 = 0.541324854612918  # softplus^-1(1)

LN_EPS = 1e-6  # the JAX package's LayerNorm epsilon (torch's default is 1e-5)


def reference_fan(out_dim: int, in_dim: int, fan: str) -> float:
    prod = out_dim * in_dim
    if fan == "fan_in":
        return prod * out_dim
    if fan == "fan_out":
        return prod * in_dim
    if fan == "fan_avg":
        return prod * (out_dim + in_dim) / 2
    raise ValueError(fan)


class Linear(nn.Linear):
    """nn.Linear initialised by the reference's table: "default", "relu",
    "glorot", "gating", "final" or "normal"."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, init: str = "default"):
        self.init_name = init
        super().__init__(in_dim, out_dim, bias=bias)

    @torch.no_grad()
    def reset_parameters(self):
        out_dim, in_dim = self.weight.shape
        init = self.init_name
        if init in ("default", "relu"):
            scale = 2.0 if init == "relu" else 1.0
            f = max(1.0, reference_fan(out_dim, in_dim, "fan_in"))
            std = math.sqrt(scale / f) / _TRUNCNORM_STD
            nn.init.trunc_normal_(self.weight, std=std, a=-2.0 * std, b=2.0 * std)
        elif init == "glorot":
            nn.init.xavier_uniform_(self.weight)
        elif init in ("gating", "final"):
            self.weight.zero_()
        elif init == "normal":
            self.weight.normal_(0.0, 1.0 / math.sqrt(in_dim))
        else:
            raise ValueError(f"Invalid init string: {init}")
        if self.bias is not None:
            self.bias.fill_(1.0 if init == "gating" else 0.0)


def layer_norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)
