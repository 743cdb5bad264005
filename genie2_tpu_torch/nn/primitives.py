"""Linear layers with the reference's initializer table, LayerNorm, and the
gated multi-head attention of the triangle attention modules.

The reference's fan formula is idiosyncratic: for an [out, in] weight it
takes fan_in = out^2 * in and fan_out = out * in^2. Its checkpoints were
trained with it, so `Linear` reproduces it rather than the textbook fan.
`"gating"` layers start at weight 0 / bias 1 and `"final"` layers at 0 / 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from genie2_tpu_torch.ops.tri_att import tri_attention
from genie2_tpu_torch.parallel.tensor_parallel import reduce_from_model

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


class DropoutSource(NamedTuple):
    """One layer's dropout masks: a generator of the layer's seed, on the
    activations' device, drawing each mask for the whole global batch of
    `total` rows, of which this batch holds rows [start, stop). Under
    sequence parallelism `residues` is (row start, row stop, real residues,
    padded residues): the masks are drawn for the real residues, padded,
    and this rank's residue rows kept (None: the activations hold every
    residue)."""

    generator: torch.Generator
    start: int
    stop: int
    total: int
    residues: Optional[Tuple[int, int, int, int]] = None


def layer_generator(key, device) -> Optional[DropoutSource]:
    """The source of one layer's dropout masks from its key (layer seed,
    start, stop, total[, residues]; nn/denoiser.py), or None (no dropout)
    where `key` is None. Drawing every mask for the global batch (and all
    residues) and keeping this batch's rows makes a row's mask the same on
    whichever rank it lies."""
    if key is None:
        return None
    seed, *rest = key
    return DropoutSource(torch.Generator(device=device).manual_seed(int(seed)), *rest)


def dropout(x: torch.Tensor, rate: float, source: Optional[DropoutSource], broadcast_dims=()) -> torch.Tensor:
    """flax's nn.Dropout: keep each entry with probability 1 - rate and
    scale it by 1 / (1 - rate), one mask shared along `broadcast_dims`
    (axes other than the batch axis 0, negative ones counted from the end).
    The mask is drawn for the global batch and sliced to this batch's rows;
    with `source.residues`, the axes between the batch and the channels are
    residue axes, drawn for the real residues, padded to the padded length
    (the padded entries' values are never read: those positions are masked)
    and sliced to this rank's rows along axis 1. The identity where
    `source` is None (eval mode) or the rate is 0."""
    if source is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    dims = {d % x.dim() for d in broadcast_dims}
    res = source.residues
    shape = [source.total] + [1 if d in dims else res[2] if res and d < x.dim() - 1 else n
                              for d, n in enumerate(x.shape)][1:]
    mask = torch.rand(shape, generator=source.generator, device=x.device)[source.start:source.stop] < keep
    if res:
        pad = [(0, 0) if d in dims or d == x.dim() - 1 else (0, res[3] - res[2]) for d in range(1, x.dim())]
        mask = F.pad(mask, [v for p in reversed(pad) for v in p], value=True)
        if 1 not in dims:
            mask = mask[:, res[0]:res[1]]
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Attention(nn.Module):
    """Gated multi-head attention as triangle attention drives it: the
    inputs are [B, I, J, C], every row i attends within itself, and the two
    biases of the logits are the triangle bias `tb` [B, H, J, J] (shared by
    all rows) and the key-side mask `mask` [B, I, J], added as
    inf (mask - 1). `c_hidden` is the width of one head.

    The projections are plain products; the attention core between them is
    `ops/tri_att.py:tri_attention`: the kernel on the card, the plain
    version on the CPU. `row_chunk` > 0 bounds the logits the plain version
    holds at once to that many rows; the kernel holds none. Under tensor
    parallelism (`tp`) it holds this rank's heads (`no_heads` of them):
    q, k, v and g by columns, `linear_o` by rows, its bias after the
    reduction; the caller passes the inputs through copy_to_model."""

    tp = None

    def __init__(self, c_q: int, c_k: int, c_v: int, c_hidden: int, no_heads: int, gating: bool = True,
                 row_chunk: int = 0, inf: float = 1e9):
        super().__init__()
        self.c_hidden, self.no_heads, self.row_chunk, self.inf = c_hidden, no_heads, row_chunk, inf
        self.linear_q = Linear(c_q, no_heads * c_hidden, bias=False, init="glorot")
        self.linear_k = Linear(c_k, no_heads * c_hidden, bias=False, init="glorot")
        self.linear_v = Linear(c_v, no_heads * c_hidden, bias=False, init="glorot")
        self.linear_g = Linear(c_q, no_heads * c_hidden, init="gating") if gating else None
        self.linear_o = Linear(no_heads * c_hidden, c_q, init="final")

    def shard_(self, tp):
        self.tp = tp
        self.no_heads //= tp.size

    def forward(self, q_x: torch.Tensor, k_x: torch.Tensor, v_x: torch.Tensor, tb: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        if q_x.dim() != 4:
            raise ValueError(f"Attention: expected [B, I, J, C] inputs, got {tuple(q_x.shape)}")
        heads = (self.no_heads, self.c_hidden)
        q = self.linear_q(q_x).unflatten(-1, heads)
        k = self.linear_k(k_x).unflatten(-1, heads)
        v = self.linear_v(v_x).unflatten(-1, heads)
        o = tri_attention(q, k, v, tb, mask, self.inf, self.row_chunk)
        if self.linear_g is not None:
            o = o * torch.sigmoid(self.linear_g(q_x)).unflatten(-1, heads)
        if self.tp is None:
            return self.linear_o(o.flatten(-2))
        return reduce_from_model(F.linear(o.flatten(-2), self.linear_o.weight), self.tp) + self.linear_o.bias
