"""Pair-representation stack: triangle multiplicative updates, triangle
attention and the pair transition, residual and masked.

In training, each update before its residual add goes through dropout as
flax's nn.Dropout applies it: one mask shared along the rows (axis -3)
after both TriMul updates and the starting triangle attention, along the
columns (axis -2) after the ending one. A layer's masks come from the key
it is given (its seed and the batch's rows of the global batch), so a
layer rematerialised in the backward (`remat`, torch.utils.checkpoint)
draws the same masks again.

`TriangleMultiplicativeUpdate` always runs as the three-stage pipeline of
`ops/trimul.py`: on a CUDA tensor through the three kernels, on a CPU tensor
through their plain versions. The kernels take any N and any hidden width,
so there is no shape gate. `TriangleAttention` runs its attention core
through `ops/tri_att.py` in the same way (one kernel launch per module call
on the card).

Under tensor parallelism (parallel/tensor_parallel.py) the TriMul splits
its hidden channels: the projection and the contraction run on this rank's
channels, the epilogue as its two stages around one all-reduce of their
partial sums (ops/trimul.py); the pair transition splits its hidden
channels (`linear_1` by columns, `linear_2` by rows) and triangle
attention its heads. Each update leaves the module reduced and
replicated, so the dropout after it draws the same masks on every model
rank.

Under sequence parallelism (parallel/sequence_parallel.py, `seq`) each
rank holds rows I of the pair representation, [B, I, N, C], and the
pair mask of those rows. The TriMul projects and finishes its rows (the
projection takes the rows' mask and the columns' mask apart); the
outgoing contraction, x[i,j] = sum_k a[i,k] b[j,k], gathers b and
contracts this rank's rows of a against it; the incoming one, x[i,j] =
sum_k a[k,i] b[k,j], contracts over this rank's k into partial sums of
every (i, j) and reduces them, keeping its rows (one buffer of B H N^2
either way). The starting triangle attention gathers only its bias
[B, H, N, N] (its rows attend within themselves); the ending one gathers
the layer-normed rows [B, N, N, C] (each of its rows is a column of the
pair representation, over all keys) and attends with this rank's rows as
the queries. The pair transition acts per position. Dropout masks are
drawn for every residue and sliced (nn/primitives.py).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

import torch.nn.functional as F

from genie2_tpu_torch.nn.primitives import Attention, Linear, dropout, layer_generator, layer_norm
from genie2_tpu_torch.ops import transition, trimul
from genie2_tpu_torch.parallel.sequence_parallel import gather_seq_rows, reduce_seq_rows, row_slice
from genie2_tpu_torch.parallel.tensor_parallel import copy_to_model, reduce_from_model
from genie2_tpu_torch.utils.profiling import spanned


class TriangleMultiplicativeUpdate(nn.Module):
    """AF2 Algorithms 11/12; `outgoing` picks the contracted index. `tp`:
    the model group its hidden channels are split over, or None; `seq`:
    the seq group its rows are split over, or None."""

    tp = None
    seq = None

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

    def tp_units(self) -> int:
        return self.linear_a_p.weight.shape[0]

    def shard_(self, tp):
        self.tp = tp

    @spanned("trimul")
    def forward(self, z: torch.Tensor, res_mask: torch.Tensor) -> torch.Tensor:
        """z [B,I,N,C] (I = N, or this rank's rows under `seq`), res_mask
        [B,N] -> the update before the residual."""
        z, res_mask, w = z.contiguous(), res_mask.to(z.dtype), self.fused_weights()
        tp, seq = self.tp, self.seq
        if tp is None and seq is None:
            return trimul.trimul(z, res_mask, w, self.outgoing)
        row_mask = res_mask if seq is None else res_mask[:, row_slice(z.shape[2], seq)]
        if tp is None:
            a, b = trimul.project_gated_cm(z, row_mask, w, res_mask)
            return trimul.epilogue_cm(self._contract(a, b), z, w)
        # This rank's hidden channels: LN_in (fused into the projection) and
        # LN_out read replicated parameters split by channel here, so they
        # and z come in through copy_to_model; the gate reads them whole.
        h = w["w_z"].shape[1]
        mine = slice(tp.rank * h, (tp.rank + 1) * h)
        split = dict(w, ln_in_scale=copy_to_model(w["ln_in_scale"], tp), ln_in_bias=copy_to_model(w["ln_in_bias"], tp))
        a, b = trimul.project_gated_cm(copy_to_model(z, tp), row_mask, split, res_mask)
        x = self._contract(a, b)
        part = trimul.epilogue_partial(x, w["w_z"], copy_to_model(w["ln_out_scale"], tp)[mine],
                                       copy_to_model(w["ln_out_bias"], tp)[mine])
        return trimul.epilogue_finish(reduce_from_model(part, tp), z, w, h * tp.size)

    def _contract(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """x [B,H,I,N] from this rank's rows of a and b [B,H,I,N]: the
        contraction, with the seq group's collective under `seq`."""
        seq = self.seq
        if seq is None:
            return trimul.contract_cm(a, b, self.outgoing)
        if self.outgoing:  # every row j of b, against this rank's rows i of a
            return trimul.contract_cm(a, gather_seq_rows(seq, 2, b)[0], True)
        # k is the sharded axis: partial sums of every (i, j), summed over the group.
        return reduce_seq_rows(trimul.contract_cm(a, b, False), seq, 2)


class TriangleAttention(nn.Module):
    """AF2 Algorithms 13/14. `starting` attends along the rows of the pair
    representation; the ending-node variant swaps the pair axes around the
    same computation (a copy on the way in, inside the layer norm, and a
    view on the way out). Under `seq` (this rank's rows) see the module
    docstring."""

    tp = None
    seq = None

    def __init__(self, c_in: int, c_hidden: int, no_heads: int, starting: bool = True, inf: float = 1e9,
                 row_chunk: int = 0):
        super().__init__()
        self.starting = starting
        self.layer_norm = layer_norm(c_in)
        self.linear = Linear(c_in, no_heads, bias=False, init="normal")
        self.mha = Attention(c_in, c_in, c_in, c_hidden, no_heads, row_chunk=row_chunk, inf=inf)

    def tp_units(self) -> int:
        return self.mha.no_heads

    def shard_(self, tp):
        self.tp = tp
        self.mha.shard_(tp)

    @spanned("tri_att")
    def forward(self, x: torch.Tensor, mask: torch.Tensor, res_mask: torch.Tensor = None) -> torch.Tensor:
        """x [B,I,N,C], mask [B,I,N] (the pair mask of the rows; I = N, or
        this rank's rows under `seq`; res_mask [B,N], read by the ending
        node under `seq`) -> the update before the residual."""
        if self.seq is not None and not self.starting:
            return self._ending_rows(x, res_mask)
        if not self.starting:
            x, mask = x.transpose(-2, -3), mask.transpose(-1, -2)
        x = self.layer_norm(x)
        if self.tp is not None:  # this rank's heads: the bias heads and the attention's
            x = copy_to_model(x, self.tp)
        # [B, I, J, H] -> [B, H, I, J]: the bias of query i and key j, for every row.
        tb = self.linear(x).permute(0, 3, 1, 2).contiguous()
        if self.seq is not None:  # the bias of every query row, from every rank
            tb = gather_seq_rows(self.seq, 2, tb)[0]
        out = self.mha(x, x, x, tb, mask)
        return out if self.starting else out.transpose(-2, -3)

    def _ending_rows(self, x: torch.Tensor, res_mask: torch.Tensor) -> torch.Tensor:
        """The ending node on this rank's rows I of the pair representation:
        row j of the swapped representation is column j of it, over every
        key k, so the layer-normed rows are gathered whole ([B,N,N,C]); this
        rank's rows are the queries of every swapped row, and the bias
        [B,H,I,N] is that of its queries."""
        xn = self.layer_norm(x)
        if self.tp is not None:
            xn = copy_to_model(xn, self.tp)
        queries = xn.transpose(1, 2).contiguous()  # [B, N rows, I queries, C]
        keys = gather_seq_rows(self.seq, 2, queries)[0]  # [B, N rows, N keys, C]
        rows = row_slice(keys.shape[1], self.seq)
        tb = self.linear(keys[:, rows]).permute(0, 3, 1, 2).contiguous()
        pair_mask = res_mask[:, :, None] * res_mask[:, None, :]  # symmetric: its own transpose
        return self.mha(queries, keys, keys, tb, pair_mask.to(x.dtype)).transpose(1, 2)


class PairTransition(nn.Module):
    """AF2 Algorithm 15, through ops/transition.py: one kernel launch a
    call for float32 activations on the card at the widths the kernel
    takes, the plain version of these same operations anywhere else. Under
    tensor parallelism (`tp`) this rank's hidden channels: `linear_1` by
    columns, `linear_2` by rows, its bias after the reduction."""

    tp = None

    def __init__(self, c_z: int, n: int):
        super().__init__()
        self.layer_norm = layer_norm(c_z)
        self.linear_1 = Linear(c_z, n * c_z, init="relu")
        self.linear_2 = Linear(n * c_z, c_z, init="final")

    def tp_units(self) -> int:
        return self.linear_1.weight.shape[0]

    def shard_(self, tp):
        self.tp = tp

    @spanned("pair_transition")
    def forward(self, z, mask):
        """z [B,I,N,C], mask [B,I,N] (the pair mask of the rows) -> the
        update before the residual."""
        if self.tp is None:
            return transition.pair_transition(z, mask, self.layer_norm.weight, self.layer_norm.bias,
                                              self.linear_1.weight, self.linear_1.bias, self.linear_2.weight,
                                              self.linear_2.bias, self.layer_norm.eps)
        h = torch.relu(self.linear_1(copy_to_model(self.layer_norm(z), self.tp)))
        z = reduce_from_model(F.linear(h, self.linear_2.weight), self.tp) + self.linear_2.bias
        return z * mask[..., None].to(z.dtype)


class PairTransformLayer(nn.Module):
    """TriMulOut + TriMulIn [+ TriAttStart + TriAttEnd] + PairTransition,
    residual, masked; each update but the transition's through dropout at
    `tri_dropout` where a seed is given."""

    def __init__(self, c_p, include_mul_update, include_tri_att, c_hidden_mul, pair_transition_n,
                 c_hidden_tri_att=32, n_head_tri=4, tri_att_chunk=0, tri_dropout=0.0):
        super().__init__()
        self.include_mul_update = include_mul_update
        self.include_tri_att = include_tri_att
        self.tri_dropout = tri_dropout
        if include_mul_update:
            self.tri_mul_out = TriangleMultiplicativeUpdate(c_p, c_hidden_mul, outgoing=True)
            self.tri_mul_in = TriangleMultiplicativeUpdate(c_p, c_hidden_mul, outgoing=False)
        if include_tri_att:
            self.tri_att_start = TriangleAttention(c_p, c_hidden_tri_att, n_head_tri, starting=True,
                                                   row_chunk=tri_att_chunk)
            self.tri_att_end = TriangleAttention(c_p, c_hidden_tri_att, n_head_tri, starting=False,
                                                 row_chunk=tri_att_chunk)
        self.pair_transition = PairTransition(c_p, pair_transition_n)

    @spanned("pair_layer")
    def forward(self, p, pair_mask, res_mask, seed=None):
        """`seed` (a dropout key, nn/primitives.py) seeds this layer's dropout masks; None: no dropout."""
        gen = layer_generator(seed, p.device)
        rate = self.tri_dropout
        if self.include_mul_update:
            p = p + dropout(self.tri_mul_out(p, res_mask), rate, gen, (-3,))
            p = p + dropout(self.tri_mul_in(p, res_mask), rate, gen, (-3,))
        if self.include_tri_att:
            p = p + dropout(self.tri_att_start(p, pair_mask), rate, gen, (-3,))
            p = p + dropout(self.tri_att_end(p, pair_mask, res_mask), rate, gen, (-2,))
        p = p + self.pair_transition(p, pair_mask)
        return p * pair_mask[..., None].to(p.dtype)


class PairTransformNet(nn.Module):
    """The stack of pair layers. With `remat`, in training mode with grad
    on, each layer runs under torch.utils.checkpoint: its activations are
    dropped after the forward and recomputed in the backward (its kernels
    launch twice). The checkpointed function takes the layer's parameters
    as arguments, so the recompute uses the tensors of the forward (a cast
    copy under the bf16 policy's functional_call) and, with the layer's
    seed, the same dropout masks."""

    seq = None

    def __init__(self, c_p, n_pair_transform_layer, include_mul_update, include_tri_att,
                 c_hidden_mul, pair_transition_n, c_hidden_tri_att=32, n_head_tri=4, tri_att_chunk=0,
                 tri_dropout=0.0, remat=False):
        super().__init__()
        self.remat = remat
        self.net = nn.ModuleList(
            PairTransformLayer(c_p, include_mul_update, include_tri_att, c_hidden_mul, pair_transition_n,
                               c_hidden_tri_att, n_head_tri, tri_att_chunk, tri_dropout)
            for _ in range(n_pair_transform_layer)
        )

    @spanned("pair_stack")
    def forward(self, p, features, seeds=None):
        """`seeds`: one dropout key a layer, or None (no dropout)."""
        mask = features["residue_mask"].to(p.dtype)
        # This rank's rows (all of them without a seq axis) against every column.
        pair_mask = mask[:, row_slice(p.shape[2], self.seq) if self.seq else slice(None), None] * mask[:, None, :]
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i, layer in enumerate(self.net):
            seed = None if seeds is None else seeds[i]
            if remat:
                p = _checkpointed(layer, p, pair_mask, mask, seed)
            else:
                p = layer(p, pair_mask, mask, seed)
        return p


def _checkpointed(layer: nn.Module, *args):
    """layer(*args) under non-reentrant checkpointing, as a pure function of
    its arguments and of the layer's current parameter tensors."""
    names, params = zip(*layer.named_parameters())

    def run(*inputs):
        return torch.func.functional_call(layer, dict(zip(names, inputs[len(args):])), inputs[:len(args)])

    # The masks come from the layer's seed, not from the global RNG, so its
    # state need not be saved and restored around the recompute.
    return checkpoint(run, *args, *params, use_reentrant=False, preserve_rng_state=False)
