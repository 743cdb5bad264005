"""Sequence parallelism: the pair representation's residue rows over a seq group.

Counterpart of genie2_tpu's `seq` mesh axis (genie2_tpu/parallel/mesh.py
`pair_sharding`, P("data", "seq")), where GSPMD partitions the program.
Here each rank of a seq group (the seq ranks of one (data, model) index,
parallel/mesh.py) holds rows [r N/n, (r + 1) N/n) of every residue-indexed
pair activation, [B, N/n, N, c_p], through the whole pair stack and the
structure module, and the modules call the collectives themselves:

  gather_seq_rows  every rank's rows of a tensor, stacked along a row
                   axis: one all-reduce SUM of a zero-padded float32
                   buffer (exact: every entry is one value plus zeros);
  reduce_seq_rows  the sum over the group of each rank's partial sums,
                   then this rank's rows of it.

The single representation, the frames, the masks and the output z stay
whole (replicated) on every seq rank; the weights are replicated.
A residue length that the seq axis does not divide is padded with masked
residues to a multiple of it (`padded_length`), and the real residues' z
is given back (nn/denoiser.py).

The gradient rule. Every seq rank computes the same replicated output
(z), so every rank seeds the backward with the same cotangent: the
backward of the whole group then computes n_seq times each gradient,
spread over the ranks. With that one convention every collective has one
backward, whoever consumes its output:

  gather_seq_rows  backward: the cotangents of the gathered tensor summed
                   over the group (each rank's is its share), then this
                   rank's rows: a reduce_seq_rows;
  reduce_seq_rows  backward: the cotangents of every rank's rows,
                   gathered: a gather_seq_rows;
  a slice of a replicated tensor (this rank's rows of it) or a replicated
                   tensor read by a row-sharded computation: no collective;
                   the tensor's gradient on this rank is its share.

So the gradient of a replicated tensor or a parameter on a seq rank is a
share, and the sum of the shares over the seq group is n_seq times the
gradient: the training step averages the gradients over the data and seq
axes in one all-reduce (mesh.py:average_gradients), and the denoiser's
input frames pass through `mean_grad_over_seq` (identity forward, the
mean over the seq group in the backward), so the gradient of x_t that
twisted SMC takes is whole on every rank. Remat (nn/pair_stack.py)
reruns a layer's gathers in the backward; the backward runs the same
graph in the same order on every rank, so the ranks meet in the same
collectives.

The counters `allreduce_bytes.seq.<forward|backward>` (utils/profiling.py)
count the bytes all-reduced over the seq group (forward: both
collectives; backward: their backward and `mean_grad_over_seq`'s), each
inside the span `seq_allreduce`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import torch
import torch.distributed as dist
from torch import nn

from genie2_tpu_torch.utils.profiling import count, span

count("allreduce_bytes.seq.forward", 0)
count("allreduce_bytes.seq.backward", 0)


@dataclass(frozen=True)
class SeqGroup:
    """This rank's place in its seq group: index, size and the process
    group. Modules hold it; a copy of a module (the bf16 cast) shares it."""

    rank: int
    size: int
    group: Any = None

    def __deepcopy__(self, memo):
        return self


def padded_length(n: int, seq: SeqGroup) -> int:
    """`n` residues rounded up to a multiple of the seq axis."""
    return -(-n // seq.size) * seq.size


def row_slice(n: int, seq: SeqGroup) -> slice:
    """This rank's rows of `n` residues (a multiple of the seq axis)."""
    if n % seq.size:
        raise ValueError(f"{n} residue rows not divisible by the seq axis ({seq.size}); pad them (padded_length)")
    per = n // seq.size
    return slice(seq.rank * per, (seq.rank + 1) * per)


def _all_reduce(buf: torch.Tensor, seq: SeqGroup, direction: str) -> torch.Tensor:
    with span("seq_allreduce"):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=seq.group)
    count(f"allreduce_bytes.seq.{direction}", buf.numel() * buf.element_size())
    return buf


def _gather(tensors, dim: int, seq: SeqGroup, direction: str) -> List[torch.Tensor]:
    """Every rank's rows (axis `dim`) of each tensor, on every rank: one
    float32 buffer [P, n_seq I, sum S], P the product of the axes before
    `dim` (the same for every tensor) and S of those after it."""
    lead, rows = tensors[0].shape[:dim], tensors[0].shape[dim]
    flat = [t.reshape(lead.numel(), rows, -1) for t in tensors]
    widths = [f.shape[-1] for f in flat]
    buf = torch.zeros(lead.numel(), rows * seq.size, sum(widths), dtype=torch.float32, device=flat[0].device)
    buf[:, seq.rank * rows:(seq.rank + 1) * rows] = torch.cat([f.float() for f in flat], dim=-1)
    _all_reduce(buf, seq, direction)
    return [part.reshape(*lead, rows * seq.size, *t.shape[dim + 1:]).to(t.dtype).contiguous()
            for t, part in zip(tensors, buf.split(widths, dim=-1))]


def _reduce(tensors, dim: int, seq: SeqGroup, direction: str) -> List[torch.Tensor]:
    """The sum over the group of each tensor (in float32, one buffer), then
    this rank's rows (axis `dim`) of it."""
    lead, n = tensors[0].shape[:dim], tensors[0].shape[dim]
    flat = [t.reshape(lead.numel(), n, -1) for t in tensors]
    widths = [f.shape[-1] for f in flat]
    buf = _all_reduce(torch.cat([f.float() for f in flat], dim=-1), seq, direction)
    mine = buf[:, row_slice(n, seq)]
    return [part.reshape(*lead, n // seq.size, *t.shape[dim + 1:]).to(t.dtype).contiguous()
            for t, part in zip(tensors, mine.split(widths, dim=-1))]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seq, dim, *tensors):
        ctx.seq, ctx.dim = seq, dim
        out = _gather(tensors, dim, seq, "forward")
        ctx.like = [(o.shape, o.dtype, o.device) for o in out]
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        # An output without a cotangent (unused downstream) takes zeros: every
        # rank all-reduces the same buffer layout.
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None else g.contiguous()
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        return (None, None, *_reduce(grads, ctx.dim, ctx.seq, "backward"))


class _ReduceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seq, dim, x):
        ctx.seq, ctx.dim = seq, dim
        return _reduce([x], dim, seq, "forward")[0]

    @staticmethod
    def backward(ctx, grad):
        return None, None, _gather([grad.contiguous()], ctx.dim, ctx.seq, "backward")[0]


class _MeanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seq, *tensors):
        ctx.seq = seq
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        seq = ctx.seq
        return (None, *(None if g is None else
                        _all_reduce(g.to(torch.float32, copy=True), seq, "backward").div_(seq.size).to(g.dtype)
                        for g in grads))


def gather_seq_rows(seq: SeqGroup, dim: int, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """Every seq rank's rows of each tensor along axis `dim` (this rank's
    rows of a row-sharded tensor; the axes before `dim` alike in all of
    them), stacked in rank order: the whole tensors, on every rank, in one
    all-reduce. Backward: reduce_seq_rows of the cotangents (module
    docstring). Distinct from mesh.py:gather_rows, which gathers batch rows
    over the data axis."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(_GatherRows.apply(seq, dim, *tensors))
    return _gather(tensors, dim, seq, "forward")


def reduce_seq_rows(x: torch.Tensor, seq: SeqGroup, dim: int) -> torch.Tensor:
    """The sum of the partial sums `x` over the seq group (in float32, in
    x's dtype), this rank's rows of it along axis `dim`. Backward:
    gather_seq_rows of the cotangents."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceRows.apply(seq, dim, x)
    return _reduce([x], dim, seq, "forward")[0]


def mean_grad_over_seq(seq: SeqGroup, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """The replicated inputs of a row-sharded computation: the identity,
    whose gradient is the mean over the seq group of the ranks' shares
    (each n_seq times its share of the gradient, module docstring): the
    whole gradient, on every rank. Nothing where no gradient is recorded."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(_MeanGrad.apply(seq, *tensors))
    return list(tensors)


def shard_sequence(model: nn.Module, mesh) -> nn.Module:
    """Make a full model row-sharded over the mesh's seq group: every module
    with a `seq` attribute (the denoiser and the modules of its pair stack
    and structure module) takes this rank's SeqGroup. Nothing without a seq
    axis. The weights stay whole. Returns the model."""
    if mesh is None or mesh.n_seq == 1:
        return model
    group = SeqGroup(mesh.seq_rank, mesh.n_seq, mesh.seq_group)
    for module in model.modules():
        if hasattr(type(module), "seq"):
            module.seq = group
    return model
