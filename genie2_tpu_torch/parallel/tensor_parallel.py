"""Tensor (model) parallelism: Megatron column / row pairs over a model group.

Counterpart of genie2_tpu/parallel/tensor_parallel.py. genie2_tpu shards
the weights by a path -> PartitionSpec table and lets GSPMD partition the
program and insert the psums. Here each rank of a model group (the model
ranks of one data index, parallel/mesh.py) holds its shard of each split
parameter, and the modules call the collectives themselves through two
autograd Functions:

  copy_to_model      identity forward; backward: all-reduce SUM of the
                     gradient over the model group;
  reduce_from_model  forward: all-reduce SUM over the model group;
                     identity backward.

Every replicated tensor that enters a computation split by head or channel
passes through `copy_to_model`: the activations, and the replicated
parameters whose use is split (the TriMul's LN_in, fused into its
projection kernel, and its LN_out; the IPA's head weights and frames).
Every partial sum leaves through `reduce_from_model`, and the bias of a
row-split linear is added once, after it. The gradients of replicated
parameters then come out complete and equal on every model rank, those of
split ones stay local, and only the data group all-reduces gradients.

The split parameters are exactly those genie2_tpu's `tp_spec` shards
(`_RULES`, on the port's names: utils/weights.py maps the flax paths), and
what differs is the index map: the port computes locally, so it selects
whole heads or hidden channels, never a flat slice. A dimension is one or
more head-major blocks (each rule's layout): one block for most; the thirds of the
IPA point projections (x, y, z; nn/structure.py:_to_points); the six
blocks of the IPA's `linear_out` input (o, o_pt x, y, z, |o_pt|, o_pair).
A rank takes its heads' part of each block. Where a module's heads or
hidden channels do not divide the model axis, the whole module stays
replicated (and correct): a module's owner (`tp_units`) decides for all of
its parameters.

The modules that split (nn/pair_stack.py, nn/primitives.py,
nn/structure.py) define `tp_units()` (their heads or hidden channels) and
`shard_(group)` (their local counts, the group their forward reduces
over); `shard_model` slices a full model in place and records its plan on
it, `gather_state_dict` / `slice_state_dict` convert between full state
dicts and this rank's shards, and `place_train_state` /
`gather_train_state` do the same for a training state (the parameters,
Adam's moments, the EMA). Every collective is an all-reduce: a full tensor
is gathered as the sum of zero-padded buffers, as mesh.py:gather_rows.

The counters `allreduce_bytes.tp.<forward|backward>` (utils/profiling.py)
count the bytes all-reduced over the model group (forward:
reduce_from_model; backward: copy_to_model), each inside the span
`tp_allreduce`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from genie2_tpu_torch.parallel.sequence_parallel import shard_sequence
from genie2_tpu_torch.utils.profiling import count, span

# (state_dict name pattern, dimension split, layout). Linear weights are
# [out, in]: dimension 0 splits the output features (column parallel), 1
# the input ones (row parallel); a bias follows its weight's output.
_RULES = (
    # pair transition: up / down pair
    (r"pair_transition\.linear_1\.(weight|bias)$", 0, "one"),
    (r"pair_transition\.linear_2\.weight$", 1, "one"),
    # triangle multiplicative update: the hidden channels
    (r"tri_mul_(in|out)\.linear_[ab]_[pg]\.(weight|bias)$", 0, "one"),
    (r"tri_mul_(in|out)\.linear_z\.weight$", 1, "one"),
    # triangle attention: heads
    (r"tri_att_(start|end)\.mha\.linear_[qkvg]\.weight$", 0, "one"),
    (r"tri_att_(start|end)\.mha\.linear_g\.bias$", 0, "one"),
    (r"tri_att_(start|end)\.mha\.linear_o\.weight$", 1, "one"),
    (r"tri_att_(start|end)\.linear\.weight$", 0, "one"),  # bias heads
    # IPA: heads
    (r"ipa\.linear_(q|kv|b)\.(weight|bias)$", 0, "one"),
    (r"ipa\.linear_(q_points|kv_points)\.(weight|bias)$", 0, "thirds"),
    (r"ipa\.linear_out\.weight$", 1, "ipa_out"),
    # structure transition: the first up / down pair of the chain of three
    (r"transition\.layers\.0\.linear_1\.(weight|bias)$", 0, "one"),
    (r"transition\.layers\.0\.linear_2\.weight$", 1, "one"),
)
_COMPILED = tuple((re.compile(pattern), dim, layout) for pattern, dim, layout in _RULES)

count("allreduce_bytes.tp.forward", 0)
count("allreduce_bytes.tp.backward", 0)


@dataclass(frozen=True)
class ModelGroup:
    """This rank's place in its model group: index, size and the process
    group. Modules hold it; a copy of a module (the bf16 cast) shares it."""

    rank: int
    size: int
    group: Any = None

    def __deepcopy__(self, memo):
        return self


def _all_reduce(x: torch.Tensor, tp: ModelGroup, direction: str) -> torch.Tensor:
    """The sum over the model group of a float32 copy of `x`, in x's dtype."""
    buf = x.to(torch.float32, copy=True)
    with span("tp_allreduce"):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=tp.group)
    count(f"allreduce_bytes.tp.{direction}", buf.numel() * buf.element_size())
    return buf.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp, "backward"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp, "forward")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """`x` as the input of a computation split over the model group: the
    identity, whose gradient is summed over the group."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModel.apply(x, tp)
    return x


def reduce_from_model(x: torch.Tensor, tp: ModelGroup) -> torch.Tensor:
    """The sum of the partial sums `x` over the model group (in float32),
    whose gradient passes through unchanged."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, tp)
    return _all_reduce(x, tp, "forward")


# --------------------------------------------------------------------- #
# The plan
# --------------------------------------------------------------------- #


@dataclass
class Plan:
    """A sharded model's plan: its model group and, for each split
    parameter, (dimension, the dimension's full head-major blocks)."""

    group: ModelGroup
    params: Dict[str, Tuple[int, Tuple[int, ...]]]


def _rule(name: str):
    for pattern, dim, layout in _COMPILED:
        if pattern.search(name):
            return dim, layout
    return None


def _owner(model: nn.Module, name: str) -> Tuple[str, Optional[nn.Module]]:
    """The innermost module on the path of parameter `name` that splits
    (defines `tp_units`), and its name."""
    parts = name.split(".")[:-1]
    found = ("", None)
    for i in range(len(parts) + 1):
        module = model.get_submodule(".".join(parts[:i]))
        if hasattr(module, "tp_units"):
            found = (".".join(parts[:i]), module)
    return found


def _blocks(owner: nn.Module, layout: str, size: int) -> Tuple[int, ...]:
    if layout == "one":
        return (size,)
    if layout == "thirds":
        return (size // 3,) * 3
    return owner.out_blocks()  # "ipa_out"


def _plan(model: nn.Module, n_model: int) -> Tuple[Dict[str, Tuple[int, Tuple[int, ...]]], Dict[str, nn.Module]]:
    """({parameter: (dimension, blocks)}, {owner name: owner}) of a full
    model split over `n_model` ranks: the parameters a rule names whose
    owner's heads or channels `n_model` divides."""
    params, owners = {}, {}
    for name, p in model.named_parameters():
        rule = _rule(name)
        if rule is None or n_model == 1:
            continue
        owner_name, owner = _owner(model, name)
        if owner is None or owner.tp_units() % n_model:
            continue
        dim, layout = rule
        params[name] = (dim, _blocks(owner, layout, p.shape[dim]))
        owners[owner_name] = owner
    return params, owners


def split_parameters(model: nn.Module, n_model: int) -> Dict[str, int]:
    """{name: dimension} of the parameters of a full model that are split
    over `n_model` model ranks; the others are replicated."""
    return {name: dim for name, (dim, _) in _plan(model, n_model)[0].items()}


def tp_spec(model: nn.Module, name: str, n_model: int) -> Optional[int]:
    """The dimension of parameter `name` of a full model that is split over
    `n_model` model ranks, or None where it is replicated."""
    return split_parameters(model, n_model).get(name)


def _indices(blocks: Sequence[int], rank: int, size: int, device) -> torch.Tensor:
    """Rank `rank` of `size`'s indices along a dimension of head-major
    `blocks`: its part of each block."""
    out, start = [], 0
    for b in blocks:
        per = b // size
        out.append(torch.arange(start + rank * per, start + (rank + 1) * per, device=device))
        start += b
    return torch.cat(out)


def tp_plan(model: nn.Module) -> Optional[Plan]:
    """The plan `shard_model` recorded on a model, or None (not sharded)."""
    return getattr(model, "tp_plan", None)


@torch.no_grad()
def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Place a full model on the mesh, in place: row-sharded over its seq
    group (parallel/sequence_parallel.py:shard_sequence; the weights stay
    whole) and sliced to this rank's shards over its model group, with the
    plan recorded on it (`tp_plan`); genie2_tpu's `place_params`. Nothing
    without a seq or model axis. Returns the model."""
    shard_sequence(model, mesh)
    if mesh is None or mesh.n_model == 1:
        return model
    if tp_plan(model) is not None:
        raise ValueError("the model is sharded already")
    group = ModelGroup(mesh.model_rank, mesh.n_model, mesh.model_group)
    params, owners = _plan(model, group.size)
    for name, (dim, blocks) in params.items():
        module_name, leaf = name.rsplit(".", 1)
        module = model.get_submodule(module_name)
        full = getattr(module, leaf)
        local = full.index_select(dim, _indices(blocks, group.rank, group.size, full.device))
        setattr(module, leaf, nn.Parameter(local, requires_grad=full.requires_grad))
    for owner in owners.values():
        owner.shard_(group)
    model.tp_plan = Plan(group, params)
    return model


def slice_state_dict(state: Dict[str, torch.Tensor], plan: Optional[Plan]) -> Dict[str, torch.Tensor]:
    """This rank's shards of a full state dict (keyed like the model's
    parameters; others pass as they are)."""
    if plan is None:
        return state
    out = dict(state)
    for name, (dim, blocks) in plan.params.items():
        if name in out:
            t = out[name]
            out[name] = t.index_select(dim, _indices(blocks, plan.group.rank, plan.group.size, t.device))
    return out


def gather_state_dict(state: Dict[str, torch.Tensor], plan: Optional[Plan]) -> Dict[str, torch.Tensor]:
    """The full state dict from every model rank's shards, on every rank:
    one all-reduce SUM over the model group of a float32 buffer in which
    each rank fills its own part of each split tensor (exact: every entry
    is one value plus zeros). A collective: every model rank calls it."""
    if plan is None:
        return state
    names = [n for n in plan.params if n in state]
    if not names:
        return dict(state)
    g = plan.group
    shapes, flat = [], []
    for n in names:
        dim, _ = plan.params[n]
        t = state[n]
        shape = list(t.shape)
        shape[dim] *= g.size
        full = torch.zeros(shape, dtype=torch.float32, device=t.device)
        full.index_copy_(dim, _indices(plan.params[n][1], g.rank, g.size, t.device), t.float())
        shapes.append(shape)
        flat.append(full.reshape(-1))
    buf = torch.cat(flat)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g.group)
    out = dict(state)
    for n, shape, part in zip(names, shapes, buf.split([f.numel() for f in flat])):
        out[n] = part.view(shape).to(state[n].dtype)
    return out


def _adam_moments(blob: Dict, model: nn.Module, fn) -> Dict:
    """The optimizer state dict of `blob` with `fn` applied to the moments
    of each parameter, keyed by name (Adam's state is keyed by the index in
    model.parameters())."""
    opt = blob["opt_state"]
    names = [n for n, _ in model.named_parameters()]
    keys = ("exp_avg", "exp_avg_sq")
    moments = {f"{names[i]}/{k}": s[k] for i, s in opt["state"].items() for k in keys if k in s}
    done = fn(moments)
    state = {i: {**s, **{k: done[f"{names[i]}/{k}"] for k in keys if k in s}} for i, s in opt["state"].items()}
    return {**opt, "state": state}


def _by_moment(plan: Plan) -> Plan:
    """The plan with an entry for each Adam moment of each split parameter."""
    return Plan(plan.group, {f"{n}/{k}": v for n, v in plan.params.items() for k in ("exp_avg", "exp_avg_sq")})


def place_train_state(blob: Dict, model: nn.Module) -> Dict:
    """A full training state (train/state.py: `params`, `opt_state`,
    `step`, `ema`) as this rank's shards of a model sharded by
    `shard_model`: the parameters, Adam's moments and the EMA split as the
    parameters are. Where the model is not sharded, the blob."""
    plan = tp_plan(model)
    if plan is None:
        return blob
    out = {**blob, "params": slice_state_dict(blob["params"], plan),
           "opt_state": _adam_moments(blob, model, lambda m: slice_state_dict(m, _by_moment(plan)))}
    if blob.get("ema") is not None:
        out["ema"] = slice_state_dict(blob["ema"], plan)
    return out


def gather_train_state(blob: Dict, model: nn.Module) -> Dict:
    """The inverse of `place_train_state`, on every rank (collectives)."""
    plan = tp_plan(model)
    if plan is None:
        return blob
    out = {**blob, "params": gather_state_dict(blob["params"], plan),
           "opt_state": _adam_moments(blob, model, lambda m: gather_state_dict(m, _by_moment(plan)))}
    if blob.get("ema") is not None:
        out["ema"] = gather_state_dict(blob["ema"], plan)
    return out


def grad_norm(model: nn.Module) -> torch.Tensor:
    """The global norm of the model's gradients (optax.global_norm of the
    full model): the squares of split gradients summed over the model
    group, each replicated gradient (equal on every model rank) once."""
    plan = tp_plan(model)
    if plan is None:
        return torch.sqrt(torch.stack([p.grad.square().sum() for p in model.parameters() if p.grad is not None]).sum())
    squares: List[List[torch.Tensor]] = [[], []]
    for name, p in model.named_parameters():
        if p.grad is not None:
            squares[name in plan.params].append(p.grad.square().sum())
    total = [torch.stack(s).sum() if s else None for s in squares]
    if total[1] is not None:
        dist.all_reduce(total[1], op=dist.ReduceOp.SUM, group=plan.group.group)
    return torch.sqrt(sum(t for t in total if t is not None))


def tp_stats(model: nn.Module, n_model: int) -> Dict[str, Any]:
    """How much of a full model the plan splits over `n_model` ranks (for
    logs and tests), as genie2_tpu's `tp_stats`."""
    params, _ = _plan(model, n_model)
    total = sharded = 0
    for name, p in model.named_parameters():
        nbytes = p.numel() * p.element_size()
        total += nbytes
        sharded += nbytes if name in params else 0
    return {"axis_size": n_model, "total_mb": round(total / 2**20, 2),
            "sharded_frac": round(sharded / max(total, 1), 4)}


def create_tp_mesh(n_data: int = -1, n_model: int = 2, device=None):
    """The (data x model) grid over the initialised process group, model
    innermost (parallel/mesh.py:create_mesh)."""
    from genie2_tpu_torch.parallel.mesh import create_mesh

    return create_mesh(n_data, device, n_model)
