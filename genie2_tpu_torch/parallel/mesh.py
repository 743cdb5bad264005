"""The ranks of torch.distributed as a (data x seq x model) grid: one process a card.

Counterpart of genie2_tpu/parallel/mesh.py's `data`, `seq` and `model`
axes. genie2_tpu runs one controller over a jax Mesh and lets XLA insert
the collectives; here every card has its own process (launched by
`torchrun`, or by `parallel/spawn.py`), and the code calls the collectives
itself. The W ranks form a grid of n_data x n_seq x n_model, `model`
innermost and `seq` next, as in genie2_tpu's `create_mesh`: rank r has
model index r % n_model, seq index (r // n_model) % n_seq and data index
r // (n_seq n_model). The model ranks of one (data, seq) index hold the
same rows and split the weights (parallel/tensor_parallel.py); the seq
ranks of one (data, model) index hold the same weights and batch rows and
split the pair representation's residue rows
(parallel/sequence_parallel.py); the helpers below shard and gather batch
rows over the data axis only:

  * training: each data index takes its rows of the global batch, and
    after the backward the gradients are all-reduced over the data group
    and divided by its size (train/state.py), as XLA's psum does for
    genie2_tpu;
  * sampling: each data index runs its rows of the sample batch (padded to
    a multiple of the data axis) or its particles, and the rows are
    gathered where the samplers need them all.

Every collective is an `all_reduce` or a `broadcast`: gathering rows is an
all-reduce SUM of a zero buffer in which each rank fills its own rows. gloo
implements only those two for CUDA tensors, so the same code runs over
NCCL, over gloo on the CPU and over gloo on CUDA tensors (two ranks on one
card, which NCCL refuses).

Every rank creates every group, in the same order (`dist.new_group` is a
collective of the whole world): the data groups (one per (seq, model)
index), the model groups (one per (data, seq) index), the seq groups (one
per (data, model) index) and, where n_seq > 1, the replica groups (one per
model index: the ranks that hold the same parameter shards, over which the
gradients are averaged).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from genie2_tpu_torch.utils.profiling import host_sync, span


@dataclass(frozen=True)
class Mesh:
    """This process's place in the (data x seq x model) grid: its rank, the
    world size, the device its tensors (and the collectives' buffers) live
    on, the model and seq axes' sizes and the process groups of this rank.
    A group None is torch.distributed's default group (the data group where
    n_seq and n_model are 1); there is no model group where n_model is 1
    and no seq group where n_seq is 1. The replica group is the data group
    where n_seq is 1."""

    rank: int
    world_size: int
    device: torch.device
    n_model: int = 1
    data_group: Any = None
    model_group: Any = None
    n_seq: int = 1
    seq_group: Any = None
    replica_group: Any = None

    @property
    def n_data(self) -> int:
        return self.world_size // (self.n_model * self.n_seq)

    @property
    def data_rank(self) -> int:
        return self.rank // (self.n_model * self.n_seq)

    @property
    def seq_rank(self) -> int:
        return (self.rank // self.n_model) % self.n_seq

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


def launcher_world_size() -> Optional[int]:
    """The world size of a torchrun launch (or of an initialised process
    group); None for a process started on its own."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return None


def init_from_launcher(device) -> None:
    """Initialise the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as
    `jax.distributed.initialize()` does for genie2_tpu: NCCL on the card,
    gloo on the CPU. Nothing to do where a group exists already."""
    if dist.is_initialized():
        return
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise ValueError(f"no launcher environment ({', '.join(missing)} unset): start the processes with "
                         "torchrun --nproc_per_node N")
    from genie2_tpu_torch.utils.model_io import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def create_mesh(n_data: int = -1, device=None, n_model: int = 1, n_seq: int = 1) -> Mesh:
    """The (data x seq x model) grid over every rank of the initialised
    process group: `n_seq` x `n_model` must divide the world size, and
    `n_data` is -1 or the world size over it (every rank holds a part of
    the grid). Creates every group on every rank."""
    # model_io imports the modules, which import parallel/: resolved here.
    from genie2_tpu_torch.utils.model_io import resolve_device

    if not dist.is_initialized():
        raise ValueError("create_mesh needs an initialised process group (torchrun, or init_from_launcher)")
    world = dist.get_world_size()
    if n_model < 1 or n_seq < 1 or world % (n_model * n_seq):
        raise ValueError(f"meshSeq {n_seq} x meshModel {n_model} must divide the world size ({world} ranks)")
    inner = n_model * n_seq
    if n_data not in (-1, world // inner):
        raise ValueError(f"meshData {n_data} must be -1 or the world size over meshSeq x meshModel "
                         f"({world} ranks / {inner} = {world // inner})")
    rank = dist.get_rank()

    def groups(members):
        """One new group of each rank list, in order; this rank's."""
        mine = None
        for ranks in members:
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        return mine

    ids = [(r // inner, (r // n_model) % n_seq, r % n_model) for r in range(world)]  # (data, seq, model)

    def along(axis):
        """The rank lists that differ only in `axis` (0 data, 1 seq, 2 model)."""
        keys = sorted({i[:axis] + i[axis + 1:] for i in ids})
        return [[r for r, i in enumerate(ids) if i[:axis] + i[axis + 1:] == k] for k in keys]

    data_group = model_group = seq_group = replica_group = None
    if inner > 1:
        model_group = groups(along(2)) if n_model > 1 else None
        data_group = groups(along(0))
    if n_seq > 1:
        seq_group = groups(along(1))
        replica_group = groups([[r for r, i in enumerate(ids) if i[2] == m] for m in range(n_model)])
    else:
        replica_group = data_group
    return Mesh(rank, world, resolve_device(device), n_model, data_group, model_group, n_seq, seq_group,
                replica_group)


def mesh_from_config(n_data: int, device=None, n_model: int = 1, n_seq: int = 1) -> Optional[Mesh]:
    """The training mesh of `meshData` x `meshSeq` x `meshModel`: over every
    rank of the initialised process group, or None in a process started
    alone, where `n_data` must be -1 or 1 and `n_seq` and `n_model` 1."""
    if dist.is_available() and dist.is_initialized():
        return create_mesh(n_data, device, n_model, n_seq)
    for key, n in (("meshData", n_data), ("meshSeq", n_seq), ("meshModel", n_model)):
        if n not in (-1, 1):
            raise ValueError(f"{key} {n} needs {n} ranks, and this process is alone: launch with "
                             f"torchrun --nproc_per_node {n}")
    return None


def mesh_from_arg(num_devices: Optional[int] = None, n_seq: int = 1, n_model: int = 1, device=None) -> Optional[Mesh]:
    """Resolve the CLIs' --num_devices, --mesh_seq and --mesh_model into a
    mesh; None means one process, no sharding. --num_devices counts every
    rank, data x seq x model, as in genie2_tpu: -1 means every rank of the
    launch; any other count must equal the launch's world size, and a count
    other than 1 needs a launcher, as genie2_tpu refuses more devices than
    it has. --mesh_seq x --mesh_model must divide it."""
    for flag, n in (("--mesh_seq", n_seq), ("--mesh_model", n_model)):
        if n < 1:
            raise ValueError(f"{flag} {n} must be at least 1")
    world = launcher_world_size()
    inner = n_seq * n_model
    if num_devices in (None, 1):
        if world is not None and world > 1:
            raise ValueError(f"launched with {world} ranks: pass --num_devices {world} (or -1)")
        for flag, n in (("--mesh_seq", n_seq), ("--mesh_model", n_model)):
            if n != 1:
                raise ValueError(f"{flag} {n} needs a torchrun launch of at least {n} ranks: "
                                 f"torchrun --nproc_per_node {n} ... --num_devices {n}")
        return None
    if world is None:
        raise ValueError(f"--num_devices {num_devices} needs one process a device: launch with "
                         "torchrun --nproc_per_node N")
    if num_devices not in (-1, world):
        raise ValueError(f"--num_devices {num_devices} but the launch has {world} ranks")
    if world < inner:
        raise ValueError(f"--mesh_seq {n_seq} x --mesh_model {n_model} needs at least {inner} devices; "
                         f"--num_devices resolves to {world}")
    if world % inner:
        raise ValueError(f"--num_devices {world} not divisible by --mesh_seq {n_seq} x --mesh_model {n_model} = "
                         f"{inner}")
    init_from_launcher(device)
    return create_mesh(-1, device, n_model, n_seq)


def data_axis_size(mesh: Optional[Mesh]) -> int:
    """The divisor of batch and particle counts: the data axis's size, 1
    without a mesh (the seq and model axes replicate batch rows)."""
    return 1 if mesh is None else mesh.n_data


def is_main(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes files and logs: rank 0, or the only one."""
    return mesh is None or mesh.rank == 0


def local_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global axis of `n` (divisible by the data
    axis): those of its data index, the same on every seq and model rank."""
    if mesh is None:
        return slice(0, n)
    per = n // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays or tensors): every
    process holds the same global batch and keeps its own part, as
    genie2_tpu's multi-host `shard_batch` feeds each process's devices."""
    n_data = data_axis_size(mesh)
    for k, v in batch.items():
        if getattr(v, "shape", None) and v.shape[0] % n_data:
            raise ValueError(
                f"batch axis {v.shape[0]} (key {k!r}) not divisible by the mesh 'data' axis ({n_data}); "
                "pick a divisible batchSize or shrink meshData"
            )
    if mesh is None:
        return batch
    return {k: v[local_rows(v.shape[0], mesh)] if getattr(v, "shape", None) else v for k, v in batch.items()}


def check_particles(n_particles: int, mesh: Optional[Mesh]):
    """Particles shard over the data axis and are never padded (a padded
    particle would join the resampling population): a count the data axis
    does not divide is an error, as in genie2_tpu."""
    n_data = data_axis_size(mesh)
    if n_particles % n_data:
        raise ValueError(
            f"num_particles={n_particles} must be divisible by the mesh 'data' axis ({n_data}) (particles are "
            "sharded, not padded: they interact through resampling); pick a divisible particle count or run "
            "without --num_devices")


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of `x` over the data axis (in place); `x` itself without a mesh."""
    if mesh is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return x


def gather_rows(mesh: Optional[Mesh], *tensors: torch.Tensor) -> List[torch.Tensor]:
    """Each data index's rows of each tensor, stacked in its order: the
    global tensors, on every rank. One all-reduce SUM over the data group
    of a zero-padded float32 buffer carries all of them: exact for float32
    values and for integers below 2^24, since every entry is one value plus
    zeros. Without a mesh, the tensors."""
    if mesh is None:
        return list(tensors)
    flat = [t.reshape(t.shape[0], -1).float() for t in tensors]
    n, n_data, d = flat[0].shape[0], mesh.n_data, mesh.data_rank
    widths = [f.shape[1] for f in flat]
    buf = torch.zeros(n * n_data, sum(widths), dtype=torch.float32, device=flat[0].device)
    buf[d * n:(d + 1) * n] = torch.cat(flat, dim=1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.data_group)
    out = []
    for t, part in zip(tensors, buf.split(widths, dim=1)):
        out.append(part.reshape(n * n_data, *t.shape[1:]).to(t.dtype))
    return out


GRAD_BUCKET_BYTES = 32 << 20  # the flattened gradient buckets of one all-reduce each


def average_gradients(grads: Sequence[torch.Tensor], mesh: Optional[Mesh]):
    """Replace each gradient by its mean over the data and seq axes (in
    place), in a few flattened buckets, each one all-reduce SUM over the
    replica group divided by its size, as genie2_tpu's psum over the data
    axis; nothing without a mesh. A seq rank's gradient is its share of its
    data index's, counted n_seq times over the seq group
    (parallel/sequence_parallel.py), so the mean over both axes is the
    data axis's mean. A sharded gradient is this model rank's shard,
    reduced with the same shard of the other data and seq indices. Every
    rank passes the same list: a gradient that is None on one rank is None
    on all (the same model and path) and is left out by the caller, since
    Adam skips a None gradient but would update its moments on a zero one."""
    if mesh is None or not grads:
        return
    with span("grad_allreduce"):
        buckets, size = [[]], 0
        for g in grads:
            if buckets[-1] and (size + g.numel() * g.element_size() > GRAD_BUCKET_BYTES
                                or g.dtype != buckets[-1][0].dtype):
                buckets.append([])
                size = 0
            buckets[-1].append(g)
            size += g.numel() * g.element_size()
        for bucket in buckets:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.replica_group)
            flat.div_(mesh.n_data * mesh.n_seq)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Whether `flag` is set on any rank (an all-reduce MAX): the ranks
    agree on it, so every one takes the same branch."""
    if mesh is None:
        return flag
    x = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    host_sync("any_rank", x)
    return bool(x.item() > 0)


def broadcast_int(value: int, mesh: Optional[Mesh]) -> int:
    """Rank 0's `value` on every rank."""
    if mesh is None:
        return value
    x = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.broadcast(x, src=0)
    host_sync("broadcast_int", x)
    return int(x.item())


def replicate(module_or_tensors, mesh: Optional[Mesh]):
    """Rank 0's parameters and buffers (of a module) or tensors (a sequence
    or a dict of them) on every rank, in place; returns the argument."""
    if mesh is None:
        return module_or_tensors
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors: Sequence[torch.Tensor] = list(module_or_tensors.state_dict().values())
    elif isinstance(module_or_tensors, dict):
        tensors = list(module_or_tensors.values())
    else:
        tensors = list(module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    return module_or_tensors


def barrier(mesh: Optional[Mesh]):
    """Wait for every rank (an all-reduce of one element on the mesh's device)."""
    if mesh is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device))


def pad_to_ranks(n: int, mesh: Optional[Mesh]) -> int:
    """`n` rounded up to a multiple of the data axis."""
    n_data = data_axis_size(mesh)
    return -(-n // n_data) * n_data


def repeat_first_rows(batch: Dict[str, np.ndarray], n_total: int) -> Dict[str, np.ndarray]:
    """A host batch grown to `n_total` rows by repeats of row 0."""
    reps = n_total - next(iter(batch.values())).shape[0]
    if reps == 0:
        return batch
    return {k: np.concatenate([v, np.repeat(v[:1], reps, axis=0)]) for k, v in batch.items()}
