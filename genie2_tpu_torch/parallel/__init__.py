"""Data parallelism over torch.distributed (genie2_tpu/parallel's `data` axis)."""

from genie2_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    any_rank,
    barrier,
    broadcast_int,
    create_mesh,
    data_axis_size,
    gather_rows,
    init_from_launcher,
    is_main,
    local_rows,
    mesh_from_arg,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "all_reduce_sum",
    "any_rank",
    "barrier",
    "broadcast_int",
    "create_mesh",
    "data_axis_size",
    "gather_rows",
    "init_from_launcher",
    "is_main",
    "local_rows",
    "mesh_from_arg",
    "replicate",
    "shard_batch",
]
