"""Parallelism across processes (port of ``vsrlab_tpu/parallel``): torchrun's
rendezvous, a mesh of named axes over the ranks (``data``, ``time``,
``model``) with one process group for each line of each axis, the active
mesh that head-sharded attention reads, the placement specs, this rank's
device and batch slice, the parameters broadcast from rank 0, the
gradients and metrics averaged over the data axis by one explicit
all-reduce of a flat bucket, and what the ranks of a time line hand each
other in sequence-parallel training (``sequence.TimeLinks``): halo frames,
recurrence carries, and the frames of attention windows that straddle
them (``sequence.window_plan``)."""

from vsrlab_tpu_torch.parallel.mesh import (
    AXES,
    DataMesh,
    Mesh,
    Sharding,
    active_links,
    active_mesh,
    all_reduce_mean,
    all_reduce_sharded_grads,
    all_reduce_sum,
    assert_replicated,
    batch_sharding,
    check_step_group,
    clip_sharding,
    create_mesh,
    data_parallel,
    default_backend,
    initialize_distributed,
    local_batch_slice,
    mesh_layout,
    process_count,
    process_index,
    rank_device,
    reduce_metrics,
    replicated,
    shard_batch,
    shard_batch_sp,
    shard_slice,
    stdout_on_rank0,
    use_mesh,
)
from vsrlab_tpu_torch.parallel.sequence import TimeLinks, WindowPlan, window_plan

__all__ = [
    "AXES",
    "DataMesh",
    "Mesh",
    "Sharding",
    "TimeLinks",
    "WindowPlan",
    "active_links",
    "active_mesh",
    "all_reduce_mean",
    "all_reduce_sharded_grads",
    "all_reduce_sum",
    "assert_replicated",
    "batch_sharding",
    "check_step_group",
    "clip_sharding",
    "create_mesh",
    "data_parallel",
    "default_backend",
    "initialize_distributed",
    "local_batch_slice",
    "mesh_layout",
    "process_count",
    "process_index",
    "rank_device",
    "reduce_metrics",
    "replicated",
    "shard_batch",
    "shard_batch_sp",
    "shard_slice",
    "stdout_on_rank0",
    "use_mesh",
    "window_plan",
]
