"""Data parallelism across processes (port of ``vsrlab_tpu/parallel``, the
data axis): torchrun's rendezvous, this rank's device and batch slice, the
parameters broadcast from rank 0, and the gradients and metrics averaged
over the ranks by one explicit all-reduce of a flat bucket. Sequence
parallelism over a ``time`` axis waits for a later slice."""

from vsrlab_tpu_torch.parallel.mesh import (
    DataMesh,
    all_reduce_mean,
    assert_replicated,
    clip_sharding,
    create_mesh,
    data_parallel,
    default_backend,
    initialize_distributed,
    local_batch_slice,
    process_count,
    process_index,
    rank_device,
    reduce_metrics,
    replicated,
    shard_batch,
    shard_batch_sp,
    shard_slice,
    stdout_on_rank0,
)

__all__ = [
    "DataMesh",
    "all_reduce_mean",
    "assert_replicated",
    "clip_sharding",
    "create_mesh",
    "data_parallel",
    "default_backend",
    "initialize_distributed",
    "local_batch_slice",
    "process_count",
    "process_index",
    "rank_device",
    "reduce_metrics",
    "replicated",
    "shard_batch",
    "shard_batch_sp",
    "shard_slice",
    "stdout_on_rank0",
]
