"""Data parallelism across processes (port of ``vsrlab_tpu/parallel/mesh.py``,
the ``data`` axis).

One process a rank, as ``torchrun`` starts them; every rank holds the whole
model and trains on its own slice of each global batch. The trainers
average the gradients over the ranks with one explicit all-reduce of a
flat bucket (:func:`all_reduce_mean`) before the norm, the clip and the
update, so that every rank takes the JAX step on the global batch.

* :func:`initialize_distributed`: the ``env://`` rendezvous from torchrun's
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``;
  nothing where ``WORLD_SIZE`` is unset or 1, nothing a second time. The
  backend is NCCL where each rank has a card of its own (``device="cuda"``
  and at least ``LOCAL_WORLD_SIZE`` cards), gloo on the CPU or where the
  ranks share the one card the caller names (``device="cuda:0"``): NCCL
  refuses two ranks on one device. With CUDA tensors gloo implements
  ``all_reduce`` and ``broadcast`` only, so this module uses nothing else
  on tensors.
* :func:`rank_device`: a rank's device is ``cuda:LOCAL_RANK`` for
  ``"cuda"``, the one named for ``"cuda:k"``, the CPU for ``"cpu"``; it
  never falls back to the CPU.
* :func:`create_mesh` builds the data axis; a ``time`` axis larger than 1
  (sequence parallelism), :func:`clip_sharding` and :func:`shard_batch_sp`
  raise: they wait for a later slice (ROADMAP queue 1, item 6b).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

_SEQUENCE_PARALLEL = ("sequence parallelism over a 'time' mesh axis is not ported yet "
                      "(ROADMAP queue 1, item 6b)")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _world_from_env() -> int:
    return _env_int("WORLD_SIZE", 1)


def rank_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for ``"cuda"`` in a world of
    more than one rank, the device named otherwise. Raises where the local
    rank has no card of its own."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or _world_from_env() <= 1:
        return device
    local = _env_int("LOCAL_RANK", 0)
    if torch.cuda.is_available() and local >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local} has no card of its own ({torch.cuda.device_count()} visible): "
            "pass device=cuda:0 to run the ranks on one card (gloo)")
    return torch.device("cuda", local)


def default_backend(device: Union[str, torch.device]) -> str:
    """NCCL where each rank has a card of its own, gloo otherwise (the
    CPU, or ranks that share the card the caller named)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return "gloo"
    local_world = _env_int("LOCAL_WORLD_SIZE", _world_from_env())
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def initialize_distributed(device: Union[str, torch.device] = "cpu") -> bool:
    """Join the process group torchrun's environment describes, over
    :func:`default_backend`'s backend; ``device`` is the one the caller
    asked for (before :func:`rank_device`). Returns True where this call
    created the group (the caller then destroys it), False where
    ``WORLD_SIZE`` is unset or 1 or the group already exists."""
    world = _world_from_env()
    if world <= 1 or dist.is_initialized():
        return False
    backend = default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method="env://", rank=_env_int("RANK", 0),
                            world_size=world)
    return True


def process_index() -> int:
    """This rank (0 outside a process group): rank 0 alone logs, prints and
    writes checkpoints, as the JAX trainers gate on process 0."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass(frozen=True)
class DataMesh:
    """The data axis: ``size`` ranks, ``group`` the process group to reduce
    over (None for one rank: nothing to reduce)."""

    size: int
    rank: int
    group: Optional[object]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def create_mesh(axes: Union[int, Dict[str, int], None] = None) -> DataMesh:
    """The data axis over every rank: ``None`` or the rank count, an int
    equal to it, or ``{"data": n or -1, "time": 1}``. A ``time`` axis
    larger than 1 raises (sequence parallelism comes later)."""
    n = process_count()
    if axes is None:
        axes = {"data": n}
    elif isinstance(axes, int):
        axes = {"data": axes}
    axes = dict(axes)
    if axes.pop("time", 1) != 1:
        raise NotImplementedError(_SEQUENCE_PARALLEL)
    if set(axes) - {"data"}:
        raise ValueError(f"unknown mesh axes: {sorted(set(axes) - {'data'})}")
    size = axes.get("data", n)
    size = n if size == -1 else size
    if size != n:
        raise ValueError(f"mesh data={size} != {n} processes")
    return DataMesh(size, process_index(), dist.group.WORLD if n > 1 else None)


def data_parallel(ddp: bool, device: Union[str, torch.device]
                  ) -> Tuple[torch.device, DataMesh, bool]:
    """The trainers' set-up: with ``ddp``, join torchrun's group (none in a
    world of one) and take this rank's device; without it, one process
    (a larger world raises). Returns ``(device, mesh, created)``, where
    ``created`` says that the caller is to destroy the group at its end."""
    created = False
    if ddp:
        created = initialize_distributed(device)
    elif _world_from_env() > 1:
        raise ValueError(f"train.ddp is false but WORLD_SIZE={_world_from_env()}: "
                         "launch one process, or set train.ddp=true")
    device = rank_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device, create_mesh(), created


@contextlib.contextmanager
def stdout_on_rank0(rank: int):
    """This process's standard output, silenced unless it is rank 0."""
    if rank == 0:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def shard_slice(global_batch: int, num_shards: int, shard_index: int) -> slice:
    """Shard ``shard_index``'s contiguous rows of a global batch cut into
    ``num_shards`` equal parts: the one rule by which the loader
    (``data/loader.py``) and :func:`local_batch_slice` slice a batch."""
    per = global_batch // num_shards
    return slice(shard_index * per, (shard_index + 1) * per)


def local_batch_slice(global_batch: int, axis_size: Optional[int] = None) -> slice:
    """This rank's slice of a globally indexed batch."""
    return shard_slice(global_batch, process_count() if axis_size is None else axis_size,
                       process_index())


def shard_batch(batch: dict, device: Union[str, torch.device] = "cpu") -> dict:
    """This rank's rows of a global host batch (arrays or tensors with the
    global batch on axis 0), on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
        out[k] = t[local_batch_slice(t.shape[0])].to(device)
    return out


def clip_sharding(*_, **__):
    """Frames of a clip over a ``time`` axis: not ported yet."""
    raise NotImplementedError(_SEQUENCE_PARALLEL)


def shard_batch_sp(*_, **__):
    """A batch sharded over batch and time: not ported yet."""
    raise NotImplementedError(_SEQUENCE_PARALLEL)


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.nn.Module):
        # written in place under no_grad: the version counters see it
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, dict):
        return list(obj.values())
    return list(obj)


def _buckets(tensors: List[torch.Tensor]) -> Dict[tuple, List[torch.Tensor]]:
    """The tensors by (device, dtype), in order: one flat bucket each."""
    out: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault((t.device, t.dtype), []).append(t)
    return out


def _each_bucket(tensors, fn) -> None:
    for bucket in _buckets(tensors).values():
        flat = _flatten_dense_tensors(bucket)
        fn(flat)
        for t, new in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(new)


def all_reduce_mean(tensors: Iterable[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Average ``tensors`` over the ranks of ``group`` in place, one flat
    bucket a dtype (a no-op without a group); returns them. Every rank
    passes the same tensors in the same order."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    size = dist.get_world_size(group)

    def reduce(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(size)

    with torch.no_grad():
        _each_bucket(tensors, reduce)
    return tensors


def reduce_metrics(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """0-d metric tensors averaged over the ranks (one all-reduce), so that
    rank 0 logs the global means."""
    if group is None or not metrics:
        return metrics
    stacked = torch.stack([v.detach().float() for v in metrics.values()])
    all_reduce_mean([stacked], group)
    return dict(zip(metrics, stacked.unbind()))


def replicated(obj, group=None, src: int = 0):
    """Broadcast the parameters and buffers of a module (or a list / dict
    of tensors) from rank ``src`` in place: every rank then starts from
    the same state. A no-op without a group; returns ``obj``."""
    if group is not None:
        with torch.no_grad():
            _each_bucket(_tensors(obj), lambda flat: dist.broadcast(flat, src, group=group))
    return obj


def assert_replicated(obj, group=None, what: str = "state") -> None:
    """Raise on every rank unless every rank holds rank 0's tensors bit for
    bit (a broadcast of rank 0's flat copy, compared on each rank, and an
    all-reduce of the verdict)."""
    if group is None:
        return
    differ = 0
    for bucket in _buckets(_tensors(obj)).values():
        flat = _flatten_dense_tensors([t.detach() for t in bucket])
        ref = flat.clone()
        dist.broadcast(ref, 0, group=group)
        differ += int(not torch.equal(flat.view(torch.uint8), ref.view(torch.uint8)))
    flag = torch.tensor([float(differ)], device=_tensors(obj)[0].device)
    dist.all_reduce(flag, group=group)
    if flag.item():
        raise RuntimeError(f"the ranks' {what} differ from rank 0's")
