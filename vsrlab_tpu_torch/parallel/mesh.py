"""A mesh of named axes over processes (port of ``vsrlab_tpu/parallel/mesh.py``).

One process a rank, as ``torchrun`` starts them. :func:`create_mesh` lays
the ranks out row-major over up to three named axes, as JAX lays its
devices out with ``np.asarray(devices).reshape(sizes)``:

* ``data``: every rank holds the whole model and trains on its own slice
  of each global batch. The trainers average the gradients over the ranks
  with one explicit all-reduce of a flat bucket (:func:`all_reduce_mean`)
  before the norm, the clip and the update, so that every rank takes the
  JAX step on the global batch.
* ``time``: the windows of a long clip are split over the ranks at
  inference (``evaluation.harness.windowed_inference(..., mesh)``).
* ``model``: the attention heads of a VRT-family model are split over the
  ranks (``head_shard_axis="model"``) inside :func:`use_mesh`.

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
* :func:`create_mesh` gives each axis one process group for each of its
  lines (the ranks that differ only in their index on that axis);
  :func:`use_mesh` makes a mesh the active one, which ``head_shard_axis``
  reads (JAX's ``with mesh:`` / ``jax.set_mesh``).
* :func:`batch_sharding` and :func:`clip_sharding` are the
  ``PartitionSpec``s ``P(axis)`` and ``P(batch_axis, time_axis)`` over a
  mesh; :func:`shard_batch_sp` takes this rank's block of a global batch.
* The trainers run the data axis only: :func:`data_parallel` puts every
  rank on it (sequence-parallel training needs a halo and carry exchange
  between the ranks, ROADMAP queue 1, item 1).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# the axes a mesh may have, in JAX's names
AXES = ("data", "time", "model")


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
class Mesh:
    """Named axes over the ranks, laid out row-major in ``names``' order:
    rank ``r`` sits at ``np.unravel_index(r, sizes)``. ``rank`` is this
    process's global rank (rank 0 alone logs and writes); ``groups`` holds
    its process group on each axis (None for an axis of size 1). The
    trainers read the ``data`` axis through ``size``, ``data_index``,
    ``group`` and :meth:`barrier`."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int = 0
    groups: Dict[str, Optional[object]] = field(default_factory=dict, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index on each axis."""
        return dict(zip(self.names, (int(i) for i in np.unravel_index(self.rank, self.sizes))))

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_group(self, axis: str):
        return self.groups.get(axis)

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along ``axis``, by index."""
        grid = np.arange(int(np.prod(self.sizes))).reshape(self.sizes)
        where = [self.coords[n] if n != axis else slice(None) for n in self.names]
        return [int(r) for r in grid[tuple(where)]]

    @property
    def size(self) -> int:
        """The data axis's size."""
        return self.shape.get("data", 1)

    @property
    def data_index(self) -> int:
        """This rank's index on the data axis: the loader's shard."""
        return self.coords.get("data", 0)

    @property
    def group(self):
        """The data axis's group (None for one rank: nothing to reduce)."""
        return self.axis_group("data")

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


# the trainers' name for the mesh they are given (its data axis)
DataMesh = Mesh


def mesh_layout(axes: Union[int, Dict[str, int], None], world: int
                ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``(names, sizes)`` of ``axes`` over ``world`` ranks: ``None`` puts every
    rank on ``data``, an int ``n`` is ``{"data": n}``, a dict names the
    axes (of :data:`AXES`) in layout order, one size of ``-1`` inferred.
    The sizes must multiply to ``world``."""
    if axes is None:
        axes = {"data": world}
    elif isinstance(axes, int):
        axes = {"data": axes}
    unknown = sorted(set(axes) - set(AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes: {unknown}")
    names, sizes = tuple(axes), [int(v) for v in axes.values()]
    if sizes.count(-1) == 1:
        known = int(np.prod([v for v in sizes if v != -1]))
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world or min(sizes) < 1:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {world} processes")
    return names, tuple(sizes)


def create_mesh(axes: Union[int, Dict[str, int], None] = None) -> Mesh:
    """The mesh of :func:`mesh_layout` over this process group's ranks, one
    process group for each line of each axis larger than 1 (the whole
    world's group where a line holds every rank). Every rank calls it, with
    the same ``axes``: each rank creates every group, in one order."""
    n = process_count()
    names, sizes = mesh_layout(axes, n)
    rank = process_index()
    grid = np.arange(n).reshape(sizes)
    groups: Dict[str, Optional[object]] = {}
    for a, name in enumerate(names):
        if sizes[a] == 1:
            groups[name] = None
            continue
        if sizes[a] == n:
            groups[name] = dist.group.WORLD
            continue
        for line in np.moveaxis(grid, a, -1).reshape(-1, sizes[a]):
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = group
    return Mesh(names, sizes, rank, groups)


_ACTIVE: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the active mesh inside the block (JAX's ``with mesh:``
    / ``jax.set_mesh``): a module with ``head_shard_axis`` splits its heads
    over that axis of the active mesh."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[Mesh]:
    """The innermost :func:`use_mesh`'s mesh, None outside one."""
    return _ACTIVE[-1] if _ACTIVE else None


def data_parallel(ddp: bool, device: Union[str, torch.device]
                  ) -> Tuple[torch.device, Mesh, bool]:
    """The trainers' set-up: with ``ddp``, join torchrun's group (none in a
    world of one) and take this rank's device; without it, one process
    (a larger world raises). Every rank is on the mesh's ``data`` axis.
    Returns ``(device, mesh, created)``, where ``created`` says that the
    caller is to destroy the group at its end."""
    created = False
    if ddp:
        created = initialize_distributed(device)
    elif _world_from_env() > 1:
        raise ValueError(f"train.ddp is false but WORLD_SIZE={_world_from_env()}: "
                         "launch one process, or set train.ddp=true")
    mesh = create_mesh()
    device = rank_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return device, mesh, created


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


@dataclass(frozen=True)
class Sharding:
    """A ``NamedSharding(mesh, P(*spec))``: ``spec[i]`` names the mesh axis
    that splits array axis ``i`` into equal contiguous blocks (None, or an
    axis past the spec: whole on every rank)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def index(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of an array of ``shape``, as JAX's
        ``shard.index``: a slice on each split axis, ``slice(None)`` on the
        others."""
        out = []
        for i, dim in enumerate(shape):
            axis = self.spec[i] if i < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            if axis not in self.mesh.shape:
                raise ValueError(f"mesh {self.mesh.shape} has no axis {axis!r}")
            n = self.mesh.shape[axis]
            if dim % n:
                raise ValueError(f"axis {i} of {tuple(shape)} does not split into {n} "
                                 f"equal parts over {axis!r}")
            per, k = dim // n, self.mesh.axis_index(axis)
            out.append(slice(k * per, (k + 1) * per))
        return tuple(out)


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Axis 0 (the batch) split over ``axis``, the rest whole: ``P(axis)``."""
    return Sharding(mesh, (axis,))


def clip_sharding(mesh: Mesh, batch_axis: str = "data", time_axis: str = "time") -> Sharding:
    """Clips ``(B, T, H, W, C)`` with the batch split over ``batch_axis`` and
    the frames over ``time_axis``: ``P(batch_axis, time_axis)``."""
    return Sharding(mesh, (batch_axis, time_axis))


def shard_batch_sp(batch: dict, mesh: Mesh, device: Union[str, torch.device] = "cpu",
                   batch_axis: str = "data", time_axis: str = "time") -> dict:
    """This rank's block of a global host batch under :func:`clip_sharding`
    (its rows of the batch axis and its frames of the time axis, the
    slices JAX's ``P(batch_axis, time_axis)`` gives a device), on
    ``device``."""
    sharding = clip_sharding(mesh, batch_axis, time_axis)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
        out[k] = t[sharding.index(t.shape)].to(device)
    return out


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


def all_reduce_sum(tensors: Iterable[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum ``tensors`` over the ranks of ``group`` in place, one flat bucket
    a dtype (a no-op without a group); returns them."""
    tensors = list(tensors)
    if group is not None and tensors:
        with torch.no_grad():
            _each_bucket(tensors, lambda flat: dist.all_reduce(flat, group=group))
    return tensors


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
    """Raise on every rank of ``group`` unless each holds the group's first
    rank's tensors bit for bit (a broadcast of that rank's flat copy,
    compared on each rank, and an all-reduce of the verdict)."""
    if group is None:
        return
    src = dist.get_process_group_ranks(group)[0]
    differ = 0
    for bucket in _buckets(_tensors(obj)).values():
        flat = _flatten_dense_tensors([t.detach() for t in bucket])
        ref = flat.clone()
        dist.broadcast(ref, src, group=group)
        differ += int(not torch.equal(flat.view(torch.uint8), ref.view(torch.uint8)))
    flag = torch.tensor([float(differ)], device=_tensors(obj)[0].device)
    dist.all_reduce(flag, group=group)
    if flag.item():
        raise RuntimeError(f"the ranks' {what} differ from rank {src}'s")
