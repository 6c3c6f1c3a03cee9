"""Device-mesh utilities: shard assignment and batch placements from ``torch.distributed``.

Counterpart of ``petastorm_tpu/parallel/mesh.py``.  PyTorch runs one process
per card, so the process topology is the ``torch.distributed`` rank and world
size, and a process owns exactly one coordinate of the mesh:

* data-shard identity  <- ``torch.distributed.get_rank()/get_world_size()``
  (``shard_options_from_torch``), or ``(0, 1)`` without an initialized group;
* a mesh               <- ``torch.distributed.device_mesh.DeviceMesh`` with
  named dimensions (``"data"``, ``"seq"``);
* a sharding           <- one ``torch.distributed.tensor`` placement per mesh
  dimension: JAX's ``P("data", "seq")`` on a ``(B, S)`` field is
  ``(Shard(0), Shard(1))`` on a ``("data", "seq")`` mesh.

The loader delivers the process-local block as an ordinary tensor on the
rank's card: the slice :func:`local_data_slice` gives, where the JAX loader
assembles a global ``jax.Array`` from every process's block.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from petastorm_tpu_torch.errors import PetastormTpuError

#: the placements of one sharding: one per mesh dimension
Placements = Tuple[object, ...]


def shard_options_from_torch() -> Tuple[int, int]:
    """(cur_shard, shard_count) for ``make_reader``, from the process group:
    ``(rank, world_size)``, or ``(0, 1)`` without an initialized group
    (``petastorm_tpu/parallel/mesh.py:31 shard_options_from_jax``)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_parallel_mesh(axis_name: str = "data", device_type: str = "cuda"):
    """1-D mesh over every rank of the default group, for pure data
    parallelism (``:36``).  Needs an initialized process group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise PetastormTpuError(
            "data_parallel_mesh needs an initialized torch.distributed process group"
            " (torch.distributed.init_process_group)")
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def sharding_for_batch(mesh, batch_axes: Sequence[str] = ("data",),
                       spec: Optional[Placements] = None) -> Placements:
    """Placements of a batch tensor (``:43``): dim 0 sharded over the mesh
    dimensions named in ``batch_axes``, replicated over the others, unless
    explicit placements ``spec`` are given."""
    if spec is not None:
        return tuple(spec)
    names = mesh_dim_names(mesh)
    unknown = [a for a in batch_axes if a not in names]
    if unknown:
        raise PetastormTpuError(f"batch_axes {unknown} are not dimensions of the mesh {names}")
    return tuple(Shard(0) if name in batch_axes else Replicate() for name in names)


def mesh_dim_names(mesh) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names
    if names is None:
        raise PetastormTpuError("the mesh needs named dimensions (mesh_dim_names=)")
    return tuple(names)


def mesh_dim(mesh, name: str) -> int:
    """The index of the mesh dimension called ``name``."""
    names = mesh_dim_names(mesh)
    if name not in names:
        raise PetastormTpuError(f"the mesh has no dimension {name!r}; it has {names}")
    return names.index(name)


def mesh_coordinate(mesh) -> Tuple[int, ...]:
    """This rank's coordinate in ``mesh``; a rank outside the mesh raises."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise PetastormTpuError(
            "this rank is not part of the mesh; build the loader's mesh over the ranks"
            " that read")
    return tuple(int(c) for c in coord)


def shard_slices(mesh_shape: Sequence[int], coordinate: Sequence[int],
                 placements: Placements, global_shape: Sequence[int]) -> Tuple[slice, ...]:
    """The block of ``global_shape`` that the rank at ``coordinate`` of a mesh
    of ``mesh_shape`` holds under ``placements``.  Several mesh dimensions
    sharding one tensor dimension split it in mesh order, the first one
    outermost (JAX's ``P(("data", "seq"))``).  A split that does not divide
    evenly raises, as a JAX mesh refuses it."""
    if len(placements) != len(mesh_shape):
        raise PetastormTpuError(
            f"{len(placements)} placements for a {len(mesh_shape)}-dimensional mesh;"
            " give one placement per mesh dimension")
    lo = [0] * len(global_shape)
    size = [int(d) for d in global_shape]
    for i, placement in enumerate(placements):
        if isinstance(placement, Replicate):
            continue
        if not isinstance(placement, Shard):
            raise PetastormTpuError(f"placement {placement!r} is neither Shard nor Replicate")
        d = placement.dim
        if not 0 <= d < len(global_shape):
            raise PetastormTpuError(
                f"placement {placement!r} shards dim {d} of a rank-{len(global_shape)}"
                f" array of shape {tuple(global_shape)}")
        n = int(mesh_shape[i])
        if size[d] % n:
            raise PetastormTpuError(
                f"dim {d} of shape {tuple(global_shape)} (block of {size[d]}) does not"
                f" divide evenly over {n} ranks of mesh dimension {i}")
        size[d] //= n
        lo[d] += int(coordinate[i]) * size[d]
    return tuple(slice(a, a + s) for a, s in zip(lo, size))


def local_data_slice(mesh, placements: Placements,
                     global_shape: Sequence[int]) -> Tuple[slice, ...]:
    """The index slice of the global array this rank materializes (``:52``):
    which rows (batch axis) and which sequence range (context-parallel axis)
    the loader stages and delivers."""
    return shard_slices(tuple(mesh.shape), mesh_coordinate(mesh), tuple(placements),
                        global_shape)


def batch_block(mesh, placements: Placements) -> Tuple[int, int]:
    """(index, count) of this rank's block of the batch axis (dim 0): the
    reader shard it must read.  Ranks that differ only on mesh dimensions
    that do not shard dim 0 (a ``seq`` dimension) hold the same rows, so they
    read the same shard."""
    coord = mesh_coordinate(mesh)
    index, count = 0, 1
    for i, placement in enumerate(placements):
        if isinstance(placement, Shard) and placement.dim == 0:
            n = int(mesh.shape[i])
            index, count = index * n + coord[i], count * n
    return index, count


def reader_shard(mesh, shardings) -> Tuple[int, int]:
    """(index, count) of the reader shard this rank reads for a loader on
    ``mesh`` with ``shardings`` (one placement tuple, or a dict of them whose
    first entry rules; by default the batch axis over the mesh's first
    dimension): :func:`batch_block` of those placements."""
    spec = next(iter(shardings.values()), None) if isinstance(shardings, dict) else shardings
    if spec is None:
        spec = sharding_for_batch(mesh, mesh_dim_names(mesh)[:1])
    return batch_block(mesh, tuple(spec))


def gather_blocks(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's block of ``tensor`` (each rank gives the same shape),
    concatenated on dim 0 in rank order, on the host."""
    n = dist.get_world_size(group)
    src = tensor.contiguous().to(group_device(group))
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.cpu()


def mesh_group(mesh):
    """The process group spanning every rank of ``mesh``: its own group for a
    1-D mesh, the default group for one that covers the world."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if mesh.mesh.numel() == dist.get_world_size():
        return None  # the default group
    raise PetastormTpuError(
        "a multi-dimensional mesh over a subset of the ranks has no group of its own"
        " here; build it over every rank")


def group_device(group) -> torch.device:
    """The device a collective over ``group`` takes its tensors on: the
    rank's current card for NCCL, the host otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def staged(group, tensor: torch.Tensor) -> bool:
    """Whether a collective over ``group`` moves ``tensor`` through host
    memory: a CUDA tensor on a group that is not NCCL (gloo sends no CUDA
    tensor point to point and gathers none, so ranks sharing one card go
    through pinned host buffers)."""
    return tensor.is_cuda and dist.get_backend(group) != "nccl"


def transport_name(group, device) -> str:
    """How collectives over ``group`` move tensors of ``device``: ``'nccl'``
    (device to device), ``'gloo'`` (host tensors) or ``'gloo, host-staged'``
    (CUDA tensors through pinned host buffers)."""
    backend = dist.get_backend(group)
    if torch.device(device).type == "cuda" and backend != "nccl":
        return f"{backend}, host-staged"
    return backend


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of a CUDA tensor in pinned host memory, complete on return."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place (host-staged where
    :func:`staged` says so); returns it."""
    if staged(group, tensor):
        host = to_host(tensor)
        dist.all_reduce(host, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, group=group)
    return tensor
