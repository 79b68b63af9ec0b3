"""The replica mesh and the sharding of fleet tensors over ranks (port of
legkilo_tpu/parallel/mesh.py).

The scale-out axis is replica data-parallelism: B independent filter
instances on the leading axis, split over ranks (one process a card,
parallel/multihost.py).  A mesh is a ``torch.distributed`` DeviceMesh when
a process group is up and the one-rank :class:`LocalMesh` when none is;
either gives its size (``mesh.size()``, JAX's ``mesh.devices.size``) and
its axis names (``mesh.mesh_dim_names``).  Rank i of a mesh of n holds the
rows ``i*B/n ... (i+1)*B/n - 1`` of every [B, ...] tensor, the rows JAX's
``P(mesh.axis_names)`` places on device i; :func:`gather_rows` puts the
fleet back together, bit for bit, on every rank of the mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.filter_fleet import tree_map

REPLICA_AXIS = "replica"


class LocalMesh:
    """The mesh of a run without a process group: one rank, this process."""

    def __init__(self, names: Tuple[str, ...] = (REPLICA_AXIS,)):
        self.mesh_dim_names = names

    def size(self) -> int:
        return 1


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    """1-D ``("replica",)`` mesh over the first ``n_devices`` ranks (all
    of them by default).  With a process group every rank must call it:
    a mesh over part of the world creates its group with ``new_group``."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process group")
        return LocalMesh()
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=(REPLICA_AXIS,))


def mesh_index(mesh) -> int:
    """This rank's position in the mesh, flattened host-major (-1 when it
    is not in it)."""
    if isinstance(mesh, LocalMesh):
        return 0
    ranks = mesh.mesh.reshape(-1).tolist()
    rank = dist.get_rank()
    return ranks.index(rank) if rank in ranks else -1


def _group(mesh):
    """The process group over every rank of the mesh (None: the world)."""
    if mesh.mesh.ndim == 1:
        return mesh.get_group()
    if mesh.size() != dist.get_world_size():
        raise ValueError("a mesh of more than one axis must span the world")
    return None


def shard_rows(mesh, batch: int) -> slice:
    """This rank's rows of a [B, ...] tensor; B must divide by the mesh size."""
    n = mesh.size()
    if batch % n:
        raise ValueError(f"{batch} replicas are not divisible by a mesh of {n} ranks")
    i = mesh_index(mesh)
    if i < 0:
        raise ValueError("this rank is not in the mesh")
    b = batch // n
    return slice(i * b, (i + 1) * b)


def shard_batch(tree, mesh):
    """This rank's rows of the leading axis of every tensor of ``tree`` (a
    NamedTuple of tensors, nested), copied; 0-d tensors are kept whole.
    Every tensor with a leading axis must have the same B, divisible by the
    mesh size (JAX's multi-process meshes require it too)."""
    sizes = set()
    tree_map(lambda x: sizes.add(int(x.shape[0])) if x.dim() else None, tree)
    if len(sizes) > 1:
        raise ValueError(f"leading axes of different sizes: {sorted(sizes)}")
    rows = shard_rows(mesh, sizes.pop()) if sizes else slice(None)
    if mesh.size() == 1:
        return tree
    return tree_map(lambda x: x[rows].clone() if x.dim() else x, tree)


def gather_rows(mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's rows from every rank of the mesh, in mesh order: this
    rank's [b, ...] shards -> [n*b, ...] on every rank, equal bit for bit to
    the fleet one process would hold.  One ``all_reduce(SUM)`` of a
    zero-filled byte buffer in which each rank writes only its own rows:
    adding zero bytes changes no byte, whatever the dtype, and both gloo and
    NCCL reduce ``uint8`` on the card.  All tensors must be on one device."""
    n = mesh.size()
    if n == 1:
        return list(tensors)
    i = mesh_index(mesh)
    xs = [x.new_empty(x.shape).copy_(x) for x in tensors]  # plain strides for view(uint8)
    sizes = [x.numel() * x.element_size() for x in xs]  # a rank's bytes of each
    # Tensor k's rows from every rank, rank by rank, from an 8-byte-aligned
    # offset, so each region views back as its dtype.
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + -(-n * size // 8) * 8)
    buf = torch.zeros(starts[-1], dtype=torch.uint8, device=xs[0].device)
    for x, size, off in zip(xs, sizes, starts):
        buf[off + i * size:off + (i + 1) * size] = x.reshape(-1).view(torch.uint8)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=_group(mesh))
    return [buf[off:off + n * size].view(x.dtype).reshape((n * x.shape[0],) + tuple(x.shape[1:]))
            for x, size, off in zip(xs, sizes, starts)]
