"""Process-group start-up and the (dcn, ici) mesh: one rank per card (port
of legkilo_tpu/parallel/multihost.py).

The JAX package runs one process a host that drives all of that host's
chips.  The port runs one process a card, joined by ``torch.distributed``,
because one Python thread driving n cards would issue their launches one
after another and the fleet step is bound by the host.  Ranks are ordered
host-major, the flattened order of the JAX ``(dcn, ici)`` mesh, so rank r
of a world of n holds the replicas that JAX places on device r.

:func:`initialize` brings the process group up from the command line's
``--coordinator`` / ``--num_processes`` / ``--process_id`` (or, without a
coordinator, from the ``env://`` variables ``torchrun`` sets) and binds
the rank to its card before anything touches CUDA; rank 0 logs the port
its coordinator listens on (``HOST:0`` lets it take a free one).  The
backend follows one rule (:func:`backend_for`): gloo on the CPU, NCCL when
every rank of a host has a card of its own, gloo when the host's ranks
outnumber its cards (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.constants import default_pg_timeout

log = logging.getLogger(__name__)

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def backend_for(device_type: str, ranks_per_host: int, cards_per_host: int) -> str:
    """The process group's backend: ``gloo`` for the CPU, ``nccl`` when the
    host has a card for each of its ranks, ``gloo`` when its ranks
    outnumber its cards."""
    if device_type == "cpu":
        return "gloo"
    if ranks_per_host <= cards_per_host:
        return "nccl"
    return "gloo"


def ranks_per_host(world: int) -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` where the launcher sets it
    (torchrun does), otherwise the whole world on one host."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def local_rank(rank: int, world: int) -> int:
    """This rank's index on its host: ``LOCAL_RANK`` where it is set,
    otherwise ``rank % ranks_per_host``."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % ranks_per_host(world)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """Bring the process group up (a no-op when neither a coordinator nor
    a process count is given, as ``jax.distributed.initialize``).  On the
    card it first binds this rank to card ``local_rank % cards``; call it
    before any CUDA allocation."""
    if coordinator_address is None and num_processes is None:
        log.info("single-process run: no process group")
        return
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    device_type = torch.device(device).type
    per_host = ranks_per_host(world)
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda":
        if cards == 0:
            raise RuntimeError("device 'cuda' requested but no card is visible")
        torch.cuda.set_device(local_rank(rank, world) % cards)
    backend = backend_for(device_type, per_host, cards)
    init = "tcp://" + coordinator_address if coordinator_address else "env://"
    log.warning("rank %d of %d: backend %s (%s, %d rank(s) a host, %d card(s) a host), %s",
                rank, world, backend, device_type, per_host, cards, init)
    if not coordinator_address:
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
        return
    # The coordinator's store, made here rather than by init_method so that
    # rank 0 can log the port it listens on before the others join: given
    # port 0, rank 0 binds a free port itself and the log names it.
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0, wait_for_workers=False,
                          timeout=default_pg_timeout)
    if rank == 0:
        log.warning("rank 0: coordinator listening on %s:%d", host, store.port)
    dist.init_process_group(backend, store=store, world_size=world, rank=rank)


def process_count() -> int:
    """The world size, 1 without a process group (``jax.process_count``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This rank, 0 without a process group (``jax.process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def hierarchical_mesh(device_type: str = "cuda"):
    """(dcn, ici) mesh: hosts on the slow axis, a host's ranks on the fast
    one; ``(1, world)`` on one host.  Without a process group it is the
    one-rank mesh of parallel/mesh.py."""
    from .mesh import LocalMesh

    if not dist.is_initialized():
        return LocalMesh((DCN_AXIS, ICI_AXIS))
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    per_host = ranks_per_host(world)
    ranks = torch.arange(world).reshape(world // per_host, per_host)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(DCN_AXIS, ICI_AXIS))


def replica_axes() -> Tuple[str, str]:
    return DCN_AXIS, ICI_AXIS
