"""Scaling efficiency: replica throughput against the number of cards
(port of legkilo_tpu/parallel/scaling.py).

Weak scaling: a fixed load of ``replicas_per_device`` replicas a rank, on
meshes of the first 1 ... n ranks (one rank a card, parallel/multihost.py).
Each count's record gives replica-scans a second and efficiency =
throughput(n) / (n * throughput(first count) / first count).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from ..core.filter import FilterParams, StaticConfig
from .mesh import make_mesh, mesh_index, shard_batch
from .multihost import process_count
from .sweep import batched_carry, broadcast_packets, make_fleet_step, perturb_params


def _barrier(device: torch.device) -> None:
    """Every rank here, with this rank's card idle first."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if dist.is_initialized():
        dist.barrier()


def measure_scaling(
    scfg: StaticConfig,
    params: FilterParams,
    packets: Sequence,
    device_counts: Sequence[int],
    replicas_per_device: int = 1,
    warmup: int = 1,
) -> List[Dict]:
    """One record a count n (devices, replicas, wall_s, replica_scans_per_s,
    efficiency): the first n ranks step n * ``replicas_per_device``
    replicas through ``packets`` (one packet each, on this rank's device),
    the others wait; the clock runs on the host from barrier to barrier
    after ``warmup`` steps.  Every rank calls it and gets the records; a
    count above the world size ends the sweep."""
    device = params.ext_r.device
    results = []
    base_rate = None
    for n in device_counts:
        if n > process_count():
            break
        mesh = make_mesh(n, device.type)  # every rank: a sub-mesh's group is collective
        b = n * replicas_per_device
        member = mesh_index(mesh) >= 0
        if member:
            step = make_fleet_step(scfg, mesh=mesh)
            carry = shard_batch(batched_carry(scfg, b, device), mesh)
            bparams = shard_batch(perturb_params(params, b, scale=0.05), mesh)
            steps = [broadcast_packets(p, replicas_per_device) for p in packets]
            for p in steps[:warmup]:
                carry, _, _ = step(carry, p, bparams)
        _barrier(device)
        t0 = time.perf_counter()
        if member:
            for p in steps[warmup:]:
                carry, _, _ = step(carry, p, bparams)
        _barrier(device)
        wall = time.perf_counter() - t0
        n_steps = len(packets) - warmup
        rate = b * n_steps / wall
        if base_rate is None:
            base_rate = rate / n  # a card's rate at the first count
        results.append(dict(devices=n, replicas=b, wall_s=round(wall, 3),
                            replica_scans_per_s=round(rate, 2),
                            efficiency=round(rate / (n * base_rate), 3)))
    return results
