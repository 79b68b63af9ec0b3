"""Monte-Carlo fleet replay: B filter replicas, sharded over ranks (port of
legkilo_tpu/parallel/sweep.py).

A replica is one full filter instance (state, covariance, its own voxel
map).  The fleet carry is ``FilterCarry`` with a leading replica axis on
each of its 12 tensors, as the JAX ``batched_carry`` makes it, so
convert.py and the .npz checkpoints carry a JAX fleet across leaf for leaf;
``FilterParams`` is batched in full (``perturb_params`` varies
``noise.q_diag``, ``fleet_init`` ``g_over_acc_norm``).  The step is the
single step, ``process_scan_any``, given the leading replica axis
(core/filter_fleet.py): one batched step for every replica on every
configuration (each kernel one launch a match pass for all of them).

With a ``mesh`` (parallel/mesh.py: one rank a card), each rank steps its
own shard of the replicas, ``mesh.size()`` shards of B/n, and the
``FleetStats`` reduce over the whole fleet: every rank gathers the
replicas' poses and match counts in rank order (``gather_rows``) and runs
the same reduction on the same [B, ...] tensors, so each rank holds the
statistics of a one-process fleet of B, bit for bit.

A fleet call is the span ``lk.fleet`` (utils/timing.py): its scans'
``lk.step`` spans and the statistics, ``lk.fleet.stats``, inside it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core.filter import (
    FilterCarry,
    FilterParams,
    ScanPacket,
    StaticConfig,
    first_frame_map,
    init_carry,
    init_state_from_imu,
    process_scan_any,
)
from ..core.filter_fleet import process_scan_chunk_fleet, stack_replicas, tree_map
from ..utils.timing import span
from .mesh import gather_rows


class FleetStats(NamedTuple):
    """Per-step fleet statistics (reduced across replicas and ranks)."""

    mean_pos: torch.Tensor      # [3]
    pos_spread: torch.Tensor    # [] max deviation from the mean
    mean_matched: torch.Tensor  # []
    min_matched: torch.Tensor   # []


def _stats(pos, n_matched, mesh=None) -> FleetStats:
    """The statistics of the whole fleet: this rank's [b, 3] poses and [b]
    match counts gathered over the mesh into [B, ...] first."""
    with span("lk.fleet.stats"):
        if mesh is not None:
            pos, n_matched = gather_rows(mesh, [pos, n_matched])
        mean = pos.mean(dim=0)
        return FleetStats(
            mean_pos=mean,
            pos_spread=torch.linalg.norm(pos - mean, dim=-1).max(),
            mean_matched=n_matched.to(torch.float32).mean(),
            min_matched=n_matched.min(),
        )


def _broadcast(tree, batch: int):
    return tree_map(lambda x: x.expand((batch,) + tuple(x.shape)).clone(), tree)


def batched_carry(scfg: StaticConfig, batch: int, device="cuda") -> FilterCarry:
    """B independent filter instances stacked on the leading axis."""
    return _broadcast(init_carry(scfg, torch.device(device)), batch)


def make_fleet_step(scfg: StaticConfig, mesh=None, with_stats: bool = True):
    """The fleet step ``(carry [B,...], packet [B,...], params [B,...]) ->
    (carry, out, stats)``; ``params`` is batched too, so noise-parameter
    sweeps need nothing more.  With a ``mesh`` the tensors are this rank's
    shard ([B/n, ...], ``shard_batch``) and the stats the whole
    fleet's.  The step consumes ``carry``: once an earlier step made the
    map's tables it writes them in place (core/filter_fleet.py), so clone
    a carry to keep it."""

    def step(carry, packet, params):
        with span("lk.fleet"):
            carry, out = process_scan_any(carry, packet, params, scfg)
            return carry, out, (_stats(out.pos, out.n_matched, mesh) if with_stats else None)

    return step


def make_fleet_chunk_step(scfg: StaticConfig, mesh=None, with_stats: bool = True):
    """The chunked fleet step: every replica advances K scans a call,
    ``(carry [B,...], packets [B,K,...], params [B,...]) -> (carry, outs
    [B,K,...], stats)``, equal to K calls of the per-scan step; stats
    reduce over the replicas' last scan of the chunk (over the whole fleet
    with a ``mesh``, as ``make_fleet_step``).  It consumes ``carry``, as
    ``make_fleet_step``'s step does."""

    def step(carry, packets, params):
        with span("lk.fleet"):
            carry, outs = process_scan_chunk_fleet(carry, packets, params, scfg)
            stats = _stats(outs.pos[:, -1], outs.n_matched[:, -1], mesh) if with_stats else None
            return carry, outs, stats

    return step


def stack_fleet_chunks(step_packets: list, chunk: int) -> list:
    """Per-step [B, ...] packets (``stack_packets``) -> per-chunk [B, K, ...]
    packets for ``make_fleet_chunk_step``.  Trailing steps that do not fill
    a chunk are dropped: every call advances the whole fleet by K scans."""
    return [
        tree_map(lambda *xs: torch.stack(xs, dim=1), *step_packets[i : i + chunk])
        for i in range(0, len(step_packets) - chunk + 1, chunk)
    ]


def broadcast_packets(packet: ScanPacket, batch: int) -> ScanPacket:
    """One packet for every replica (the same data per replica)."""
    return _broadcast(packet, batch)


def stack_packets(packet_seqs) -> list:
    """B per-replica packet sequences -> per-step [B, ...] packets, each
    replica advancing through its own stream; the sequences are cut to the
    shortest so every step has a full batch."""
    t_min = min(len(s) for s in packet_seqs)
    return [stack_replicas([s[t] for s in packet_seqs]) for t in range(t_min)]


def fleet_init(scfg: StaticConfig, params: FilterParams, first_scan_points, mean_acc, mean_gyr,
               end_offsets, gravity: float, pad: int = 8192, device="cuda"
               ) -> Tuple[FilterCarry, FilterParams]:
    """Each replica's first-frame initialisation, the runner's
    (``init_state_from_imu`` and the first-frame map from its raw first
    cloud, up to ``pad`` points) with its own sensor statistics: B single
    initialisations, stacked.  Returns (carry, params with each replica's
    ``g_over_acc_norm``)."""
    dev = torch.device(device)
    one = init_carry(scfg, dev)
    carries: List[FilterCarry] = []
    g_over: List[torch.Tensor] = []
    for r, pts in enumerate(first_scan_points):
        carry, acc_norm = init_state_from_imu(
            one,
            torch.tensor(np.asarray(mean_acc[r]), dtype=torch.float32, device=dev),
            torch.tensor(np.asarray(mean_gyr[r]), dtype=torch.float32, device=dev),
            float(gravity),
            torch.tensor(float(end_offsets[r]), dtype=torch.float32, device=dev),
        )
        g = float(gravity) / acc_norm
        n = min(len(pts), pad)
        buf = np.zeros((pad, 3), dtype=np.float32)
        buf[:n] = np.asarray(pts, dtype=np.float32)[:n]
        mask = np.zeros(pad, dtype=bool)
        mask[:n] = True
        carries.append(first_frame_map(
            carry, scfg, params._replace(g_over_acc_norm=g),
            torch.from_numpy(buf).to(dev), torch.from_numpy(mask).to(dev)))
        g_over.append(g)
    bparams = _broadcast(params, len(carries))._replace(g_over_acc_norm=torch.stack(g_over))
    return stack_replicas(carries), bparams


def perturb_params(params: FilterParams, batch: int, scale: float = 0.0,
                   seed: int = 0) -> FilterParams:
    """Batch params, with the process noise ``q_diag`` of each replica
    scaled by a log-normal factor exp(scale N(0, 1)) when ``scale`` > 0
    (parameter-sweep mode).  The factors come from a ``torch.Generator``
    seeded with ``seed`` (not ``jax.random``'s bits); every rank of a mesh
    draws the whole fleet's and keeps its rows (``shard_batch``), so a
    replica's factor does not depend on the number of ranks."""
    base = _broadcast(params, batch)
    if scale <= 0.0:
        return base
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    z = torch.randn((batch, 1), generator=gen, dtype=base.noise.q_diag.dtype)
    q = base.noise.q_diag * torch.exp(scale * z).to(base.noise.q_diag.device)
    return base._replace(noise=base.noise._replace(q_diag=q))
