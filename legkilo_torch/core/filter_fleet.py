"""The fleet step: B filter replicas advanced one scan per call (the JAX
package's ``vmap(process_scan_any)``, legkilo_tpu/parallel/sweep.py:56-59).

A fleet's carry, packet and params are the single filter's NamedTuples
with a leading replica axis on every tensor (``parallel/sweep.py``).  Its
step takes one of two routes, chosen by the configuration alone
(``fleet_batched``):

* **Batched** -- the deferred pipeline's fused path with all five kernel
  switches on and the IMU match pose (bench.py's and ``sweep --pallas``'s
  configuration).  The single step, ``filter_deferred.process_scan_deferred``,
  takes the fleet as it is: each phase of ``_process_scan_fused`` on that
  route (the pose kernel, the keys kernel, the probe, the select kernel,
  the chain kernel, the moments kernel, the insert glue and the fit
  kernel) takes a leading replica axis, so one fleet step launches each
  of the six kernels once per match pass, whatever B is.  The map tables
  are viewed flat, [B*L*C, W] (core/voxel_map.py's module doc): replica
  r's level l is segment r*L + l.  What must stay per
  replica is an op on a [B, ...] view: the compaction of the valid points
  to the cap, the insert rows' gate and compaction, the refit budget,
  ``ocnt``, the counters of ``ScanOutput``, the slide trigger and the
  covariance re-symmetrisation.  Each replica's rows sum in the order its
  single run sums them and no glue op of this route is a matrix product,
  so every replica computes what its single run computes, bit for bit.
* **One replica after another** -- every other configuration (the
  sequential pipeline, the fused path with a switch off, the per-point
  chain, the constant-velocity match pose, ``return_cloud``): the
  single-replica ``process_scan_any`` on each replica in turn.  The same
  results, with B times the launches.

The fleet has no escalation latch: that belongs to the runner.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .filter import FilterCarry, FilterParams, ScanOutput, ScanPacket, StaticConfig, process_scan_any
from .filter_deferred import kernel_routes, process_scan_deferred


def tree_map(fn, *trees):
    """``fn`` over the tensors of NamedTuples of tensors (nested, with None
    leaves kept), as ``jax.tree.map``."""
    head = trees[0]
    if head is None:
        return None
    if isinstance(head, tuple) and hasattr(head, "_fields"):
        return type(head)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def replica(tree, r: int):
    """Replica ``r`` of a fleet tree (views)."""
    return tree_map(lambda x: x[r], tree)


def stack_replicas(trees):
    """B single-replica trees -> one fleet tree (a leading B on every tensor)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def fleet_batched(scfg: StaticConfig) -> bool:
    """Whether a fleet step takes the batched route: the fused deferred
    path with the chain, match, insert, pose and refit kernels all on and
    the IMU match pose, without ``return_cloud`` (module doc).  The
    configuration alone decides, as ``kernel_routes`` decides a single
    step's routes."""
    match_kernel, insert_kernel = kernel_routes(scfg)
    return (scfg.pipeline == "deferred" and scfg.chain_impl == "fused" and scfg.use_pallas
            and match_kernel and insert_kernel and scfg.use_pallas_pose
            and scfg.map_cfg.use_pallas_refit and scfg.match_pose == "imu"
            and not scfg.return_cloud)


def process_scan_fleet(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                       scfg: StaticConfig) -> Tuple[FilterCarry, ScanOutput]:
    """One scan of every replica: the fleet carry, packet and params (a
    leading B each) -> (carry, ScanOutput with a leading B), on the route
    ``fleet_batched`` picks (module doc)."""
    if not fleet_batched(scfg):
        steps = [process_scan_any(replica(carry, r), replica(packet, r), replica(params, r), scfg)
                 for r in range(packet.points.shape[0])]
        return stack_replicas([c for c, _ in steps]), stack_replicas([o for _, o in steps])
    return process_scan_deferred(carry, packet, params, scfg)


def process_scan_chunk_fleet(carry: FilterCarry, packets: ScanPacket, params: FilterParams,
                             scfg: StaticConfig):
    """K staged scans of every replica (packets [B, K, ...]) in one call,
    the same as K ``process_scan_fleet`` calls; outputs come back [B, K,
    ...] (the JAX ``vmap(process_scan_chunk)``)."""
    outs = []
    for k in range(packets.points.shape[1]):
        carry, out = process_scan_fleet(carry, tree_map(lambda x: x[:, k], packets), params, scfg)
        outs.append(out)
    return carry, tree_map(lambda *xs: torch.stack(xs, dim=1), *outs)
