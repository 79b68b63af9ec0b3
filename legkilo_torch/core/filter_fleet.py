"""The fleet step: B filter replicas advanced one scan per call (the JAX
package's ``vmap(process_scan_any)``, legkilo_tpu/parallel/sweep.py:56-59).

A fleet's carry, packet and params are the single filter's NamedTuples
with a leading replica axis on every tensor (``parallel/sweep.py``).  Its
step has one route, as JAX has one ``vmap``: the single step,
``filter.process_scan_any``, takes the fleet as it is (this module keeps
the tree helpers and the chunked step), on every
configuration (both pipelines, every kernel switch, the per-point chain,
both match poses, ``return_cloud``).  Every phase takes a leading replica
axis: each kernel launches once a match pass for all B replicas (the
chains and pose a warp / a block a replica; keys, select, moments and fit
the replicas' rows side by side with global indices), and each plain
phase runs once on [B, ...] tensors, so a fleet step launches what one
filter's step launches, whatever B is.  The map tables are viewed flat,
[B*L*C, W] (core/voxel_map.py's module doc): replica r's level l is
segment r*L + l, and claims never cross segments.  What must stay per
replica is an op on a [B, ...] view: the compaction of the valid points
to the caps, the insert rows' gate and compaction, the refit budget,
``did_update``, ``ocnt``, the counters of ``ScanOutput``, the slide
trigger and the covariance re-symmetrisation.

Each replica's rows sum in the order its single run sums them, so every
replica computes what its single run computes, bit for bit, where its
products keep their single-run shapes (the five-kernel route, the fused
path off its kernels and the per-point path on the CPU); where a product
of small matrices becomes a batched product (the sequential pipeline's
ESKF steps), the replica's result rounds apart from its single run's.

The fleet has no escalation latch: that belongs to the runner.
"""

from __future__ import annotations

import torch

from .filter import FilterCarry, FilterParams, ScanPacket, StaticConfig, process_scan_any


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


def process_scan_chunk_fleet(carry: FilterCarry, packets: ScanPacket, params: FilterParams,
                             scfg: StaticConfig):
    """K staged scans of every replica (packets [B, K, ...]) in one call,
    the same as K fleet steps; outputs come back [B, K, ...] (the JAX
    ``vmap(process_scan_chunk)``)."""
    outs = []
    for k in range(packets.points.shape[1]):
        carry, out = process_scan_any(carry, tree_map(lambda x: x[:, k], packets), params, scfg)
        outs.append(out)
    return carry, tree_map(lambda *xs: torch.stack(xs, dim=1), *outs)
