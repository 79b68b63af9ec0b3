"""Slot resolution of the map's insert: find-or-insert with claim rounds.

One CUDA entry (``csrc/claim_slots.cu``) and its plain version, which is the
eager series of core/voxel_map.py (the JAX package's ``_find_or_insert_flat``,
legkilo_tpu/core/voxel_map.py:415):

    claim_call(ptab_x, keys, seg, active, capacity, probe, rounds) -> (slot, ok)

      ptab_x [S, 5] int32  the probe table with its sentinel row (the miss
                           slot, S - 1, last), updated in place
      keys   [M, 3] int32, seg [M] int64 (a row's subtable: level, a fleet's
                           r * L + level), active [M] bool
      slot   [M] int64     the slot holding the row's key, S - 1 where none
      ok     [M] bool      the row is active and resolved

In each of ``rounds`` rounds every active row not yet resolved probes its
key's window; a row whose key is there resolves; rows whose windows share a
first empty slot compete for it and the highest row index writes its key
there; the others try again next round.  A last probe resolves the rows that
won in the last round.  The kernel gives ``ptab_x[:S - 1]``, ``slot`` and
``ok`` bit for bit as the plain version: the same rounds, each probe reading
the table as the round before left it, the same winner (csrc/claim_slots.cu
says how it is picked without a slot-sized array a round).  Only the
sentinel row may differ: the plain version writes every losing claim there,
the kernel never writes it, and nothing reads it.

On a CUDA table ``claim_call`` runs the kernel, on a CPU one the plain
version.  ``claim_call.launches`` counts the calls that ran the kernel (a
call: one memset and 2 * rounds + 1 launches).
"""

from __future__ import annotations

import torch

from . import _build
from .match_geom import hash_keys

I32 = torch.int32
I64 = torch.int64
PTAB_DIM = 5        # the probe table's row: key(3), occupied, is_plane (core/voxel_map.py)
T_OCC, T_PLANE = 3, 4
_INT32_MAX = 2 ** 31 - 1


def probe_plain(ptab, keys, seg, capacity: int, probe: int, miss: int):
    """Linear-probe lookup of each key in its subtable ``seg``: (slot,
    found, empty, has_empty, is_plane), misses = ``miss`` (int64)."""
    C = capacity
    base = seg.to(torch.int64) * C
    h0 = hash_keys(keys[..., 0], keys[..., 1], keys[..., 2], C).to(torch.int64)
    offs = torch.arange(probe, dtype=torch.int64, device=keys.device)
    idx = base[:, None] + ((h0[:, None] + offs[None, :]) & (C - 1))
    rows = ptab[idx]                                       # [M, probe, 5]
    occ_at = rows[..., T_OCC] > 0
    match = occ_at & torch.all(rows[..., 0:3] == keys[:, None, :], dim=-1)
    # First match via min over (offset << 1 | is_plane).
    big = 2 * probe
    isp_at = (rows[..., T_PLANE] > 0).to(torch.int64)
    score = torch.where(match, 2 * offs[None, :] + isp_at, big)
    m = torch.min(score, dim=-1).values
    found = m < big
    slot = torch.where(found, base + ((h0 + (m >> 1)) & (C - 1)), miss)
    isp = ((m & 1) == 1) & found
    escore = torch.where(~occ_at, offs[None, :], probe)
    em = torch.min(escore, dim=-1).values
    has_empty = em < probe
    empty = torch.where(has_empty, base + ((h0 + em) & (C - 1)), miss)
    return slot, found, empty, has_empty, isp


def claim_plain(ptab_x, keys, seg, active, capacity: int, probe: int, rounds: int):
    """Plain version of ``claim_call`` (module doc): the eager rounds, the
    winner of a slot picked by ``scatter_reduce(amax)`` over the row index."""
    miss = ptab_x.shape[0] - 1
    M = keys.shape[0]
    dev = keys.device
    slot = torch.full((M,), miss, dtype=torch.int64, device=dev)
    resolved = torch.zeros((M,), dtype=torch.bool, device=dev)
    claim = torch.cat(
        [keys, torch.ones((M, 1), dtype=torch.int32, device=dev),
         torch.zeros((M, 1), dtype=torch.int32, device=dev)], dim=1
    )
    rowid = torch.arange(M, dtype=torch.int64, device=dev)
    for _ in range(rounds):
        s, found, empty, has_empty, _ = probe_plain(ptab_x, keys, seg, capacity, probe, miss)
        newly = active & ~resolved & found
        slot = torch.where(newly, s, slot)
        resolved = resolved | newly
        want = active & ~resolved & has_empty
        claim_idx = torch.where(want, empty, miss)
        # The last writer of each slot wins, as XLA applies duplicates.
        winner = torch.full((miss + 1,), -1, dtype=torch.int64, device=dev)
        winner.scatter_reduce_(0, claim_idx, rowid, reduce="amax")
        won = want & (winner[claim_idx] == rowid)
        ptab_x.index_copy_(0, torch.where(won, claim_idx, miss), claim)
    s, found, _, _, _ = probe_plain(ptab_x, keys, seg, capacity, probe, miss)
    newly = active & ~resolved & found
    slot = torch.where(newly, s, slot)
    resolved = resolved | newly
    return slot, resolved & active


def claim_call(ptab_x, keys, seg, active, capacity: int, probe: int, rounds: int):
    """The claim kernel on a CUDA table, ``claim_plain`` on a CPU one
    (module doc).  Refuses, before any launch, a table, keys, segments or
    flags of another dtype or device, a table that is not [S, 5] and
    contiguous or whose S - 1 slots are not whole segments of ``capacity``,
    a capacity that is not a power of two, a probe below 1, negative
    rounds, and rounds * M or S at or past 2^31.  keys, seg and active may
    be strided views."""
    if ptab_x.device.type != "cuda":
        return claim_plain(ptab_x, keys, seg, active, capacity, probe, rounds)
    name = "claim_call"
    M, S = keys.shape[0], ptab_x.shape[0]
    if ptab_x.dim() != 2 or ptab_x.shape[1] != PTAB_DIM:
        raise ValueError(f"{name}: ptab_x has shape {tuple(ptab_x.shape)}, expected [S, {PTAB_DIM}]")
    if tuple(keys.shape) != (M, 3) or tuple(seg.shape) != (M,) or tuple(active.shape) != (M,):
        raise ValueError(f"{name}: keys {tuple(keys.shape)}, seg {tuple(seg.shape)} and active "
                         f"{tuple(active.shape)} must be [M, 3], [M] and [M]")
    capacity, probe, rounds = int(capacity), int(probe), int(rounds)
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"{name}: capacity {capacity} is not a power of two")
    if S < 2 or (S - 1) % capacity:
        raise ValueError(f"{name}: ptab_x's {S - 1} slots (less the sentinel row) are not whole "
                         f"segments of {capacity}")
    if probe < 1 or rounds < 0:
        raise ValueError(f"{name}: probe {probe} must be >= 1 and rounds {rounds} >= 0")
    if S > _INT32_MAX or (rounds + 1) * max(M, 1) > _INT32_MAX:
        raise ValueError(f"{name}: {S} table rows or (rounds + 1) x {M} rows reach 2^31 "
                         "(the round-tagged bids are int32)")
    args = (ptab_x, keys, seg, active)
    dev = _build.check_tensors(name, args, [I32, I32, I64, torch.bool], strided=(1, 2, 3))
    slot = torch.empty((M,), dtype=I64, device=dev)
    ok = torch.empty((M,), dtype=torch.bool, device=dev)
    if M == 0:
        return slot, ok
    bid = torch.empty((S,), dtype=I32, device=dev)
    _build.launch(
        "claim_slots_launch", args + (bid, slot, ok),
        [M, S, capacity, probe, rounds, *keys.stride(), seg.stride(0), active.stride(0)],
    )
    claim_call.launches += 1
    return slot, ok


claim_call.launches = 0
