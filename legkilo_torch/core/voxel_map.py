"""Device-resident multi-level voxel hash map (subset of legkilo_tpu/core/voxel_map.py).

One open-addressing hash table per level (voxel size voxel_size / 2^l),
stored FLAT: every table is [L*C, W] and the global slot of (level, local
slot) is level * C + local.  Per slot:

    ptab  [L*C, 5]   int32  key(3), occupied, is_plane (the probe row)
    meta  [L*C, 4]   n, new_n, initialized, is_plane
    mom   [L*C, 9]   m1(3) m2(6)                   (compute dtype)
    moms  [L*C, 60]  s0(6) s1(18) s2(36)           (storage dtype)
    plane [L*C, 31]  centre_rel(3) normal(3) evals(3) radius(1) plane_var(21)
    ocnt  [3]        int32 overflow counters (rows beyond insert_row_cap,
                     refits deferred past refit_budget, failed claims)

Differences from the JAX module, none of which changes a result:

* Out-of-range indices.  JAX drops or fills an index of L*C ("miss").
  Torch raises on the CPU and asserts on the card, so every insert works on
  tables with one extra sentinel row at L*C: writes aimed at a miss land
  there and are discarded, and the row is zeroed on entry and before it is
  read so a gather of a miss reads the JAX fill value 0.  The tables an
  insert returns are the leading rows of those sentinel-bearing buffers, so
  the next insert on them writes them in place, its sentinel rows zeroed;
  a map that no insert made (``make_map``, a checkpoint, a ``.clone()``, a
  replica ``x[r]`` of a fleet of B > 1) is copied into new buffers once.
  An insert therefore consumes a map that an earlier insert returned, as
  ``jax.jit(..., donate_argnums=0)`` would: a caller that wants to keep
  such a map clones it first.
* Duplicate claims.  Several new keys can claim one empty slot in the same
  round.  XLA on the CPU applies a scatter's duplicate updates in order, so
  the last writer wins; here the winner is picked first and only whole
  winning rows are written.  On the CPU it is picked by
  ``scatter_reduce(amax)`` over the row index; on the card the claim kernel
  (ops/claim_slots.py) runs each round as two launches, probe-and-bid then
  award: every row still unresolved bids for its window's first empty slot
  with an ``atomicMax`` of its round-tagged row index on a per-call word a
  slot, and the bidder whose bid stands writes its key.  Both give the same
  table, slots and failed claims, bit for bit.
* The hash.  Keys are cast to uint32 and the products wrap (eigen_types.hpp
  :74-82); torch has no full uint32 arithmetic, so it runs in int64 with
  ``& 0xFFFFFFFF``.
* The hinted inserts claim over all their rows in one series, the new
  keys active.  The JAX module claims over the new keys compacted to
  ``insert_new_cap`` rows when they fit and over all rows otherwise,
  chosen by ``lax.cond`` on their count.  Claims keep their relative order
  either way, so the same keys win the same slots and every branch gives
  the same map; one series needs no host read of the count (eager torch
  would sync once a scan for it) and no second branch to select from, so
  ``MapConfig`` has no ``insert_new_cap``.
* Summation order.  The moment scatter-adds run in row order on both
  devices (core/ordered_sum.py), so two runs on the card give equal maps.

Every insert takes one path: its rows (``InsertRows``: (point, level)
pairs with their keys, the match phase's slot for each and whether it
claims one; ``point_insert_rows`` gives every row, ``gated_insert_rows``
the ancestor-gated ones), their moments (``moments_rows``, or the moments
kernel of ops/insert_rows.py), then ``insert_rows``: the claims as one
series of rounds (ops/claim_slots.py), the scatter-adds, thresholds and
budgeted refit, and the overflow counters.  ``insert_points``,
``insert_points_hinted`` and ``insert_packed_rows_hinted`` are the JAX
module's entries on it.  The path's phases are spans (utils/timing.py)
inside the step's ``lk.insert``:
``lk.insert.rows`` (the rows and their moments), ``lk.insert.tables`` (the
sentinel rows: the probe table's before the claims, the other four's
after; counter ``map.table_bytes``, the bytes of the tables copied, 0 on
an insert in place, and ``map.tables_in_place``, the inserts that wrote
all five tables in place), ``lk.insert.claim`` (the claim series; counter
``map.claim_rows``, the rows times the rounds), ``lk.insert.accumulate``
(the scatter-adds through the thresholds) and ``lk.insert.refit`` (the
budget, the fit, the writes).

A fleet of B maps (core/filter_fleet.py) keeps every table with a leading
replica axis, [B, L*C, W], and its batched step views them flat, [B*L*C, W]:
replica r's level l is segment r*L + l of capacity C, the miss slot is
B*L*C, and the probe, the claims, the scatter-adds and the refit work on
global slots unchanged (every insert entry takes a fleet's maps and
rows).  What stays per replica is done on a [B, ...] view: the
compaction of the valid rows, the ancestor gate, the refit budget's choice
of slots, ``ocnt``, and the slide.  Targets never cross replicas, so every
slot sums its rows in the order a single map does.

The point-batch match (``match_points``) serves the sequential pipeline,
the ``chain_impl="jax"`` path and the fused path's match off its kernels;
the fused path's kernel match goes through the keys and select kernels
(ops/match_geom.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..ops import insert_rows as ir
from ..ops.claim_slots import PTAB_DIM, T_OCC, T_PLANE, claim_call, probe_plain
from ..ops.match_geom import hash_keys
from ..ops.plane_fit_rows import fit_par, fit_slots_call
from ..utils.timing import span, tally
from .ordered_sum import index_add_rows
from .plane_fit import PlaneMoments, fit_planes, point_moments

_M_N, _M_NEW, _M_INIT, _M_PLANE = 0, 1, 2, 3
META_DIM = 4
MOM12_DIM = 9
MOMS_DIM = 60
PLANE_DIM = 31
OCNT_ROWCAP, OCNT_REFIT, OCNT_CLAIM = 0, 1, 2

_SYM6 = (0, 1, 2, 4, 5, 8)
_FULL9 = (0, 1, 2, 1, 3, 4, 2, 4, 5)
_SYM21_PAIRS = tuple((i, j) for i in range(6) for j in range(i, 6))
_TRIU36 = tuple(i * 6 + j for (i, j) in _SYM21_PAIRS)
_FULL36 = tuple(_SYM21_PAIRS.index((min(i, j), max(i, j))) for i in range(6) for j in range(6))


class MapConfig(NamedTuple):
    """Static map configuration: the JAX MapConfig's fields but
    insert_new_cap (the claims have no compacted path; module doc)."""

    levels: int
    capacity: int
    probe: int
    voxel_size: float
    planer_threshold: float
    sigma_num: float
    max_points_num: int
    init_num: Tuple[int, ...]
    update_size_threshold: int = 5
    insert_rounds: int = 6
    radius_k: float = 3.0
    refit_budget: int = 2048
    insert_row_cap: int = 0
    use_pallas_refit: bool = False
    storage_dtype: str = "f32"


def map_config_from(cfg, use_pallas_refit: bool = False) -> MapConfig:
    """MapConfig from config.VoxelMapConfig."""
    levels = cfg.max_layer + 1
    return MapConfig(
        levels=levels,
        capacity=1 << cfg.capacity_log2,
        probe=cfg.probe_length,
        voxel_size=float(cfg.voxel_size),
        planer_threshold=float(cfg.min_eigen_value),
        sigma_num=float(cfg.sigma_num),
        max_points_num=int(cfg.max_points_num),
        init_num=tuple(int(x) for x in cfg.layer_init_num[:levels]),
        insert_rounds=int(cfg.insert_rounds),
        insert_row_cap=int(cfg.insert_row_cap),
        refit_budget=int(cfg.refit_budget),
        use_pallas_refit=bool(use_pallas_refit),
        storage_dtype=str(cfg.storage_dtype),
    )


class VoxelMap(NamedTuple):
    """All map state, flat [levels * capacity, W] tensors (module doc)."""

    ptab: torch.Tensor
    meta: torch.Tensor
    mom: torch.Tensor
    moms: torch.Tensor
    plane: torch.Tensor
    ocnt: torch.Tensor

    # Unpacked views (read-only, for export and tests), as the JAX module's.
    @property
    def key(self):
        return self.ptab[..., 0:3]

    @property
    def occ(self):
        return self.ptab[..., T_OCC] > 0

    def is_plane(self):
        return self.meta[..., _M_PLANE] > 0.5

    def center_rel(self):
        return self.plane[..., 0:3]

    def normal(self):
        return self.plane[..., 3:6]

    def evals(self):
        return self.plane[..., 6:9]

    def plane_var(self):
        return _expand_pv(self.plane[..., 10:31])


class MatchResult(NamedTuple):
    """Per-point plane match (PointToPlane analog, voxel_map.h:80-94); the
    ``own_*`` fields expose the own-voxel chain's probe (keys, global flat
    slot with L*C = miss, hit and is-plane flags per level)."""

    matched: torch.Tensor      # [N] bool
    normal: torch.Tensor       # [N, 3]
    center: torch.Tensor       # [N, 3] plane centre in world
    plane_var: torch.Tensor    # [N, 6, 6]
    signed_dist: torch.Tensor  # [N] n . (p - centre)
    own_keys: torch.Tensor     # [L, N, 3]
    own_slot: torch.Tensor     # [L, N]
    own_found: torch.Tensor    # [L, N] bool
    own_plane: torch.Tensor    # [L, N] bool


def _expand_pv(rows21: torch.Tensor) -> torch.Tensor:
    """[..., 21] packed plane_var -> [..., 6, 6]."""
    return rows21[..., list(_FULL36)].reshape(rows21.shape[:-1] + (6, 6))


_STORAGE = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}


def make_map(cfg: MapConfig, device) -> VoxelMap:
    """An empty map; moms/plane in the storage dtype, the rest fp32."""
    lc = cfg.levels * cfg.capacity
    sd = _STORAGE[cfg.storage_dtype]
    return VoxelMap(
        ptab=torch.zeros((lc, PTAB_DIM), dtype=torch.int32, device=device),
        meta=torch.zeros((lc, META_DIM), device=device),
        mom=torch.zeros((lc, MOM12_DIM), device=device),
        moms=torch.zeros((lc, MOMS_DIM), dtype=sd, device=device),
        plane=torch.zeros((lc, PLANE_DIM), dtype=sd, device=device),
        ocnt=torch.zeros((3,), dtype=torch.int32, device=device),
    )


def level_size(cfg: MapConfig, level: int) -> float:
    return cfg.voxel_size / (2.0 ** level)


def voxel_key(p_w: torch.Tensor, size: float) -> torch.Tensor:
    """floor(p / size) as int32 (voxelKeyFloor, eigen_types.hpp:89-95)."""
    return torch.floor(p_w / size).to(torch.int32)


def _hash(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    return hash_keys(keys[..., 0], keys[..., 1], keys[..., 2], capacity)


def _spare_row_buffer(t: torch.Tensor):
    """The [n + 1, W] buffer whose leading rows t [n, W] are, when t is
    exactly that (contiguous, at the buffer's start, one spare row after
    it: what ``insert_rows`` returns, a fleet's viewed flat again); None
    otherwise."""
    n, w = t.shape
    if (t.is_contiguous() and t.storage_offset() == 0
            and t.untyped_storage().nbytes() == (n + 1) * w * t.element_size()):
        return torch.as_strided(t, (n + 1, w), (w, 1))
    return None


def _with_sentinel(t: torch.Tensor) -> torch.Tensor:
    """t with one zero row after it (index L*C = the miss slot): t's own
    buffer when an earlier insert made it (``_spare_row_buffer``), its
    spare row zeroed, so the insert writes t in place; a copy otherwise."""
    x = _spare_row_buffer(t)
    if x is None:
        return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
    x[-1] = 0
    return x


def _sentinel_tables(*tables):
    """``_with_sentinel`` of each table (span ``lk.insert.tables``; the
    bytes of the tables copied are the counter ``map.table_bytes``)."""
    with span("lk.insert.tables"):
        out = tuple(_with_sentinel(t) for t in tables)
    tally("map.table_bytes", sum(x.nbytes for x, t in zip(out, tables) if x.data_ptr() != t.data_ptr()))
    return out


def _gather_fill(x: torch.Tensor, idx: torch.Tensor, fill=0) -> torch.Tensor:
    """x[idx] with out-of-range idx (== len(x)) reading ``fill``."""
    n = x.shape[0]
    ok = idx < n
    got = x[torch.clamp(idx, max=n - 1)]
    return torch.where(ok.reshape(ok.shape + (1,) * (got.dim() - ok.dim())), got,
                       torch.full_like(got, fill))


def _pack_moments(m: PlaneMoments):
    """Per-point moments -> ([..., 9] m1/m2, [..., 60] s0/s1/s2) packed rows."""
    lead = m.m1.shape[:-1]
    sym6 = list(_SYM6)
    m2 = m.m2.reshape(lead + (9,))[..., sym6]
    s0 = m.s0.reshape(lead + (9,))[..., sym6]
    s1 = m.s1.reshape(lead + (9, 3))[..., sym6, :].reshape(lead + (18,))
    s2 = m.s2.reshape(lead + (9, 9))[..., sym6, :][..., :, sym6].reshape(lead + (36,))
    return torch.cat([m.m1, m2], dim=-1), torch.cat([s0, s1, s2], dim=-1)


def _unpack_moments(rows12, rows_s, n) -> PlaneMoments:
    lead = rows12.shape[:-1]
    full9 = list(_FULL9)
    m2 = rows12[..., 3:9][..., full9].reshape(lead + (3, 3))
    s0 = rows_s[..., 0:6][..., full9].reshape(lead + (3, 3))
    s1 = rows_s[..., 6:24].reshape(lead + (6, 3))[..., full9, :].reshape(lead + (3, 3, 3))
    s2 = (rows_s[..., 24:60].reshape(lead + (6, 6))[..., full9, :][..., :, full9]
          .reshape(lead + (3, 3, 3, 3)))
    return PlaneMoments(n=n, m1=rows12[..., 0:3], m2=m2, s0=s0, s1=s1, s2=s2)


def compact_order(mask_f: torch.Tensor, cap: int) -> torch.Tensor:
    """Stable mask compaction along the last axis: order[i] = source row of
    the i-th valid row, or N (out of range) for unfilled slots.  A fleet's
    [B, N] mask compacts each replica's rows and names them as rows of the
    replicas' rows side by side: order[r, i] = r*N + (source row), B*N for
    unfilled slots."""
    n = mask_f.shape[-1]
    pos = torch.cumsum(mask_f.to(torch.int64), -1) - 1
    tgt = torch.where(mask_f & (pos < cap), pos, cap)
    out = torch.full(mask_f.shape[:-1] + (cap + 1,), mask_f.numel(), dtype=torch.int64,
                     device=mask_f.device)
    src = torch.arange(mask_f.numel(), dtype=torch.int64, device=mask_f.device)
    out.scatter_(-1, tgt, src.reshape(mask_f.shape))
    return out[..., :cap]


class InsertRows(NamedTuple):
    """One insert's (point, level) rows, in the order the claims and the
    scatter-adds take them; a fleet's replicas' rows one after another
    (module doc).  ``order``, ``found`` and ``n_gated`` are the gate's
    (``gated_insert_rows``); ``point_insert_rows`` leaves them None, but
    ``found`` where the probe's hint gives it."""

    order: torch.Tensor    # [R] the gated row's source row; B*L*N for an unfilled slot
    pidx: torch.Tensor     # [R] the row's point (a fleet's r*N + i)
    keys: torch.Tensor     # [R, 3] int32
    lvl: torch.Tensor      # [R] the row's level
    mask: torch.Tensor     # [R] the row inserts
    found: torch.Tensor    # [R] the match phase's probe found the key
    slot0: torch.Tensor    # [R] the probe's slot where found, else the miss slot
    need: torch.Tensor     # [R] the row claims a slot: mask and not found
    n_gated: torch.Tensor  # [*lead] rows through the gate a replica
    seg: torch.Tensor      # [R] the row's subtable for the probe: lvl, a fleet's r*L + lvl
    n_over: torch.Tensor   # [*lead] rows past insert_row_cap a replica (0 for every row)


def _by_replica(x, b: int):
    """The match phase's probe rows [L, B*N, ...] as [B, L*N, ...]: each
    replica's rows level-major, as a single map's; a view at B = 1."""
    L, n, tail = x.shape[0], x.shape[1] // b, tuple(x.shape[2:])
    return x.reshape((L, b, n) + tail).transpose(0, 1).reshape((b, L * n) + tail)


def point_insert_rows(cfg: MapConfig, mask, p_w, hint) -> InsertRows:
    """Every (point, level) row of mask [N] (a fleet's [B, N]), replica-major
    then level-major: row r*L*N + l*N + i.  With hint None, keyed at the
    points p_w [N, 3] (a fleet's [B, N, 3]; ``voxel_key``), every valid row
    claiming; with hint = (own_keys, own_slot, own_found), the match
    phase's probe [L, N] ([L, B*N] in fleet slots), keyed by the probe: a
    found row keeps its slot and only new keys claim (module doc)."""
    lead = tuple(mask.shape[:-1])
    b, L, N = math.prod(lead), cfg.levels, mask.shape[-1]
    dev = mask.device
    miss = b * L * cfg.capacity
    seg = torch.arange(b * L, dtype=torch.int64, device=dev).repeat_interleave(N)
    mask_f = mask.reshape(b, 1, N).expand(b, L, N).reshape(-1)
    pidx = torch.arange(b * N, dtype=torch.int64, device=dev).reshape(b, 1, N).expand(b, L, N).reshape(-1)
    if hint is None:
        p_w = p_w.reshape(b, N, 3)
        keys = torch.stack([voxel_key(p_w, level_size(cfg, l)) for l in range(L)], dim=1).reshape(-1, 3)
        found, need, slot0 = None, mask_f, torch.full_like(seg, miss)
    else:
        own_keys, own_slot, own_found = hint
        keys = _by_replica(own_keys, b).reshape(-1, 3)
        found = _by_replica(own_found, b).reshape(-1) & mask_f
        need = mask_f & ~found
        slot0 = torch.where(found, _by_replica(own_slot, b).reshape(-1).to(torch.int64), miss)
    return InsertRows(order=None, pidx=pidx, keys=keys, lvl=seg % L, mask=mask_f, found=found, slot0=slot0,
                      need=need, n_gated=None, seg=seg,
                      n_over=torch.zeros(lead, dtype=torch.int64, device=dev))


def gated_insert_rows(cfg: MapConfig, mask, own_keys, own_slot, own_found, own_plane) -> InsertRows:
    """A point inserts at level l only while every ancestor voxel exists and
    is not a plane (UpdateOctoTree's descent, voxel_map.cc:185-241); the
    surviving rows are compacted to insert_row_cap (level 0 first).

    mask [N] and the own chain's probe [L, N]; or a fleet's mask [B, N] (each
    replica's compacted points) with the probe [L, B*N] in fleet slots: each
    replica's rows are gated and compacted as a single map's are, and the
    B*R rows lie side by side (pidx naming fleet points r*N + i, seg the
    subtable r*L + lvl, n_gated [B])."""
    lead = tuple(mask.shape[:-1])
    mask = mask.reshape(-1, mask.shape[-1])
    B, N = mask.shape
    L = own_found.shape[0]
    R = cfg.insert_row_cap
    miss = B * L * cfg.capacity
    dev = mask.device

    mask_f = mask.repeat(1, L)
    found_f = _by_replica(own_found, B) & mask_f
    elig = torch.ones((B, N), dtype=torch.bool, device=dev)
    gates = []
    for lvl in range(L):
        gates.append(elig)
        elig = elig & own_found[lvl].reshape(B, N) & ~own_plane[lvl].reshape(B, N)
    gate_f = torch.cat(gates, dim=1) & mask_f
    order = compact_order(gate_f, R)          # [B, R] of B*L*N rows; B*L*N for unfilled slots
    cols = torch.cat(
        [
            _by_replica(own_keys, B).to(torch.int64),
            torch.arange(B * L, dtype=torch.int64, device=dev).repeat_interleave(N).reshape(
                B, L * N, 1),
            gate_f.to(torch.int64)[..., None],
            found_f.to(torch.int64)[..., None],
            _by_replica(own_slot, B).to(torch.int64)[..., None],
        ],
        dim=2,
    )
    rows7 = _gather_fill(cols.reshape(B * L * N, 7), order.reshape(-1), 0)
    mask_r = rows7[:, 4] > 0
    found_r = rows7[:, 5] > 0
    seg = rows7[:, 3]
    # Fleet point r*N + i of row r*L*N + l*N + i; an unfilled slot's r*N.
    pidx = order % N + torch.arange(B, dtype=torch.int64, device=dev)[:, None] * N
    n_gated = gate_f.sum(1).reshape(lead)
    return InsertRows(
        order=order.reshape(-1), pidx=pidx.reshape(-1),
        keys=rows7[:, 0:3].to(torch.int32), lvl=seg % L, mask=mask_r,
        found=found_r, slot0=torch.where(found_r & mask_r, rows7[:, 6], miss),
        need=mask_r & ~found_r, n_gated=n_gated, seg=seg,
        n_over=torch.clamp(n_gated - R, min=0),
    )


def moments_rows(cfg: MapConfig, rows: InsertRows, p_w, var):
    """The rows' moment rows (mom [R, 9], moms [R, 60]) about their voxels'
    centres, from the points' world positions p_w [N, 3] and variances var
    [N, 3, 3] (a fleet's [B, N, ...]) read at ``rows.pidx``: the plain
    twin of the moments kernel (ops/insert_rows.py), which reads the
    chain's poses and the match phase's points instead."""
    sizes = ir.level_sizes(cfg.voxel_size, cfg.levels, p_w.device)
    vc = (rows.keys.to(p_w.dtype) + 0.5) * sizes[rows.lvl][:, None]
    return _pack_moments(point_moments(p_w.reshape(-1, 3)[rows.pidx] - vc,
                                       var.reshape(-1, 3, 3)[rows.pidx]))


def insert_points(vm: VoxelMap, cfg: MapConfig, p_w, var, mask) -> VoxelMap:
    """Insert points at every level and refit touched planes (UpdateVoxelMap
    + init_octo_tree, voxel_map.cc:119-241 / 287-361); the first-frame map
    build goes through here.  A fleet's maps ([B, L*C, W] tables) take
    p_w [B, N, 3], var [B, N, 3, 3] and mask [B, N]: one claim series over
    the flat view, each replica's (point, level) rows in the order a single
    map takes them, the replicas one after another (module doc)."""
    with span("lk.insert.rows"):
        rows = point_insert_rows(cfg, mask, p_w, None)
        moments = moments_rows(cfg, rows, p_w, var)
    return insert_rows(vm, cfg, rows, *moments)


def insert_points_hinted(vm: VoxelMap, cfg: MapConfig, p_w, var, mask, own_keys, own_slot,
                         own_found, own_plane) -> VoxelMap:
    """insert_points reusing the match phase's probe of the same table
    (own_keys [L,N,3] int32, own_slot [L,N] global slots, own_found,
    own_plane [L,N]): rows the probe found keep its slot, and only new keys
    claim (module doc).  With ``insert_row_cap`` > 0 the rows are
    ancestor-gated and compacted (``gated_insert_rows``); otherwise every
    (point, level) row inserts, as ``insert_points`` does.  A fleet's maps
    take p_w [B,N,3], var [B,N,3,3] and mask [B,N] and the probe [L, B*N]
    in fleet slots, as ``match_points`` returns a fleet's."""
    with span("lk.insert.rows"):
        if cfg.insert_row_cap:
            rows = gated_insert_rows(cfg, mask, own_keys, own_slot, own_found, own_plane)
        else:
            rows = point_insert_rows(cfg, mask, None, (own_keys, own_slot, own_found))
        moments = moments_rows(cfg, rows, p_w, var)
    return insert_rows(vm, cfg, rows, *moments)


def insert_rows(vm: VoxelMap, cfg: MapConfig, rows: InsertRows, mom_rows, moms_rows) -> VoxelMap:
    """The insert of ``rows`` with their moment rows (mom [R, 9], moms
    [R, 60]) into one map ([L*C, W] tables) or a fleet's ([B, L*C, W]; the
    rows the replicas' side by side), returned in the same shapes
    (voxel_map.py:755-919 of the JAX module).

    Rows that need a slot claim it (module doc); the others keep ``slot0``.
    Frozen slots (n >= max_points_num) stop accumulating; a slot refits when
    its count passes its level's init threshold and it is new or has
    gathered more than update_size_threshold new points; at most
    refit_budget unique slots a replica refit (the rest wait for a later
    scan); plane rows saturate at the storage dtype's range before the
    downcast; is_plane is mirrored into ptab for the match probe.  ``ocnt``
    gains each replica's rows past the row cap, refits past the budget and
    failed claims."""
    batch = math.prod(vm.ocnt.shape[:-1])
    dtype, dev = vm.meta.dtype, vm.meta.device
    budget = cfg.refit_budget
    flat = [t.reshape(-1, t.shape[-1]) for t in vm[:5]]   # a fleet's tables viewed flat (module doc)

    (ptab_x,) = _sentinel_tables(flat[0])
    miss = ptab_x.shape[0] - 1
    tally("map.claim_rows", rows.keys.shape[0] * cfg.insert_rounds)
    with span("lk.insert.claim"):
        slot_c, claimed = claim_call(ptab_x, rows.keys, rows.seg, rows.need, cfg.capacity, cfg.probe,
                                     cfg.insert_rounds)
    slot = torch.where(claimed, slot_c, rows.slot0)
    del slot_c, claimed  # not held through the tables' copies, which set a fleet's peak memory
    ok = slot < miss
    meta_x, mom_x, moms_x, plane_x = _sentinel_tables(*flat[1:])
    tables = (ptab_x, meta_x, mom_x, moms_x, plane_x)
    tally("map.tables_in_place", all(x.data_ptr() == t.data_ptr() for x, t in zip(tables, flat)))

    with span("lk.insert.accumulate"):
        meta_at = meta_x[slot]
        contrib = ok & (meta_at[:, _M_N] < float(cfg.max_points_num))
        tgt = torch.where(contrib, slot, miss)
        counts = torch.zeros((rows.keys.shape[0], META_DIM), dtype=dtype, device=dev)
        counts[:, _M_N] = 1.0
        counts[:, _M_NEW] = 1.0
        index_add_rows((meta_x, mom_x, moms_x), tgt, (counts, mom_rows, moms_rows), drop=miss,
                       groups=batch)
        for t in (meta_x, mom_x, moms_x):
            t[miss] = 0

        meta_t = meta_x[tgt]
        init_thresh = torch.tensor(cfg.init_num, dtype=dtype, device=dev)[rows.lvl]
        refit = (
            contrib
            & (meta_t[:, _M_N] > init_thresh)
            & ((meta_t[:, _M_INIT] <= 0.5) | (meta_t[:, _M_NEW] > float(cfg.update_size_threshold)))
        )

    with span("lk.insert.refit"):
        # Up to refit_budget unique slots a replica: one sort groups
        # duplicates, a prefix sum packs the unique ids to the front.
        srt = torch.sort(torch.where(refit, tgt, miss).reshape(batch, -1)).values
        first = torch.cat([torch.ones((batch, 1), dtype=torch.bool, device=dev),
                           srt[:, 1:] != srt[:, :-1]], dim=1)
        first = first & (srt < miss)
        pos = torch.cumsum(first.to(torch.int64), 1) - 1
        pos_t = torch.where(first & (pos < budget), pos, budget)
        fs = torch.full((batch, budget + 1), miss, dtype=torch.int64, device=dev)
        fs.scatter_(1, pos_t, srt)
        fs = fs[:, :budget].reshape(-1).contiguous()  # a view at budget 1: the fit kernel takes it dense

        if cfg.use_pallas_refit:
            # The refit kernel, reading each slot's rows from the tables
            # (ops/plane_fit_rows.py), at any budget (the JAX package needs a
            # multiple of 128 for its Pallas block; the kernel here does not).
            # Every fs entry names a row of the sentinel-extended tables: a
            # voxel slot or the sentinel.
            out = fit_slots_call(fit_par(cfg.planer_threshold, dev), meta_x, mom_x, moms_x, fs)
            plane_rows = out[:, 0:PLANE_DIM]
            meta_fit = out[:, PLANE_DIM : PLANE_DIM + META_DIM]
        else:
            meta_r = meta_x[fs]
            n_r = torch.clamp(meta_r[:, _M_N], min=1.0)
            fit = fit_planes(_unpack_moments(mom_x[fs], moms_x[fs].to(dtype), n_r),
                             cfg.planer_threshold)
            plane_rows = torch.cat(
                [fit.center_rel, fit.normal, fit.evals, fit.radius[:, None],
                 fit.plane_var.reshape(-1, 36)[:, list(_TRIU36)]],
                dim=-1,
            )
            meta_fit = torch.stack(
                [meta_r[:, _M_N], torch.zeros_like(n_r), torch.ones_like(n_r),
                 fit.is_plane.to(dtype)],
                dim=-1,
            )
        if plane_x.dtype != plane_rows.dtype:
            # A degenerate scatter gives plane_var ~1/(n eps)^2: finite in f32
            # but inf after a narrow downcast; saturate instead (voxel_map.py:889-896).
            fmax = float(torch.finfo(plane_x.dtype).max)
            plane_rows = torch.clamp(plane_rows, -fmax, fmax)
        # fs repeats only the sentinel (miss) slot, whose row is dropped, so
        # the order in which duplicate writes land there does not matter.
        plane_x.index_copy_(0, fs, plane_rows.to(plane_x.dtype))
        meta_x.index_copy_(0, fs, meta_fit)
        ptab_x.index_put_(
            (fs, torch.full_like(fs, T_PLANE)), (meta_fit[:, _M_PLANE] > 0.5).to(torch.int32)
        )

        inc = torch.stack([rows.n_over.reshape(batch), torch.clamp(first.sum(1) - budget, min=0),
                           (rows.mask & ~ok).reshape(batch, -1).sum(-1)], dim=-1)   # OCNT_* order
        return VoxelMap(*(x[:miss].reshape(t.shape) for x, t in zip(tables, vm[:5])),
                        ocnt=vm.ocnt + inc.to(torch.int32).reshape(vm.ocnt.shape))


# The JAX module's name of the insert of rows whose moment rows are given
# (the moments kernel's, ops/insert_rows.py).
insert_packed_rows_hinted = insert_rows


def match_points(vm: VoxelMap, cfg: MapConfig, p_w: torch.Tensor, var: torch.Tensor,
                 mask: torch.Tensor) -> MatchResult:
    """Point-to-plane association for a batch of world points (p_w [N,3],
    var [N,3,3], mask [N]).

    Two chains of candidate voxels per point, one candidate a level: the
    point's own voxel, and the adjacent voxel on the side where the point
    lies more than a quarter of the voxel from its centre (the neighbour
    retry of KILO.cc:156-178).  All 2 L candidates are probed, gathered and
    gated in one flattened batch: a candidate passes when its slot holds a
    plane, the point's in-plane distance from the plane's centre is within
    ``radius_k`` radii, and its distance from the plane is within
    ``sigma_num`` sigma, with sigma^2 = J plane_var J^T + n^T var n
    (voxel_map.cc:383-386; the plane_var form clamped at 0 against
    reduced-precision storage, the sum floored at 1e-12).  Within a chain a
    level is reachable only while every ancestor exists and is not a plane
    (build_single_residual, voxel_map.cc:371-427); the passing candidate of
    highest probability wins, and the neighbour chain is used only when the
    own chain matched nothing.  A missed slot reads zeros.

    A fleet's maps ([B, L*C, W] tables) take p_w [B,N,3], var [B,N,3,3]
    and mask [B,N]: the replicas' points side by side probe the maps
    viewed flat, point i of replica r in level l's segment r*L + l, and
    each point's result is what a single map gives it.  The per-point
    fields come back [B, N, ...]; the ``own_*`` fields [L, B*N, ...] with
    fleet slots (B*L*C = miss), the layout ``gated_insert_rows`` and
    ``insert_points_hinted`` take."""
    dtype = vm.meta.dtype
    dev = p_w.device
    lead = tuple(p_w.shape[:-2])
    L, b = cfg.levels, math.prod(lead)
    N = b * p_w.shape[-2]                                  # the fleet's points side by side
    p_w, var, mask = p_w.reshape(N, 3), var.reshape(N, 3, 3), mask.reshape(N)
    ptab, plane = vm.ptab.reshape(-1, PTAB_DIM), vm.plane.reshape(-1, PLANE_DIM)

    keys_all = []
    for chain in range(2):
        for lvl in range(L):
            size = level_size(cfg, lvl)
            keys = voxel_key(p_w, size)
            if chain == 1:
                rel = p_w - (keys.to(dtype) + 0.5) * size
                quarter = size / 4.0
                keys = keys + ((rel > quarter).to(torch.int32) - (rel < -quarter).to(torch.int32))
            keys_all.append(keys)
    keys_f = torch.cat(keys_all, dim=0)                    # [2L*N, 3]
    lvl_f = torch.arange(L, dtype=torch.int64, device=dev).repeat_interleave(N).repeat(2)
    rep = torch.arange(b, dtype=torch.int64, device=dev).repeat_interleave(N // b)
    seg_f = (rep[None, :] * L + torch.arange(L, dtype=torch.int64, device=dev)[:, None]).reshape(-1)

    slot, found, _, _, is_plane = probe_plain(ptab, keys_f, seg_f.repeat(2), cfg.capacity, cfg.probe,
                                              b * L * cfg.capacity)
    plane_at = _gather_fill(plane, slot, 0.0).to(dtype)

    sizes = torch.tensor([level_size(cfg, l) for l in range(L)], dtype=dtype, device=dev)[lvl_f]
    center = (keys_f.to(dtype) + 0.5) * sizes[:, None] + plane_at[:, 0:3]
    normal = plane_at[:, 3:6]
    radius = plane_at[:, 9]
    plane_var = _expand_pv(plane_at[:, 10:31])

    rel = p_w.repeat(2 * L, 1) - center
    var_rep = var.repeat(2 * L, 1, 1)
    signed_dist = torch.sum(normal * rel, dim=-1)
    dist = torch.abs(signed_dist)
    d2c = torch.sum(rel * rel, dim=-1)
    range_dis2 = torch.clamp(d2c - dist * dist, min=0.0)
    gate_range = range_dis2 <= (cfg.radius_k * radius) ** 2

    j_nq = torch.cat([rel, -normal], dim=-1)
    sigma_l = torch.clamp(torch.einsum("ni,nij,nj->n", j_nq, plane_var, j_nq), min=0.0)
    sigma_l = sigma_l + torch.einsum("ni,nij,nj->n", normal, var_rep, normal)
    sigma_l = torch.clamp(sigma_l, min=1e-12)
    gate_sigma = dist < cfg.sigma_num * torch.sqrt(sigma_l)
    prob = torch.rsqrt(sigma_l) * torch.exp(-0.5 * dist * dist / sigma_l)
    ok = found & is_plane & gate_range & gate_sigma

    def r2(x, c, l):
        return x[(c * L + l) * N : (c * L + l + 1) * N]

    rows0 = torch.arange(N, dtype=torch.int64, device=dev)
    results = []
    for chain in range(2):
        best_prob = torch.full((N,), -float("inf"), dtype=dtype, device=dev)
        b_matched = torch.zeros((N,), dtype=torch.bool, device=dev)
        b_idx = torch.zeros((N,), dtype=torch.int64, device=dev)   # flat candidate row
        reachable = torch.ones((N,), dtype=torch.bool, device=dev)
        for lvl in range(L):
            okl = r2(ok, chain, lvl) & reachable
            probl = r2(prob, chain, lvl)
            better = okl & (probl > best_prob)
            best_prob = torch.where(better, probl, best_prob)
            b_matched = b_matched | okl
            b_idx = torch.where(better, (chain * L + lvl) * N + rows0, b_idx)
            reachable = reachable & r2(found, chain, lvl) & ~r2(is_plane, chain, lvl)
        results.append((b_matched, b_idx))

    (m_own, i_own), (m_nbr, i_nbr) = results
    use_nbr = ~m_own & m_nbr
    idx = torch.where(use_nbr, i_nbr, i_own)
    per_point = lead + (N // b,)
    return MatchResult(
        matched=((m_own | m_nbr) & mask).reshape(per_point),
        normal=normal[idx].reshape(per_point + (3,)),
        center=center[idx].reshape(per_point + (3,)),
        plane_var=plane_var[idx].reshape(per_point + (6, 6)),
        signed_dist=signed_dist[idx].reshape(per_point),
        own_keys=keys_f[: L * N].reshape(L, N, 3),
        own_slot=slot[: L * N].reshape(L, N),
        own_found=found[: L * N].reshape(L, N),
        own_plane=is_plane[: L * N].reshape(L, N),
    )


def slide_map(vm: VoxelMap, cfg: MapConfig, position: torch.Tensor, half_map_size: int) -> VoxelMap:
    """Drop the voxels outside a box of ``half_map_size`` level-0 voxels
    around ``position`` (mapSliding/clearMemOutOfMap, voxel_map.cc:552-594):
    occupancy and statistics are cleared, and later inserts reuse the slots.
    The distance trigger lives with the caller.  A fleet's maps ([B, L*C,
    W] tables, ``position`` [B, 3]) slide each around its own position."""
    C = cfg.capacity
    dev = vm.ptab.device
    center = torch.stack(
        [torch.floor(position / level_size(cfg, lvl)).to(torch.int32) for lvl in range(cfg.levels)],
        dim=-2,
    )
    halves = torch.tensor([int(half_map_size * (2 ** lvl)) for lvl in range(cfg.levels)],
                          dtype=torch.int32, device=dev)
    delta = vm.ptab[..., 0:3] - center.repeat_interleave(C, dim=-2)
    inside = torch.all(torch.abs(delta) <= halves.repeat_interleave(C)[:, None], dim=-1)
    keep = (vm.ptab[..., T_OCC] > 0) & inside
    kf = keep.to(vm.meta.dtype)[..., None]
    ks = keep.to(vm.moms.dtype)[..., None]
    return vm._replace(
        ptab=vm.ptab * keep.to(torch.int32)[..., None],
        meta=vm.meta * kf,
        mom=vm.mom * kf,
        moms=vm.moms * ks,
        plane=vm.plane * ks.to(vm.plane.dtype),
    )
