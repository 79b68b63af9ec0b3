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
  copies of the tables with one extra sentinel row at L*C: writes aimed at
  a miss land there and are discarded, and the row is zeroed before it is
  read so a gather of a miss reads the JAX fill value 0.  The copies also
  keep the JAX semantics that an insert returns a new map and leaves its
  input untouched.
* Duplicate claims.  Several new keys can claim one empty slot in the same
  round.  XLA on the CPU applies a scatter's duplicate updates in order, so
  the last writer wins; here the winner is picked first
  (``scatter_reduce(amax)`` over the row index) and only whole winning rows
  are written, which gives the same table on the CPU and on the card.
* The hash.  Keys are cast to uint32 and the products wrap (eigen_types.hpp
  :74-82); torch has no full uint32 arithmetic, so it runs in int64 with
  ``& 0xFFFFFFFF``.
* The hinted inserts (``resolve_insert_rows``, both branches of
  ``insert_points_hinted``) claim over all their rows in one series, the
  new keys active.  The JAX module claims over the new keys compacted to
  ``insert_new_cap`` rows when they fit and over all rows otherwise,
  chosen by ``lax.cond`` on their count.  Claims keep their relative order
  either way, so the same keys win the same slots and every branch gives
  the same map; one series needs no host read of the count (eager torch
  would sync once a scan for it) and no second branch run to select from.
  At configs/leg_fusion.yaml's map size (3 x 4,096 rows, tools/claim_ab.py
  on an H100 80GB HBM3 at 700 W): 4.3 ms a claim, against 4.9 for reading
  the count back and 8.8 for running both branches.
* Summation order.  The moment scatter-adds run in row order on both
  devices (core/ordered_sum.py), so two runs on the card give equal maps.

The point-batch match (``match_points``) serves the sequential pipeline,
the ``chain_impl="jax"`` path and the fused path's match off its kernels;
the fused path's kernel match goes through the keys and select kernels
(ops/match_geom.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.match_geom import hash_keys
from ..ops.plane_fit_rows import fit_par, fit_slots_call
from .ordered_sum import index_add_rows
from .plane_fit import PlaneMoments, fit_planes, point_moments

_M_N, _M_NEW, _M_INIT, _M_PLANE = 0, 1, 2, 3
META_DIM = 4
MOM12_DIM = 9
MOMS_DIM = 60
PLANE_DIM = 31
_T_OCC, _T_PLANE = 3, 4
PTAB_DIM = 5
OCNT_ROWCAP, OCNT_REFIT, OCNT_CLAIM = 0, 1, 2

_SYM6 = (0, 1, 2, 4, 5, 8)
_FULL9 = (0, 1, 2, 1, 3, 4, 2, 4, 5)
_SYM21_PAIRS = tuple((i, j) for i in range(6) for j in range(i, 6))
_TRIU36 = tuple(i * 6 + j for (i, j) in _SYM21_PAIRS)
_FULL36 = tuple(_SYM21_PAIRS.index((min(i, j), max(i, j))) for i in range(6) for j in range(6))


class MapConfig(NamedTuple):
    """Static map configuration: the JAX MapConfig's fields but
    insert_new_cap (resolve_insert_rows has no compacted claim path)."""

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


def _with_sentinel(t: torch.Tensor) -> torch.Tensor:
    """A copy of t with one zero row appended (index L*C = the miss slot)."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


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


def _probe_find_flat(ptab, keys, lvl, cfg: MapConfig):
    """Linear-probe lookup of each key in its level's subtable; returns
    (slot, found, empty, has_empty, is_plane), misses = L*C (int64)."""
    C = cfg.capacity
    miss = cfg.levels * C
    base = lvl.to(torch.int64) * C
    h0 = _hash(keys, C).to(torch.int64)
    offs = torch.arange(cfg.probe, dtype=torch.int64, device=keys.device)
    idx = base[:, None] + ((h0[:, None] + offs[None, :]) & (C - 1))
    rows = ptab[idx]                                       # [M, probe, 5]
    occ_at = rows[..., _T_OCC] > 0
    match = occ_at & torch.all(rows[..., 0:3] == keys[:, None, :], dim=-1)
    # First match via min over (offset << 1 | is_plane).
    big = 2 * cfg.probe
    isp_at = (rows[..., _T_PLANE] > 0).to(torch.int64)
    score = torch.where(match, 2 * offs[None, :] + isp_at, big)
    m = torch.min(score, dim=-1).values
    found = m < big
    slot = torch.where(found, base + ((h0 + (m >> 1)) & (C - 1)), miss)
    isp = ((m & 1) == 1) & found
    escore = torch.where(~occ_at, offs[None, :], cfg.probe)
    em = torch.min(escore, dim=-1).values
    has_empty = em < cfg.probe
    empty = torch.where(has_empty, base + ((h0 + em) & (C - 1)), miss)
    return slot, found, empty, has_empty, isp


def _find_or_insert_flat(ptab_x, keys, lvl, active, cfg: MapConfig):
    """Find each key's slot, claiming empty slots for new keys in
    ``insert_rounds`` claim rounds; ``ptab_x`` carries the sentinel row and
    is updated in place.  Returns (ptab_x, slot, resolved & active)."""
    miss = cfg.levels * cfg.capacity
    M = keys.shape[0]
    dev = keys.device
    slot = torch.full((M,), miss, dtype=torch.int64, device=dev)
    resolved = torch.zeros((M,), dtype=torch.bool, device=dev)
    claim = torch.cat(
        [keys, torch.ones((M, 1), dtype=torch.int32, device=dev),
         torch.zeros((M, 1), dtype=torch.int32, device=dev)], dim=1
    )
    rowid = torch.arange(M, dtype=torch.int64, device=dev)
    for _ in range(cfg.insert_rounds):
        s, found, empty, has_empty, _ = _probe_find_flat(ptab_x, keys, lvl, cfg)
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
    s, found, _, _, _ = _probe_find_flat(ptab_x, keys, lvl, cfg)
    newly = active & ~resolved & found
    slot = torch.where(newly, s, slot)
    resolved = resolved | newly
    return ptab_x, slot, resolved & active


def compact_order(mask_f: torch.Tensor, cap: int) -> torch.Tensor:
    """Stable mask compaction: order[i] = source row of the i-th valid row,
    or N (out of range) for unfilled slots."""
    n = mask_f.shape[0]
    pos = torch.cumsum(mask_f.to(torch.int64), 0) - 1
    tgt = torch.where(mask_f & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), n, dtype=torch.int64, device=mask_f.device)
    out.scatter_(0, tgt, torch.arange(n, dtype=torch.int64, device=mask_f.device))
    return out[:cap]


def _ocnt_inc(device, rowcap=0, refit=0, claim=0) -> torch.Tensor:
    """[3] int32 increments of the overflow counters (OCNT_*)."""
    return torch.stack(
        [torch.as_tensor(p, device=device).to(torch.int32).reshape(()) for p in (rowcap, refit, claim)]
    )


def insert_points(vm: VoxelMap, cfg: MapConfig, p_w, var, mask) -> VoxelMap:
    """Insert points at every level and refit touched planes (UpdateVoxelMap
    + init_octo_tree, voxel_map.cc:119-241 / 287-361); the first-frame map
    build goes through here."""
    L, N = cfg.levels, p_w.shape[0]
    keys = torch.cat([voxel_key(p_w, level_size(cfg, l)) for l in range(L)], dim=0)
    lvl_ids = torch.arange(L, dtype=torch.int64, device=p_w.device).repeat_interleave(N)
    mask_f = mask.repeat(L)
    ptab_x, slot, ok = _find_or_insert_flat(_with_sentinel(vm.ptab), keys, lvl_ids, mask_f, cfg)
    return _insert_finish(
        vm, cfg, ptab_x, p_w.repeat(L, 1), var.repeat(L, 1, 1), keys, lvl_ids, slot, ok,
        ocnt_inc=_ocnt_inc(vm.ocnt.device, claim=(mask_f & ~ok).sum()),
    )


class GatedRows(NamedTuple):
    """Ancestor-gated, compacted (point, level) insert rows."""

    order: torch.Tensor
    pidx: torch.Tensor
    keys: torch.Tensor
    lvl: torch.Tensor
    mask: torch.Tensor
    found: torch.Tensor
    slot0: torch.Tensor
    need: torch.Tensor
    n_gated: torch.Tensor


def gated_insert_rows(cfg: MapConfig, mask, own_keys, own_slot, own_found, own_plane) -> GatedRows:
    """A point inserts at level l only while every ancestor voxel exists and
    is not a plane (UpdateOctoTree's descent, voxel_map.cc:185-241); the
    surviving rows are compacted to insert_row_cap (level 0 first)."""
    L, N = own_found.shape
    miss = L * cfg.capacity
    dev = mask.device
    mask_f = mask.repeat(L)
    found_f = own_found.reshape(L * N) & mask_f
    elig = torch.ones((N,), dtype=torch.bool, device=dev)
    gates = []
    for lvl in range(L):
        gates.append(elig)
        elig = elig & own_found[lvl] & ~own_plane[lvl]
    gate_f = torch.cat(gates) & mask_f
    R = cfg.insert_row_cap
    order = compact_order(gate_f, R)
    pidx = torch.clamp(order % N, max=N - 1)
    cols = torch.cat(
        [
            own_keys.reshape(L * N, 3).to(torch.int64),
            torch.arange(L, dtype=torch.int64, device=dev).repeat_interleave(N)[:, None],
            gate_f.to(torch.int64)[:, None],
            found_f.to(torch.int64)[:, None],
            own_slot.reshape(L * N, 1).to(torch.int64),
        ],
        dim=1,
    )
    rows7 = _gather_fill(cols, order, 0)
    mask_r = rows7[:, 4] > 0
    found_r = rows7[:, 5] > 0
    return GatedRows(
        order=order, pidx=pidx, keys=rows7[:, 0:3].to(torch.int32), lvl=rows7[:, 3],
        mask=mask_r, found=found_r,
        slot0=torch.where(found_r & mask_r, rows7[:, 6], miss),
        need=mask_r & ~found_r,
        n_gated=gate_f.sum(),
    )


def resolve_insert_rows(ptab, cfg: MapConfig, rows: GatedRows):
    """Slot resolution: probe-hit rows keep their match-phase slot, new keys
    claim (module doc).  Returns (ptab with sentinel row, slot, ok)."""
    miss = cfg.levels * cfg.capacity
    ptab_x, slot_c, ok_c = _find_or_insert_flat(
        _with_sentinel(ptab), rows.keys, rows.lvl, rows.need, cfg
    )
    slot = torch.where(ok_c, slot_c, rows.slot0)
    return ptab_x, slot, slot < miss


def insert_packed_rows_hinted(vm: VoxelMap, cfg: MapConfig, rows: GatedRows,
                              mom_rows, moms_rows) -> VoxelMap:
    """Gated insert with the per-row moments precomputed by the moments
    kernel (ops/insert_rows.py)."""
    ptab_x, slot, ok = resolve_insert_rows(vm.ptab, cfg, rows)
    return _insert_finish(
        vm, cfg, ptab_x, None, None, rows.keys, rows.lvl, slot, ok,
        ocnt_inc=_ocnt_inc(
            vm.ocnt.device,
            rowcap=torch.clamp(rows.n_gated - cfg.insert_row_cap, min=0),
            claim=(rows.mask & ~ok).sum(),
        ),
        packed_rows=(mom_rows, moms_rows),
    )


def insert_points_hinted(vm: VoxelMap, cfg: MapConfig, p_w, var, mask, own_keys, own_slot,
                         own_found, own_plane=None) -> VoxelMap:
    """insert_points reusing the match phase's probe of the same table
    (own_keys [L,N,3] int32, own_slot [L,N] global slots, own_found,
    own_plane [L,N]): rows the probe found keep its slot, and only new keys
    claim (module doc).  With ``insert_row_cap`` > 0 and ``own_plane``
    given, the rows are ancestor-gated and compacted (``gated_insert_rows``)
    and their moments come from ``p_w``/``var`` [N,3]/[N,3,3]; otherwise
    every (point, level) row inserts, as ``insert_points`` does."""
    L, C, N = cfg.levels, cfg.capacity, p_w.shape[0]
    miss = L * C
    dev = p_w.device
    if cfg.insert_row_cap and own_plane is not None:
        rows = gated_insert_rows(cfg, mask, own_keys, own_slot, own_found, own_plane)
        ptab_x, slot, ok = resolve_insert_rows(vm.ptab, cfg, rows)
        return _insert_finish(
            vm, cfg, ptab_x, p_w[rows.pidx], var[rows.pidx], rows.keys, rows.lvl, slot, ok,
            ocnt_inc=_ocnt_inc(
                vm.ocnt.device,
                rowcap=torch.clamp(rows.n_gated - cfg.insert_row_cap, min=0),
                claim=(rows.mask & ~ok).sum(),
            ),
        )
    keys = own_keys.reshape(L * N, 3)
    lvl_ids = torch.arange(L, dtype=torch.int64, device=dev).repeat_interleave(N)
    mask_f = mask.repeat(L)
    found_f = own_found.reshape(L * N) & mask_f
    need = mask_f & ~found_f
    ptab_x, slot_c, ok_c = _find_or_insert_flat(_with_sentinel(vm.ptab), keys, lvl_ids, need, cfg)
    slot = torch.where(ok_c, slot_c, torch.where(found_f, own_slot.reshape(L * N).to(torch.int64), miss))
    ok = slot < miss
    return _insert_finish(
        vm, cfg, ptab_x, p_w.repeat(L, 1), var.repeat(L, 1, 1), keys, lvl_ids, slot, ok,
        ocnt_inc=_ocnt_inc(vm.ocnt.device, claim=(mask_f & ~ok).sum()),
    )


def _insert_finish(vm: VoxelMap, cfg: MapConfig, ptab_x, p_w_rows, var_rows, keys, lvl_ids,
                   slot, ok, ocnt_inc, packed_rows=None) -> VoxelMap:
    """Moment accumulation, thresholds and the budgeted refit, after slot
    resolution (voxel_map.py:755-919).  ``ptab_x`` carries the sentinel row.

    Frozen slots (n >= max_points_num) stop accumulating; a slot refits when
    its count passes its level's init threshold and it is new or has
    gathered more than update_size_threshold new points; at most
    refit_budget unique slots refit (the rest wait for a later scan and
    count in ocnt); plane rows saturate at the storage dtype's range before
    the downcast; is_plane is mirrored into ptab for the match probe."""
    dtype = vm.meta.dtype
    dev = vm.meta.device
    L, C = cfg.levels, cfg.capacity
    miss = L * C
    budget = cfg.refit_budget
    meta_x, mom_x = _with_sentinel(vm.meta), _with_sentinel(vm.mom)
    moms_x, plane_x = _with_sentinel(vm.moms), _with_sentinel(vm.plane)

    meta_at = meta_x[slot]
    contrib = ok & (meta_at[:, _M_N] < float(cfg.max_points_num))
    tgt = torch.where(contrib, slot, miss)

    if packed_rows is not None:
        mom_rows, moms_rows = packed_rows
    else:
        sizes = torch.tensor([level_size(cfg, l) for l in range(L)], dtype=dtype, device=dev)
        vc = (keys.to(dtype) + 0.5) * sizes[lvl_ids][:, None]
        mom_rows, moms_rows = _pack_moments(point_moments(p_w_rows - vc, var_rows))

    counts = torch.zeros((keys.shape[0], META_DIM), dtype=dtype, device=dev)
    counts[:, _M_N] = 1.0
    counts[:, _M_NEW] = 1.0
    index_add_rows((meta_x, mom_x, moms_x), tgt, (counts, mom_rows, moms_rows), drop=miss)
    for t in (meta_x, mom_x, moms_x):
        t[miss] = 0

    meta_t = meta_x[tgt]
    init_thresh = torch.tensor(cfg.init_num, dtype=dtype, device=dev)[lvl_ids]
    refit = (
        contrib
        & (meta_t[:, _M_N] > init_thresh)
        & ((meta_t[:, _M_INIT] <= 0.5) | (meta_t[:, _M_NEW] > float(cfg.update_size_threshold)))
    )

    # Up to refit_budget unique slots: one sort groups duplicates, a prefix
    # sum packs the unique ids to the front.
    srt = torch.sort(torch.where(refit, tgt, miss)).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), srt[1:] != srt[:-1]])
    first = first & (srt < miss)
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    pos_t = torch.where(first & (pos < budget), pos, budget)
    fs = torch.full((budget + 1,), miss, dtype=torch.int64, device=dev)
    fs.scatter_(0, pos_t, srt)
    fs = fs[:budget]

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
        fit = fit_planes(_unpack_moments(mom_x[fs], moms_x[fs].to(dtype), n_r), cfg.planer_threshold)
        plane_rows = torch.cat(
            [fit.center_rel, fit.normal, fit.evals, fit.radius[:, None],
             fit.plane_var.reshape(-1, 36)[:, list(_TRIU36)]],
            dim=-1,
        )
        meta_fit = torch.stack(
            [meta_r[:, _M_N], torch.zeros_like(n_r), torch.ones_like(n_r), fit.is_plane.to(dtype)],
            dim=-1,
        )
    if plane_x.dtype != plane_rows.dtype:
        # A degenerate scatter gives plane_var ~1/(n eps)^2: finite in f32
        # but inf after a narrow downcast; saturate instead (voxel_map.py:889-896).
        fmax = float(torch.finfo(plane_x.dtype).max)
        plane_rows = torch.clamp(plane_rows, -fmax, fmax)
    # fs repeats only the sentinel (miss) slot, whose row is dropped, so the
    # order in which duplicate writes land there does not matter.
    plane_x.index_copy_(0, fs, plane_rows.to(plane_x.dtype))
    meta_x.index_copy_(0, fs, meta_fit)
    ptab_x.index_put_(
        (fs, torch.full_like(fs, _T_PLANE)), (meta_fit[:, _M_PLANE] > 0.5).to(torch.int32)
    )

    inc = _ocnt_inc(dev, refit=torch.clamp(first.sum() - budget, min=0)) + ocnt_inc
    return VoxelMap(
        ptab=ptab_x[:miss], meta=meta_x[:miss], mom=mom_x[:miss], moms=moms_x[:miss],
        plane=plane_x[:miss], ocnt=vm.ocnt + inc,
    )


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
    own chain matched nothing.  A missed slot reads zeros."""
    dtype = vm.meta.dtype
    dev = p_w.device
    L, N = cfg.levels, p_w.shape[0]

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

    slot, found, _, _, is_plane = _probe_find_flat(vm.ptab, keys_f, lvl_f, cfg)
    plane_at = _gather_fill(vm.plane, slot, 0.0).to(dtype)

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
    return MatchResult(
        matched=(m_own | m_nbr) & mask,
        normal=normal[idx],
        center=center[idx],
        plane_var=plane_var[idx],
        signed_dist=signed_dist[idx],
        own_keys=keys_f[: L * N].reshape(L, N, 3),
        own_slot=slot[: L * N].reshape(L, N),
        own_found=found[: L * N].reshape(L, N),
        own_plane=is_plane[: L * N].reshape(L, N),
    )


def slide_map(vm: VoxelMap, cfg: MapConfig, position: torch.Tensor, half_map_size: int) -> VoxelMap:
    """Drop the voxels outside a box of ``half_map_size`` level-0 voxels
    around ``position`` (mapSliding/clearMemOutOfMap, voxel_map.cc:552-594):
    occupancy and statistics are cleared, and later inserts reuse the slots.
    The distance trigger lives with the caller."""
    C = cfg.capacity
    dev = vm.ptab.device
    center = torch.stack(
        [torch.floor(position / level_size(cfg, lvl)).to(torch.int32) for lvl in range(cfg.levels)]
    )
    halves = torch.tensor([int(half_map_size * (2 ** lvl)) for lvl in range(cfg.levels)],
                          dtype=torch.int32, device=dev)
    delta = vm.ptab[:, 0:3] - center.repeat_interleave(C, dim=0)
    inside = torch.all(torch.abs(delta) <= halves.repeat_interleave(C)[:, None], dim=-1)
    keep = (vm.ptab[:, _T_OCC] > 0) & inside
    kf = keep.to(vm.meta.dtype)[:, None]
    ks = keep.to(vm.moms.dtype)[:, None]
    return vm._replace(
        ptab=vm.ptab * keep.to(torch.int32)[:, None],
        meta=vm.meta * kf,
        mom=vm.mom * kf,
        moms=vm.moms * ks,
        plane=vm.plane * ks.to(vm.plane.dtype),
    )
