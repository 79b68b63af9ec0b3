"""The deferred scan pipeline (port of legkilo_tpu/core/filter_deferred.py).

Two paths, chosen by ``chain_impl``.  ``"fused"`` is the main path: per
scan, as ``_process_scan_fused`` of the JAX package, each phase on its
kernel when its switch is on and on the configuration's own torch path
(the JAX package's XLA path) when it is off:

1. Match poses per bucket (``_predicted_bucket_poses``): from the scan's own
   IMU events, by the pose kernel (``use_pallas_pose``, ops/pose_prop.py)
   or in plain torch (``_predicted_bucket_poses_imu``), or by
   constant-velocity extrapolation.
2. Match, on the valid points compacted to the cap: with
   ``use_pallas_match``, the keys kernel, the hash probe as torch glue
   (one wide gather of ptab rows) and the select kernel, which also sums
   the per-bucket 40x40 statistics s40
   (``_match_compact_stats_kernel``, the JAX
   ``_match_compact_stats_pallas``); otherwise ``voxel_map.match_points``
   and ``eskf_fused.point_suffstats_compact`` (``_match_compact_stats``).
3. The chain over the buckets: the chain kernel with ``use_pallas``
   (ops/chain_stats.py), else ``_chain_fused_core``, the same recursion as
   a Python loop over the buckets in eager torch; with ``match_iters`` > 1,
   re-match at the chain's post-update bucket poses and re-run the chain
   from the scan-start state.
4. Insert: with ``use_pallas_insert``, ``insert_reuse_probe`` and a
   positive ``insert_row_cap``, the ancestor-gated rows, the moments
   kernel, then the scatter-adds, thresholds and refit (the refit kernel,
   ops/plane_fit_rows.py, or plain ``fit_planes``) of
   core/voxel_map.py (``insert_phase``); otherwise the world points and
   variances at the post-update bucket poses and
   ``voxel_map.insert_points_hinted`` (or, with ``insert_reuse_probe``
   off, the claiming ``insert_points``).
5. With ``map_sliding_en``, the map slide once the pose has moved
   ``sliding_thresh`` from the last slide.

Any mix of the switches is legal, as in JAX: an XLA match can feed the
chain and moments kernels.  The route follows the switches alone: the
JAX package also sends a phase to XLA when its cap is no multiple of a
Pallas row block (``_pick_block``), but the port's kernels take any row
count, so a cap such as 1,100 runs the kernels here.

``"jax"`` is the per-point path (the JAX package's lax.scan chain): the
same match poses; ``_batched_match`` with ``voxel_map.match_points`` gives
per-point match rows in bucket layout [NB, P] (compacted to ``match_cap``
rows for the probe and scattered back); the per-point chain kernel
(ops/chain_points.py; one warp, as the fused chain) reduces each bucket's
points to its 6x6 normal equations inside the chain; the insert recomputes world points and
variances at the chain's post-update bucket poses and goes through the
claiming ``insert_points``.  The chain, match and insert switches and
the probe reuse belong to the fused path and are not read here;
``use_pallas_pose`` and ``use_pallas_refit`` act on both.

With ``return_cloud`` both paths return the scan's points in the world
frame at the chain's post-update bucket poses, [NB, P, 3].
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import insert_rows as ir
from ..ops import match_geom as mg
from ..ops import pose_prop as pp
from ..ops.chain_points import run_chain
from ..ops.chain_stats import chain_plain, pack_state_and_events, run_chain_stats, unpack_chain_outputs
from .filter import (
    FilterCarry,
    FilterParams,
    ScanOutput,
    ScanPacket,
    StaticConfig,
    _slide_if_moved,
    maybe_symmetrize_cov,
)
from .plane_fit import calc_body_cov
from .eskf_fused import point_suffstats_compact
from .so3 import exp_so3, skew
from .voxel_map import (
    _gather_fill,
    compact_order,
    gated_insert_rows,
    insert_packed_rows_hinted,
    insert_points,
    insert_points_hinted,
    match_points,
)

F32 = torch.float32


def _row_cap(scfg: StaticConfig, nb: int, p: int) -> int:
    cap = max(scfg.match_cap, scfg.insert_cap) or nb * p
    return min(cap, nb * p)


def check_supported(scfg: StaticConfig, nb: int, p: int) -> None:
    """Raise NotImplementedError for a value no path of the port (nor of the
    JAX package) takes: a ``chain_impl`` other than "fused" or "jax", or a
    ``match_pose`` other than "imu" or "const_vel".  (The runner refuses a
    dtype other than float32.)"""
    missing = [k for k, v in {
        "chain_impl not 'fused' or 'jax'": scfg.chain_impl not in ("fused", "jax"),
        "match_pose not 'imu' or 'const_vel'": scfg.match_pose not in ("imu", "const_vel"),
    }.items() if v]
    if missing:
        raise NotImplementedError("legkilo_torch has not ported: " + "; ".join(missing))


def _predicted_bucket_poses_imu(carry: FilterCarry, packet: ScanPacket, params: FilterParams):
    """Match poses per bucket: the scan's IMU events integrated from the
    scan-start state through the event/bucket timeline, with the latched
    rates replaced by their innovation-free post-update values after each
    event (imu_w -> gyr - bw, imu_a -> (g/|a|) acc - ba).  Returns
    (rot [NB,3,3], pos [NB,3])."""
    st0 = carry.state
    dtype, dev = carry.cov.dtype, carry.cov.device
    nb, kmax = packet.imu_time.shape
    t_all = torch.cat([packet.imu_time, packet.bucket_time[:, None]], dim=1).reshape(-1)
    gate = torch.cat([packet.imu_mask, packet.bucket_mask[:, None]], dim=1).reshape(-1)
    is_ev = torch.cat(
        [packet.imu_mask, torch.zeros((nb, 1), dtype=torch.bool, device=dev)], dim=1
    ).reshape(-1)
    m = t_all.shape[0]
    zpad = torch.zeros((nb, 1, 3), dtype=dtype, device=dev)
    w_meas = torch.cat([packet.imu_gyr, zpad], dim=1).reshape(m, 3) - st0.bw
    a_meas = (
        params.g_over_acc_norm * torch.cat([packet.imu_acc, zpad], dim=1).reshape(m, 3)
        - st0.ba
    )

    # Segment j runs on the rates of the last valid event strictly before j,
    # or on the carried latched rates before any event.
    idx = torch.where(is_ev, torch.arange(m, device=dev), -1)
    last_ev = torch.cummax(idx, dim=0).values
    prev_ev = torch.cat([last_ev.new_full((1,), -1), last_ev[:-1]])
    has = (prev_ev >= 0)[:, None]
    prev_c = torch.clamp(prev_ev, 0, m - 1)
    w_seg = torch.where(has, w_meas[prev_c], st0.imu_w)
    a_seg = torch.where(has, a_meas[prev_c], st0.imu_a)

    # dt replicates the chain's last-predict clock; masked slots are no-ops.
    lp = carry.last_predict_t.to(dtype)
    tv = torch.where(gate, t_all, torch.full_like(t_all, -float("inf")))
    t_end = torch.maximum(torch.cummax(tv, dim=0).values, lp)
    t_start = torch.cat([lp[None], t_end[:-1]])
    dt = torch.where(gate, t_all - t_start, torch.zeros_like(t_all))

    # Inclusive prefix product of the per-segment delta rotations
    # (Hillis-Steele: log2(M) batched 3x3 products).
    prefix = exp_so3(w_seg * dt[:, None])
    s = 1
    while s < m:
        prefix = torch.cat([prefix[:s], prefix[:-s] @ prefix[s:]])
        s *= 2
    r_end = st0.rot @ prefix
    r_start = torch.cat([st0.rot[None], r_end[:-1]])
    dv = dt[:, None] * ((r_start @ a_seg[:, :, None])[..., 0] + st0.grav)
    v_end = st0.vel + torch.cumsum(dv, dim=0)
    v_start = torch.cat([st0.vel[None], v_end[:-1]])
    p_end = st0.pos + torch.cumsum(dt[:, None] * v_start, dim=0)
    sel = (torch.arange(nb, device=dev) + 1) * (kmax + 1) - 1
    return r_end[sel], p_end[sel]


def _predicted_bucket_poses_imu_kernel(carry: FilterCarry, packet: ScanPacket, params: FilterParams):
    """``_predicted_bucket_poses_imu`` on the pose kernel (ops/pose_prop.py):
    the same timeline as [9, MP] rows, MP = NB (K+1) padded to 128."""
    st0 = carry.state
    dtype, dev = carry.cov.dtype, carry.cov.device
    nb, kmax = packet.imu_time.shape
    m = nb * (kmax + 1)
    mp = ((m + 127) // 128) * 128
    zpad3 = torch.zeros((nb, 1, 3), dtype=dtype, device=dev)
    ev = packet.imu_mask.to(dtype)
    rows = torch.cat([
        torch.cat([packet.imu_time, packet.bucket_time[:, None]], dim=1).reshape(1, m),
        torch.cat([ev, packet.bucket_mask.to(dtype)[:, None]], dim=1).reshape(1, m),
        torch.cat([ev, torch.zeros_like(ev[:, :1])], dim=1).reshape(1, m),
        torch.cat([packet.imu_gyr, zpad3], dim=1).reshape(m, 3).T,
        torch.cat([packet.imu_acc, zpad3], dim=1).reshape(m, 3).T,
    ])
    rows = torch.nn.functional.pad(rows, (0, mp - m)).contiguous()
    par = torch.cat([
        st0.rot.reshape(9), st0.pos, st0.vel, st0.ba, st0.bw, st0.grav, st0.imu_w, st0.imu_a,
        carry.last_predict_t.to(dtype)[None], params.g_over_acc_norm.to(dtype).reshape(1),
    ])
    out = pp.pose_call(par, rows)
    sel = (torch.arange(nb, device=dev) + 1) * (kmax + 1) - 1
    return out[0:9, sel].T.reshape(nb, 3, 3), out[9:12, sel].T


def _predicted_bucket_poses_const_vel(carry: FilterCarry, packet: ScanPacket):
    """Constant-velocity, constant-rate match poses per bucket."""
    st0 = carry.state
    dtb = packet.bucket_time
    rb = st0.rot @ exp_so3(dtb[:, None] * st0.imu_w[None, :])
    pb = st0.pos[None, :] + dtb[:, None] * st0.vel[None, :]
    return rb, pb


def _predicted_bucket_poses(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                            scfg: StaticConfig):
    """Match poses per bucket, dispatched on scfg.match_pose."""
    if scfg.match_pose == "imu":
        if scfg.use_pallas_pose:
            return _predicted_bucket_poses_imu_kernel(carry, packet, params)
        return _predicted_bucket_poses_imu(carry, packet, params)
    return _predicted_bucket_poses_const_vel(carry, packet)


def _match_compact_stats(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                         scfg: StaticConfig, cap: int, poses=None):
    """Match phase on the configuration's own torch path (the JAX XLA
    ``_match_compact_stats``): the valid points compacted to ``cap`` rows,
    their world points and variances at the match poses,
    ``voxel_map.match_points``, the measurement variance (KILO.cc:201-209)
    and the per-bucket statistics by ``eskf_fused.point_suffstats_compact``.
    Returns (s40 [NB,40,40], nmatch [NB] int32, aux) with aux = (order,
    bidx, p_i_c [cap,3], body_cov_c [cap,3,3], mask_c, own_keys [L,cap,3]
    int32, own_slot, own_found, own_plane [L,cap]) for the insert phase:
    the JAX aux less ``pts_c`` and ``cross_c``, which no insert reads (the
    insert off the moments kernel forms ``skew(p_i_c)`` itself)."""
    cov0 = carry.cov
    nb, p, _ = packet.points.shape
    rb, pb = poses if poses is not None else _predicted_bucket_poses(carry, packet, params, scfg)

    mask_f = (packet.point_mask & packet.bucket_mask[:, None]).reshape(-1)
    order = compact_order(mask_f, cap)
    mask_c = _gather_fill(mask_f, order, False)
    bidx = order // p                                       # nb for padding rows
    bidx_c = torch.clamp(bidx, max=nb - 1)

    pts_c = _gather_fill(packet.points.reshape(-1, 3), order, 0.0)
    p_i_c = pts_c @ params.ext_r.T + params.ext_t
    cross_c = skew(p_i_c)
    body_cov_c = calc_body_cov(pts_c, scfg.dept_err, scfg.beam_err)
    rb_c = rb[bidx_c]
    p_w_c = torch.einsum("cij,cj->ci", rb_c, p_i_c) + pb[bidx_c]
    rot_ext_c = rb_c @ params.ext_r
    rot_cross_c = rb_c @ cross_c
    var_bw = torch.einsum("cij,cjk,clk->cil", rot_ext_c, body_cov_c, rot_ext_c)
    var_c = (
        var_bw
        + torch.einsum("cij,jk,clk->cil", rot_cross_c, cov0[0:3, 0:3], rot_cross_c)
        + cov0[3:6, 3:6]
    )
    m = match_points(carry.vm, scfg.map_cfg, p_w_c, var_c, mask_c)

    j_nq = torch.cat([p_w_c - m.center, -m.normal], dim=-1)
    single_l = torch.clamp(torch.einsum("ci,cij,cj->c", j_nq, m.plane_var, j_nq), min=0.0)
    r_c = params.noise.lidar_point_meas_ratio * (
        single_l + torch.einsum("ci,cij,cj->c", m.normal, var_bw, m.normal)
    )
    matched_c = m.matched & mask_c
    s40 = point_suffstats_compact(p_i_c, m.normal, m.center, r_c, matched_c, bidx, nb)
    # Integer counts: their sum does not depend on the order of the adds.
    nmatch_b = torch.zeros((nb + 1,), dtype=torch.int32, device=bidx.device).index_add_(
        0, bidx, matched_c.to(torch.int32))[:nb]
    aux = (order, bidx, p_i_c, body_cov_c, mask_c, m.own_keys, m.own_slot, m.own_found, m.own_plane)
    return s40, nmatch_b, aux


def _match_compact_stats_kernel(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                                scfg: StaticConfig, cap: int, poses=None):
    """Match phase on the keys and select kernels (the JAX
    ``_match_compact_stats_pallas``); the contract of
    ``_match_compact_stats``."""
    cov0 = carry.cov
    nb, p, _ = packet.points.shape
    dtype, dev = cov0.dtype, cov0.device
    mcfg = scfg.map_cfg
    L, C = mcfg.levels, mcfg.capacity
    miss = L * C
    rb, pb = poses if poses is not None else _predicted_bucket_poses(carry, packet, params, scfg)

    mask_f = (packet.point_mask & packet.bucket_mask[:, None]).reshape(-1)
    order = compact_order(mask_f, cap)
    mask_c = _gather_fill(mask_f, order, False)
    bidx = order // p                                       # nb for padding rows
    bidx_c = torch.clamp(bidx, max=nb - 1)
    pts_c = _gather_fill(packet.points.reshape(-1, 3), order, 0.0)
    pts_t = pts_c.T.contiguous()
    rb_t = rb.reshape(nb, 9).T[:, bidx_c].contiguous()
    pb_t = pb.T[:, bidx_c].contiguous()

    sizes = [mcfg.voxel_size / (2.0 ** lvl) for lvl in range(L)] + [0.0] * (4 - L)
    par1 = torch.cat([
        params.ext_r.reshape(9), params.ext_t,
        torch.tensor(sizes, dtype=dtype, device=dev),
        cov0[0:3, 0:3].reshape(9), cov0[3:6, 3:6].reshape(9),
        torch.tensor([scfg.dept_err, scfg.beam_err], dtype=dtype, device=dev),
        torch.zeros(64 - 36, dtype=dtype, device=dev),
    ])
    piw_t, covs_t, keys_t, vc_t, idx0_t = mg.keys_call(par1, pts_t, rb_t, pb_t, L, C)

    # Probe (torch glue): one wide gather of the ptab rows of every probe
    # offset; the first match wins, encoded as (offset << 1 | is_plane).
    offs = torch.arange(mcfg.probe, dtype=torch.int64, device=dev)
    idx0 = idx0_t.to(torch.int64)
    h0 = idx0 & (C - 1)
    base = idx0 - h0
    idx = base[:, :, None] + ((h0[:, :, None] + offs) & (C - 1))  # [2L, cap, probe]
    k_at = carry.vm.ptab[idx]                                     # [2L, cap, probe, 5]
    keys_cmp = keys_t.reshape(2 * L, 3, cap).permute(0, 2, 1)
    match = (k_at[..., 3] > 0) & torch.all(k_at[..., 0:3] == keys_cmp[:, :, None, :], dim=-1)
    big = 2 * mcfg.probe
    score = torch.where(match, 2 * offs + (k_at[..., 4] > 0).to(torch.int64), big)
    msel = torch.min(score, dim=-1).values
    found = msel < big
    slot = torch.where(found, base + ((h0 + (msel >> 1)) & (C - 1)), miss)
    isp = ((msel & 1) == 1) & found

    plane_at = _gather_fill(carry.vm.plane, slot, 0.0).to(dtype)  # [2L, cap, 31]
    plane_t = plane_at.permute(0, 2, 1).reshape(2 * L * 31, cap).contiguous()
    flags_t = torch.cat([found.to(dtype), isp.to(dtype)], dim=0)
    par2 = torch.cat([
        torch.tensor([mcfg.sigma_num, mcfg.radius_k], dtype=dtype, device=dev),
        params.noise.lidar_point_meas_ratio.reshape(1).to(dtype),
        torch.zeros(5, dtype=dtype, device=dev),
    ])
    _, s40_flat, nm = mg.select_call(
        par2, piw_t, covs_t[0:18].contiguous(), vc_t, plane_t, flags_t,
        mask_c.to(dtype)[None, :], bidx.to(dtype)[None, :], L, nb,
    )
    s40 = s40_flat.reshape(nb, 40, 40)
    nmatch_b = nm[:, 0].to(torch.int32)

    p_i_c = piw_t[0:3].T
    aux = (
        order, bidx, p_i_c, covs_t[18:27].T.reshape(cap, 3, 3), mask_c,
        keys_t[0 : 3 * L].reshape(L, 3, cap).permute(0, 2, 1),
        slot[0:L], found[0:L], isp[0:L],
    )
    return s40, nmatch_b, aux


def _batched_match(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                   scfg: StaticConfig, poses=None):
    """Match phase of the per-point path: match poses, point transforms and
    variances, ``match_points``, and the measurement variance
    (KILO.cc:201-209) at the match poses.  Returns (p_i [NB,P,3], normal,
    center [NB,P,3], r_meas [NB,P], matched [NB,P] bool, crossmat
    [NB,P,3,3]) in bucket layout.

    With ``match_cap`` under NB*P the valid rows are compacted to the front
    so the variance products and the map probe run over ``match_cap`` rows;
    the results are scattered back, rows left behind (invalid, or valid
    beyond the cap) reading zeros and unmatched."""
    cov0 = carry.cov
    nb, p, _ = packet.points.shape
    dtype, dev = cov0.dtype, cov0.device
    rb, pb = poses if poses is not None else _predicted_bucket_poses(carry, packet, params, scfg)

    pts = packet.points                                    # [NB,P,3] body
    p_i = pts @ params.ext_r.T + params.ext_t              # [NB,P,3]
    crossmat = skew(p_i)                                   # [NB,P,3,3]
    rot_ext = rb @ params.ext_r                            # [NB,3,3]
    mask = packet.point_mask & packet.bucket_mask[:, None]
    ratio = params.noise.lidar_point_meas_ratio

    if scfg.match_cap and scfg.match_cap < nb * p:
        mask_f = mask.reshape(-1)
        order = compact_order(mask_f, scfg.match_cap)      # [C]; nb*p for unfilled slots
        bidx = torch.clamp(order // p, max=nb - 1)
        pts_c = _gather_fill(pts.reshape(-1, 3), order, 0.0)
        p_i_c = _gather_fill(p_i.reshape(-1, 3), order, 0.0)
        rb_c = rb[bidx]
        p_w_c = torch.einsum("cij,cj->ci", rb_c, p_i_c) + pb[bidx]
        body_cov_c = calc_body_cov(pts_c, scfg.dept_err, scfg.beam_err)
        cross_c = _gather_fill(crossmat.reshape(-1, 3, 3), order, 0.0)
        rot_ext_c = rot_ext[bidx]
        rot_cross_c = rb_c @ cross_c
        var_bw = torch.einsum("cij,cjk,clk->cil", rot_ext_c, body_cov_c, rot_ext_c)
        var_c = (
            var_bw
            + torch.einsum("cij,jk,clk->cil", rot_cross_c, cov0[0:3, 0:3], rot_cross_c)
            + cov0[3:6, 3:6]
        )
        mask_c = _gather_fill(mask_f, order, False)
        m = match_points(carry.vm, scfg.map_cfg, p_w_c, var_c, mask_c)

        j_nq = torch.cat([p_w_c - m.center, -m.normal], dim=-1)
        single_l = torch.clamp(torch.einsum("ci,cij,cj->c", j_nq, m.plane_var, j_nq), min=0.0)
        r_c = ratio * (single_l + torch.einsum("ci,cij,cj->c", m.normal, var_bw, m.normal))

        # Scatter back through a sentinel row at nb*p, which takes every
        # unfilled slot's write and is cut off again.
        def back(rows, fill_dtype):
            out = torch.zeros((nb * p + 1,) + tuple(rows.shape[1:]), dtype=fill_dtype, device=dev)
            out[order] = rows
            return out[: nb * p]

        normal = back(m.normal, dtype).reshape(nb, p, 3)
        center = back(m.center, dtype).reshape(nb, p, 3)
        r_meas = back(r_c, dtype).reshape(nb, p)
        matched = back(m.matched & mask_c, torch.bool).reshape(nb, p)
        return p_i, normal, center, r_meas, matched, crossmat

    p_w = torch.einsum("bij,bpj->bpi", rb, p_i) + pb[:, None, :]
    body_cov = calc_body_cov(pts, scfg.dept_err, scfg.beam_err)   # [NB,P,3,3]
    rot_cross = rb[:, None] @ crossmat
    var_bw = torch.einsum("bij,bpjk,blk->bpil", rot_ext, body_cov, rot_ext)
    var = (
        var_bw
        + torch.einsum("bpij,jk,bplk->bpil", rot_cross, cov0[0:3, 0:3], rot_cross)
        + cov0[3:6, 3:6]
    )
    m = match_points(carry.vm, scfg.map_cfg, p_w.reshape(nb * p, 3), var.reshape(nb * p, 3, 3),
                     mask.reshape(-1))
    normal = m.normal.reshape(nb, p, 3)
    center = m.center.reshape(nb, p, 3)
    j_nq = torch.cat([p_w - center, -normal], dim=-1)
    single_l = torch.clamp(
        torch.einsum("bpi,bpij,bpj->bp", j_nq, m.plane_var.reshape(nb, p, 6, 6), j_nq), min=0.0
    )
    r_meas = ratio * (single_l + torch.einsum("bpi,bpij,bpj->bp", normal, var_bw, normal))
    matched = m.matched.reshape(nb, p) & mask
    return p_i, normal, center, r_meas, matched, crossmat


def _chain_jax(carry: FilterCarry, packet: ScanPacket, params: FilterParams, scfg: StaticConfig,
               p_i, normal, center, r_meas, matched):
    """The per-point chain over pre-matched planes (the JAX package's
    lax.scan ``_chain_jax``), on the per-point chain kernel."""
    return run_chain(carry, packet, params, p_i, normal, center, r_meas, matched,
                     use_kin=scfg.use_kin)


def _process_scan_points(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                         scfg: StaticConfig) -> Tuple[FilterCarry, ScanOutput]:
    """The per-point scan step (``chain_impl="jax"``): match rows in bucket
    layout, the per-point chain, then one batched insert at the chain's
    post-update bucket poses (KILO.cc:216-231 recompute + UpdateVoxelMap)."""
    nb, p, _ = packet.points.shape
    ocnt0 = carry.vm.ocnt

    carry0, poses = carry, None
    for _ in range(max(1, scfg.match_iters)):
        p_i, normal, center, r_meas, matched, crossmat = _batched_match(
            carry0, packet, params, scfg, poses)
        carry, rots, poss, rot_covs, pos_covs, nmatch = _chain_jax(
            carry0, packet, params, scfg, p_i, normal, center, r_meas, matched)
        poses = (rots, poss)

    p_w = torch.einsum("bij,bpj->bpi", rots, p_i) + poss[:, None, :]
    body_cov = calc_body_cov(packet.points, scfg.dept_err, scfg.beam_err)
    rot_ext = rots @ params.ext_r
    rot_cross = rots[:, None] @ crossmat
    var = (
        torch.einsum("bij,bpjk,blk->bpil", rot_ext, body_cov, rot_ext)
        + torch.einsum("bpij,bjk,bplk->bpil", rot_cross, rot_covs, rot_cross)
        + pos_covs[:, None]
    )
    mask = packet.point_mask & packet.bucket_mask[:, None]
    p_w_f, var_f, mask_f = p_w.reshape(nb * p, 3), var.reshape(nb * p, 3, 3), mask.reshape(-1)
    if scfg.insert_cap and scfg.insert_cap < nb * p:
        # Valid points to the front: the insert works on insert_cap rows.
        order = compact_order(mask_f, scfg.insert_cap)
        p_w_f = _gather_fill(p_w_f, order, 0.0)
        var_f = _gather_fill(var_f, order, 0.0)
        mask_f = _gather_fill(mask_f, order, False)
    carry = carry._replace(vm=insert_points(carry.vm, scfg.map_cfg, p_w_f, var_f, mask_f))

    if scfg.map_sliding_en:
        carry = _slide_if_moved(carry, scfg)

    n_valid = mask.sum().to(torch.int32)
    caps = [c for c in (scfg.match_cap, scfg.insert_cap) if c and c < nb * p]
    cap_dropped = torch.clamp(n_valid - min(caps), min=0) if caps else torch.zeros_like(n_valid)
    out = ScanOutput(
        rot=carry.state.rot,
        pos=carry.state.pos,
        n_matched=nmatch.sum(),
        n_points=n_valid,
        n_cap_dropped=cap_dropped,
        map_overflow=carry.vm.ocnt - ocnt0,
        cloud_world=p_w if scfg.return_cloud else None,
    )
    return carry, out


def insert_phase(vm, mcfg, params: FilterParams, bidx, p_i_c, body_cov_c, mask_c,
                 own_keys, own_slot, own_found, own_plane, rots, poss, rot_covs, pos_covs):
    """Insert on the moments kernel (the JAX ``insert_phase_pallas``):
    gated rows, the kernel's moment rows read by index from the chain's
    per-bucket outputs and the match phase's per-point rows, then the map
    update."""
    rows = gated_insert_rows(mcfg, mask_c, own_keys, own_slot, own_found, own_plane)
    # rows.pidx names points of p_i_c, rows.lvl levels of the map, and bidx
    # (order // P) is never negative: the kernel reads them unchecked but
    # for a trap.
    mom_rows, moms_rows = ir.moments_rows_call(
        params.ext_r, ir.level_sizes(mcfg.voxel_size, mcfg.levels, p_i_c.device),
        rots, poss, rot_covs, pos_covs, p_i_c, body_cov_c, rows.pidx, bidx, rows.keys, rows.lvl,
    )
    return insert_packed_rows_hinted(vm, mcfg, rows, mom_rows, moms_rows)


def _chain_fused_core(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                      scfg: StaticConfig, s40, nmatch_b):
    """The chain off its kernel (the JAX ``_chain_fused_core``, a lax.scan
    in XLA): the same bucket recursion in eskf_fused ops as a Python loop
    over the buckets in eager torch (``ops.chain_stats.chain_plain``, the
    chain kernel's plain version).  The gates are ``torch.where`` selects,
    so nothing is read back to the host inside the loop.  Returns what
    ``run_chain_stats`` returns."""
    head, events = pack_state_and_events(carry, packet, params, scfg.use_kin)
    brow = torch.stack([packet.bucket_time, packet.bucket_mask.to(F32), nmatch_b.to(F32)], dim=1)
    return unpack_chain_outputs(carry, chain_plain(*head, brow, *events, s40, use_kin=scfg.use_kin))


def _insert_at_bucket_poses(vm, scfg: StaticConfig, params: FilterParams, bidx, p_i_c,
                            body_cov_c, mask_c, own, rots, poss, rot_covs, pos_covs):
    """The insert off the moments kernel (the JAX ``_process_scan_fused``
    :815-835): the compacted points' world positions and variances at the
    chain's post-update bucket poses, then ``insert_points_hinted`` (the
    match phase's probe reused) or, with ``insert_reuse_probe`` off, the
    claiming ``insert_points``."""
    nb = rots.shape[0]
    bidx_c = torch.clamp(bidx, max=nb - 1)
    rb2 = rots[bidx_c]
    p_w_c = torch.einsum("cij,cj->ci", rb2, p_i_c) + poss[bidx_c]
    rot_ext2 = rb2 @ params.ext_r
    rot_cross2 = rb2 @ skew(p_i_c)
    var_c = (
        torch.einsum("cij,cjk,clk->cil", rot_ext2, body_cov_c, rot_ext2)
        + torch.einsum("cij,cjk,clk->cil", rot_cross2, rot_covs[bidx_c], rot_cross2)
        + pos_covs[bidx_c]
    )
    if scfg.insert_reuse_probe:
        return insert_points_hinted(vm, scfg.map_cfg, p_w_c, var_c, mask_c, *own)
    return insert_points(vm, scfg.map_cfg, p_w_c, var_c, mask_c)


def _cloud(packet: ScanPacket, params: FilterParams, rots, poss):
    """The scan's points in the world frame at the post-update bucket poses
    [NB, P, 3] (``return_cloud``)."""
    p_i = packet.points @ params.ext_r.T + params.ext_t
    return torch.einsum("bij,bpj->bpi", rots, p_i) + poss[:, None, :]


def kernel_routes(scfg: StaticConfig) -> Tuple[bool, bool]:
    """Whether the fused path matches on the keys and select kernels and
    inserts on the moments kernel: by the switches alone, at any cap."""
    mcfg = scfg.map_cfg
    return (bool(scfg.use_pallas_match),
            bool(scfg.use_pallas_insert and scfg.insert_reuse_probe and mcfg.insert_row_cap > 0))


def _process_scan_fused(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                        scfg: StaticConfig) -> Tuple[FilterCarry, ScanOutput]:
    """The fused scan step, each phase routed as the JAX package routes it
    (module doc)."""
    nb, p, _ = packet.points.shape
    ocnt0 = carry.vm.ocnt
    cap = _row_cap(scfg, nb, p)
    n_valid = (packet.point_mask & packet.bucket_mask[:, None]).sum().to(torch.int32)
    cap_dropped = torch.clamp(n_valid - cap, min=0)
    mcfg = scfg.map_cfg

    match_kernel, insert_kernel = kernel_routes(scfg)
    match_fn = _match_compact_stats_kernel if match_kernel else _match_compact_stats

    def chain_fn(c, s40, nmatch_b):
        if scfg.use_pallas:
            return run_chain_stats(c, packet, params, s40, nmatch_b, use_kin=scfg.use_kin)
        return _chain_fused_core(c, packet, params, scfg, s40, nmatch_b)

    carry0, poses = carry, None
    for _ in range(max(1, scfg.match_iters)):
        s40, nmatch_b, aux = match_fn(carry0, packet, params, scfg, cap, poses)
        carry, rots, poss, rot_covs, pos_covs, nmatch = chain_fn(carry0, s40, nmatch_b)
        poses = (rots, poss)
    (order, bidx, p_i_c, body_cov_c, mask_c, *own) = aux

    if insert_kernel:
        vm = insert_phase(carry.vm, mcfg, params, bidx, p_i_c, body_cov_c, mask_c, *own,
                          rots, poss, rot_covs, pos_covs)
    else:
        vm = _insert_at_bucket_poses(carry.vm, scfg, params, bidx, p_i_c, body_cov_c, mask_c, own,
                                     rots, poss, rot_covs, pos_covs)
    carry = carry._replace(vm=vm)

    if scfg.map_sliding_en:
        carry = _slide_if_moved(carry, scfg)

    out = ScanOutput(
        rot=carry.state.rot,
        pos=carry.state.pos,
        n_matched=nmatch.sum(),
        n_points=n_valid,
        n_cap_dropped=cap_dropped,
        map_overflow=carry.vm.ocnt - ocnt0,
        cloud_world=_cloud(packet, params, rots, poss) if scfg.return_cloud else None,
    )
    return carry, out


def process_scan_deferred(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                          scfg: StaticConfig) -> Tuple[FilterCarry, ScanOutput]:
    """One scan through the deferred pipeline: rebase the clocks, run the
    fused or the per-point path, re-symmetrise the covariance."""
    nb, p, _ = packet.points.shape
    check_supported(scfg, nb, p)
    carry = carry._replace(
        last_predict_t=carry.last_predict_t - packet.rebase,
        last_update_t=carry.last_update_t - packet.rebase,
    )
    step = _process_scan_fused if scfg.chain_impl == "fused" else _process_scan_points
    carry, out = step(carry, packet, params, scfg)
    return maybe_symmetrize_cov(carry, scfg), out
