"""Filter types, per-run state helpers and the sequential pipeline (port of legkilo_tpu/core/filter.py).

The types of the JAX module as NamedTuples of tensors, the carry
initialisation, the first-frame state and map, the sensor-gap soft reset,
the per-scan covariance re-symmetrisation, chunked replay
(stack_scan_packets, process_scan_chunk), the dispatch on the pipeline
(process_scan_any), and the reference-faithful sequential rollout
(process_scan): bucket by bucket, the bucket's IMU or kinematic events,
then predict, match, point update and insert (KILO.cc:108-233, 373-395).

The sequential rollout is plain torch, a Python loop over the buckets (the
JAX module's lax.scan): every bucket matches against and inserts into the
map, so a scan launches on the order of 10^4 small operations on the card.
Its selects on whether a bucket updated are ``torch.where``s: nothing is
read back to the host inside a scan.  The deferred pipeline (the fused
main path and the per-point ``chain_impl="jax"`` path) is
core/filter_deferred.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import eskf
from .eskf import NoiseParams
from .plane_fit import calc_body_cov
from .so3 import skew
from .state import BV, DIM_STATE, IMU_A, IMU_W, VEL, State, make_state
from ..utils.timing import span
from .voxel_map import MapConfig, VoxelMap, insert_points, make_map, match_points, slide_map


class ScanPacket(NamedTuple):
    """One preprocessed scan with its interleaved IMU/kin events; times are
    seconds from the scan begin, ``rebase`` = this begin - previous begin.
    NB buckets, P points per bucket, K event slots per bucket."""

    rebase: torch.Tensor       # [] f32
    end_offset: torch.Tensor   # [] f32
    bucket_time: torch.Tensor  # [NB]
    bucket_mask: torch.Tensor  # [NB] bool
    points: torch.Tensor       # [NB, P, 3]
    point_mask: torch.Tensor   # [NB, P] bool
    imu_time: torch.Tensor     # [NB, K]
    imu_mask: torch.Tensor     # [NB, K] bool
    imu_acc: torch.Tensor      # [NB, K, 3]
    imu_gyr: torch.Tensor      # [NB, K, 3]
    foot_pos: torch.Tensor     # [NB, K, 4, 3]
    foot_vel: torch.Tensor     # [NB, K, 4, 3]
    contact: torch.Tensor      # [NB, K, 4] bool


class FilterParams(NamedTuple):
    noise: NoiseParams
    ext_r: torch.Tensor           # [3, 3] IMU <- LiDAR rotation
    ext_t: torch.Tensor           # [3]
    g_over_acc_norm: torch.Tensor  # [] gravity / |mean acc|


class StaticConfig(NamedTuple):
    """Per-run configuration: the JAX module's fields but ``chain_unroll``
    (see there); filter_deferred.check_supported refuses the values no path
    takes."""

    map_cfg: MapConfig
    use_kin: bool
    dept_err: float
    beam_err: float
    map_sliding_en: bool = False
    sliding_thresh: float = 8.0
    half_map_size: int = 100
    return_cloud: bool = False
    pipeline: str = "sequential"
    use_pallas: bool = False
    insert_cap: int = 0
    match_cap: int = 0
    chain_impl: str = "fused"
    insert_reuse_probe: bool = True
    use_pallas_match: bool = False
    use_pallas_insert: bool = False
    use_pallas_pose: bool = False
    symmetrize_cov: bool = True
    match_pose: str = "imu"
    match_iters: int = 1


class FilterCarry(NamedTuple):
    """State carried across scans.  Its 12 tensors, in order (state.rot,
    state.lin, cov, last_predict_t, last_update_t, vm.ptab, vm.meta, vm.mom,
    vm.moms, vm.plane, vm.ocnt, last_slide_pos), are the leaves of the JAX
    FilterCarry in jax.tree.flatten order (convert.py)."""

    state: State
    cov: torch.Tensor             # [30, 30]
    last_predict_t: torch.Tensor  # []
    last_update_t: torch.Tensor   # []
    vm: VoxelMap
    last_slide_pos: torch.Tensor  # [3]


class ScanOutput(NamedTuple):
    rot: torch.Tensor
    pos: torch.Tensor
    n_matched: torch.Tensor      # [] matched points this scan
    n_points: torch.Tensor       # [] valid points this scan
    n_cap_dropped: torch.Tensor  # [] valid points beyond the match/insert cap
    map_overflow: torch.Tensor   # [3] this scan's increments of vm.ocnt
    cloud_world: Optional[torch.Tensor] = None  # [NB, P, 3] with return_cloud


def init_carry(scfg: StaticConfig, device) -> FilterCarry:
    return FilterCarry(
        state=make_state(device),
        cov=torch.eye(DIM_STATE, device=device) * 1e-6,
        last_predict_t=torch.zeros((), device=device),
        last_update_t=torch.zeros((), device=device),
        vm=make_map(scfg.map_cfg, device),
        last_slide_pos=torch.zeros(3, device=device),
    )


def init_state_from_imu(carry: FilterCarry, mean_acc, mean_gyr, gravity: float, end_offset):
    """First-frame state (StateInitial, state_initial.hpp:30-118): gravity
    from the mean specific force, bw = mean gyro, imu_a latched to the
    rest-consistent -grav.  Returns (carry, |mean_acc|)."""
    cov = carry.cov
    acc_norm = torch.linalg.norm(mean_acc)
    st = make_state(cov.device)
    grav = -mean_acc / acc_norm * gravity
    lin = st.lin.clone()
    lin[12:15] = grav
    lin[9:12] = mean_gyr
    lin[15:18] = -grav
    end = end_offset.to(cov.dtype)
    return (
        carry._replace(
            state=State(rot=st.rot, lin=lin),
            cov=torch.eye(DIM_STATE, dtype=cov.dtype, device=cov.device) * 1e-6,
            last_predict_t=end,
            last_update_t=end.clone(),
        ),
        acc_norm,
    )


def first_frame_map(carry: FilterCarry, scfg: StaticConfig, params: FilterParams,
                    points_body, mask) -> FilterCarry:
    """Initial map from the first raw scan (BuildVoxelMap, voxel_map.cc:
    287-334), with its variance (R E) C (R E)^T + [p_b]x RotCov [p_b]x^T +
    PosCov, the cross term on the body point as in the reference."""
    st, cov = carry.state, carry.cov
    p_i = points_body @ params.ext_r.T + params.ext_t
    p_w = p_i @ st.rot.T + st.pos
    body_cov = calc_body_cov(points_body, scfg.dept_err, scfg.beam_err)
    rot_ext = st.rot @ params.ext_r
    crossmat = skew(points_body)
    var = (
        torch.einsum("ij,njk,lk->nil", rot_ext, body_cov, rot_ext)
        + torch.einsum("nij,jk,nlk->nil", -crossmat, cov[0:3, 0:3], -crossmat)
        + cov[3:6, 3:6]
    )
    return carry._replace(vm=insert_points(carry.vm, scfg.map_cfg, p_w, var, mask))


def soft_reset_carry(carry: FilterCarry, rebase: float, cov_diag: float = 1e-4) -> FilterCarry:
    """Recover from a large sensor-time gap: keep pose, gravity and biases;
    zero velocity and latched rates (imu_a to the rest value -R^T grav);
    realign the clocks so the next packet's rebase lands them at its begin;
    inflate the covariance so matching re-anchors."""
    st, dev, dtype = carry.state, carry.cov.device, carry.cov.dtype
    lin = st.lin.clone()
    lin[VEL] = 0.0
    lin[IMU_W] = 0.0
    lin[BV] = 0.0
    lin[IMU_A] = -st.rot.T @ st.grav
    t = torch.tensor(rebase, dtype=dtype, device=dev)
    return carry._replace(
        state=State(rot=st.rot, lin=lin),
        cov=torch.eye(DIM_STATE, dtype=dtype, device=dev) * cov_diag,
        last_predict_t=t,
        last_update_t=t.clone(),
    )


def maybe_symmetrize_cov(carry: FilterCarry, scfg: StaticConfig) -> FilterCarry:
    """P <- (P + P^T)/2 once per scan: the ~50 Joseph-free downdates a scan
    drift f32 asymmetry over long runs.  (A fleet's [B, 30, 30] too.)"""
    if not scfg.symmetrize_cov:
        return carry
    return carry._replace(cov=0.5 * (carry.cov + carry.cov.transpose(-1, -2)))


def _where(cond, a, b):
    """torch.where with ``cond`` of a carry's leading dims ([] or a fleet's
    [B]) against tensors with more trailing dims."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)


def _slide_if_moved(carry: FilterCarry, scfg: StaticConfig) -> FilterCarry:
    """The map slide once the pose has moved ``sliding_thresh`` from the
    last slide.  Both maps are formed and one is selected on the card: no
    host read.  A fleet's carry slides each replica on its own trigger."""
    with span("lk.slide"):
        moved = torch.linalg.norm(carry.state.pos - carry.last_slide_pos, dim=-1)
        trigger = moved >= scfg.sliding_thresh
        vm_slid = slide_map(carry.vm, scfg.map_cfg, carry.state.pos, scfg.half_map_size)
        return carry._replace(
            vm=VoxelMap(*(_where(trigger, a, b) for a, b in zip(vm_slid, carry.vm))),
            last_slide_pos=_where(trigger, carry.state.pos, carry.last_slide_pos),
        )


def _point_vars(st: State, cov, params: FilterParams, scfg: StaticConfig, p_b):
    """World positions and propagated per-point covariance (KILO.cc:122-140):
    (p_i, p_w, body_cov, crossmat, var); a fleet's p_b [B, N, 3] against
    its replicas' states and params."""
    p_i = p_b @ params.ext_r.transpose(-1, -2) + params.ext_t[..., None, :]
    p_w = p_i @ st.rot.transpose(-1, -2) + st.pos[..., None, :]
    body_cov = calc_body_cov(p_b, scfg.dept_err, scfg.beam_err)
    crossmat = skew(p_i)
    rot_ext = st.rot @ params.ext_r
    rot_cross = st.rot[..., None, :, :] @ crossmat
    var = (
        torch.einsum("...ij,...njk,...lk->...nil", rot_ext, body_cov, rot_ext)
        + torch.einsum("...nij,...jk,...nlk->...nil", rot_cross, cov[..., 0:3, 0:3], rot_cross)
        + cov[..., None, 3:6, 3:6]
    )
    return p_i, p_w, body_cov, crossmat, var


def _imu_kin_event(carry: FilterCarry, params: FilterParams, scfg: StaticConfig,
                   t, gate, acc, gyr, foot_pos, foot_vel, contact) -> FilterCarry:
    """One (possibly masked) IMU or kinematic event (predictUpdateImu /
    predictUpdateKinImu, KILO.cc:235-314); a fleet's with a leading B on
    the carry, the params and the event."""
    st, cov = carry.state, carry.cov
    gatef = gate.to(cov.dtype)
    dt_cov = (t - carry.last_update_t) * gatef
    dt = (t - carry.last_predict_t) * gatef
    st, cov = eskf.predict(st, cov, params.noise.q_diag, dt, dt_cov)
    if scfg.use_kin:
        h, z, r, _ = eskf.build_kin_obs(st, acc, gyr, foot_pos, foot_vel, contact, params.noise,
                                        params.g_over_acc_norm)
        st, cov = eskf.update_by_kin_imu(st, cov, h, z, r, gate=gatef)
    else:
        z6 = eskf.imu_innovation(st, acc, gyr, params.g_over_acc_norm)
        st, cov = eskf.update_by_imu(st, cov, z6, params.noise.imu_meas_r, gate=gatef)
    return carry._replace(
        state=st, cov=cov,
        last_predict_t=torch.where(gate, t, carry.last_predict_t),
        last_update_t=torch.where(gate, t, carry.last_update_t),
    )


def _point_bucket(carry: FilterCarry, params: FilterParams, scfg: StaticConfig, t, gate, p_b, pmask):
    """One (possibly masked) LiDAR time bucket (predictUpdatePoint,
    KILO.cc:108-233): predict, match at the predicted state, point update,
    world points and variances again at the updated state, insert.
    Returns (carry, n_matched, n_processed, p_w_final [P,3]); a fleet's
    (a leading B on the carry, params, bucket and points) updates each
    replica on its own matches and inserts into its own map."""
    cfg = scfg.map_cfg
    gatef = gate.to(carry.cov.dtype)
    dt_cov = (t - carry.last_update_t) * gatef
    dt = (t - carry.last_predict_t) * gatef
    st, cov = eskf.predict(carry.state, carry.cov, params.noise.q_diag, dt, dt_cov)
    last_predict_t = torch.where(gate, t, carry.last_predict_t)

    pmask = pmask & gate[..., None]
    p_i, p_w, body_cov, crossmat, var = _point_vars(st, cov, params, scfg, p_b)
    m = match_points(carry.vm, cfg, p_w, var, pmask)

    # Observation rows (KILO.cc:190-210).
    rt_n = m.normal @ st.rot                               # R^T n, row-vector form
    cr_u = torch.einsum("...nij,...nj->...ni", crossmat, rt_n)
    h6 = torch.cat([cr_u, m.normal], dim=-1)
    z = -m.signed_dist
    j_nq = torch.cat([p_w - m.center, -m.normal], dim=-1)
    single_l = torch.clamp(torch.einsum("...ni,...nij,...nj->...n", j_nq, m.plane_var, j_nq), min=0.0)
    rot_ext = st.rot @ params.ext_r
    var_bw = torch.einsum("...ij,...njk,...lk->...nil", rot_ext, body_cov, rot_ext)
    r = params.noise.lidar_point_meas_ratio[..., None] * (
        single_l + torch.einsum("...ni,...nij,...nj->...n", m.normal, var_bw, m.normal)
    )

    st2, cov2 = eskf.update_by_points(st, cov, h6, z, r, m.matched)
    did_update = torch.any(m.matched, dim=-1)             # a replica's own matches
    st = State(*(_where(did_update, a, b) for a, b in zip(st2, st)))
    cov = _where(did_update, cov2, cov)
    last_update_t = torch.where(gate & did_update, t, carry.last_update_t)

    # World points and variances at the updated state before the insert
    # (KILO.cc:216-231; only when an update happened).
    _, p_w2, _, _, var2 = _point_vars(st, cov, params, scfg, p_b)
    p_w_final = _where(did_update, p_w2, p_w)
    var_final = _where(did_update, var2, var)
    vm = insert_points(carry.vm, cfg, p_w_final, var_final, pmask)

    carry = carry._replace(state=st, cov=cov, last_predict_t=last_predict_t,
                           last_update_t=last_update_t, vm=vm)
    return (carry, m.matched.sum(-1).to(torch.int32), pmask.sum(-1).to(torch.int32), p_w_final)


def process_scan(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                 scfg: StaticConfig) -> Tuple[FilterCarry, ScanOutput]:
    """One scan through the sequential pipeline: rebase the clocks, then per
    bucket its K event slots and the bucket itself, the map slide, the
    covariance re-symmetrisation.  A fleet (a leading B on the carry,
    packet and params; core/filter_fleet.py) steps every replica in the
    same pass: bucket b of every replica, then bucket b + 1."""
    nb, kmax = packet.imu_time.shape[-2:]
    ocnt0 = carry.vm.ocnt
    carry = carry._replace(
        last_predict_t=carry.last_predict_t - packet.rebase,
        last_update_t=carry.last_update_t - packet.rebase,
    )
    n_matched, n_proc, clouds = [], [], []
    for b in range(nb):
        for k in range(kmax):
            carry = _imu_kin_event(
                carry, params, scfg, packet.imu_time[..., b, k], packet.imu_mask[..., b, k],
                packet.imu_acc[..., b, k, :], packet.imu_gyr[..., b, k, :],
                packet.foot_pos[..., b, k, :, :], packet.foot_vel[..., b, k, :, :],
                packet.contact[..., b, k, :],
            )
        carry, nm, npr, p_w = _point_bucket(carry, params, scfg, packet.bucket_time[..., b],
                                            packet.bucket_mask[..., b], packet.points[..., b, :, :],
                                            packet.point_mask[..., b, :])
        n_matched.append(nm)
        n_proc.append(npr)
        clouds.append(p_w)

    if scfg.map_sliding_en:
        carry = _slide_if_moved(carry, scfg)
    carry = maybe_symmetrize_cov(carry, scfg)
    n_valid = (packet.point_mask & packet.bucket_mask[..., None]).sum((-2, -1)).to(torch.int32)
    out = ScanOutput(
        rot=carry.state.rot,
        pos=carry.state.pos,
        n_matched=torch.stack(n_matched).sum(0),
        n_points=packet.point_mask.sum((-2, -1)).to(torch.int32),
        n_cap_dropped=n_valid - torch.stack(n_proc).sum(0),
        map_overflow=carry.vm.ocnt - ocnt0,
        cloud_world=torch.stack(clouds, dim=-3) if scfg.return_cloud else None,
    )
    return carry, out


def process_scan_any(carry: FilterCarry, packet: ScanPacket, params: FilterParams,
                     scfg: StaticConfig) -> Tuple[FilterCarry, ScanOutput]:
    """The one entry point a caller steps a scan with: the deferred
    pipeline for ``pipeline == "deferred"``, the sequential one otherwise
    (as the JAX module dispatches)."""
    from .filter_deferred import check_supported, process_scan_deferred

    if scfg.pipeline == "deferred":
        return process_scan_deferred(carry, packet, params, scfg)
    check_supported(scfg, *packet.points.shape[-3:-1])
    return process_scan(carry, packet, params, scfg)


def stack_scan_packets(packets) -> ScanPacket:
    """Stack per-scan packets into one [K, ...] chunk (a fixed config gives
    every packet the same padded shapes)."""
    return ScanPacket(*(torch.stack(xs) for xs in zip(*packets)))


def process_scan_chunk(carry: FilterCarry, packets: ScanPacket, params: FilterParams,
                       scfg: StaticConfig):
    """Offline replay: K pre-staged scans of a stacked chunk in one call,
    the same as K ``process_scan_any`` calls; outputs come back stacked
    [K, ...].  Nothing here reads a result back to the host, so a caller
    syncs once per chunk."""
    outs = []
    for k in range(packets.points.shape[0]):
        carry, out = process_scan_any(carry, ScanPacket(*(x[k] for x in packets)), params, scfg)
        outs.append(out)
    return carry, ScanOutput(*(None if xs[0] is None else torch.stack(xs) for xs in zip(*outs)))
