"""Filter types and per-run state helpers (subset of legkilo_tpu/core/filter.py).

The types of the JAX module as NamedTuples of tensors, plus the carry
initialisation, the first-frame state and map, the sensor-gap soft reset and
the per-scan covariance re-symmetrisation, and chunked replay
(stack_scan_packets, process_scan_chunk).  The reference-faithful sequential
rollout (process_scan) waits for a later slice; the deferred pipeline (the
fused main path and the per-point ``chain_impl="jax"`` path) is
core/filter_deferred.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .eskf import NoiseParams
from .plane_fit import calc_body_cov
from .so3 import skew
from .state import BV, DIM_STATE, IMU_A, IMU_W, VEL, State, make_state
from .voxel_map import MapConfig, VoxelMap, insert_points, make_map


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
    """Per-run configuration: the JAX module's fields the deferred path
    reads (see there); check_supported refuses the values not ported."""

    map_cfg: MapConfig
    use_kin: bool
    dept_err: float
    beam_err: float
    map_sliding_en: bool = False
    sliding_thresh: float = 8.0
    half_map_size: int = 100
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
    drift f32 asymmetry over long runs."""
    if not scfg.symmetrize_cov:
        return carry
    return carry._replace(cov=0.5 * (carry.cov + carry.cov.T))


def stack_scan_packets(packets) -> ScanPacket:
    """Stack per-scan packets into one [K, ...] chunk (a fixed config gives
    every packet the same padded shapes)."""
    return ScanPacket(*(torch.stack(xs) for xs in zip(*packets)))


def process_scan_chunk(carry: FilterCarry, packets: ScanPacket, params: FilterParams,
                       scfg: StaticConfig):
    """Offline replay: K pre-staged scans of a stacked chunk in one call,
    the same as K ``process_scan_deferred`` calls; outputs come back stacked
    [K, ...].  Nothing here reads a result back to the host, so a caller
    syncs once per chunk."""
    from .filter_deferred import process_scan_deferred

    outs = []
    for k in range(packets.points.shape[0]):
        carry, out = process_scan_deferred(carry, ScanPacket(*(x[k] for x in packets)), params, scfg)
        outs.append(out)
    return carry, ScanOutput(*(torch.stack(xs) for xs in zip(*outs)))
