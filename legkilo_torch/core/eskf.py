"""Error-state Kalman filter: noise parameters, predict and the three updates (port of legkilo_tpu/core/eskf.py).

The dot-product forms: every product is a ``@`` and the small inverses are
closed forms (adjugate 3x3, Schur 6x6, nested-Schur 18x18).  They are what
the ``chain_impl="jax"`` chain is built from (ops/chain_points.py holds its
plain version on them) and what the sequential rollout will use; the fused
chain of the main path uses the unrolled forms of core/eskf_fused.py.  All
functions are pure ``(state, cov, meas) -> (state, cov)`` and accept leading
batch dims.

The LiDAR point update is the information form: with H = [H6, 0],

    A  = H6^T R^-1 H6,  b = H6^T R^-1 z,  G6 = (I6 + A P66)^-1,
    dx = P[:, :6] G6 b,  P <- P - P[:, :6] G6 A P[:6, :]

which equals K = P H^T (H P H^T + R)^-1 by the push-through identity and
takes masked rows as weight 0.  The reference's 1e-4 jitter on the N == 1
innovation (eskf.cc:100) is folded into R for every row.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .eskf_fused import inv3 as _inv3, inv18
from .so3 import exp_so3, skew
from .state import DIM_STATE, State, boxplus

_R_JITTER = 1e-4  # the reference adds this to the N == 1 innovation (eskf.cc:100)
_IDX_BA, _IDX_IMU_A = 9, 18  # error-state offsets of (ba, bw) and (imu_a, imu_w)


class NoiseParams(NamedTuple):
    """Device-side ESKF noise parameters (from config.EskfConfig)."""

    q_diag: torch.Tensor                  # [30] process noise diagonal
    imu_meas_r: torch.Tensor              # [6]
    kin_meas_noise: torch.Tensor          # []
    lidar_point_meas_ratio: torch.Tensor  # []


def make_noise_params(eskf_cfg, device) -> NoiseParams:
    """Process-noise diagonal (initProcessCovQ, eskf.cc:47-62)."""
    c = eskf_cfg
    q = torch.zeros(DIM_STATE, device=device)
    q[6:9] = c.vel_process_cov
    q[9:12] = c.acc_bias_process_cov
    q[12:15] = c.gyr_bias_process_cov
    q[18:21] = c.imu_acc_process_cov
    q[21:24] = c.imu_gyr_process_cov
    q[24:27] = c.kin_bias_process_cov
    q[27:30] = c.contact_process_cov
    imu_r = torch.tensor(
        [
            c.imu_acc_meas_noise,
            c.imu_acc_meas_noise,
            c.imu_acc_z_meas_noise,
            c.imu_gyr_meas_noise,
            c.imu_gyr_meas_noise,
            c.imu_gyr_meas_noise,
        ],
        device=device,
    )
    return NoiseParams(
        q_diag=q,
        imu_meas_r=imu_r,
        kin_meas_noise=torch.tensor(c.kin_meas_noise, device=device),
        lidar_point_meas_ratio=torch.tensor(c.lidar_point_meas_ratio, device=device),
    )


def imu_innovation(
    state: State, acc: torch.Tensor, gyr: torch.Tensor, gravity_over_acc_norm
) -> torch.Tensor:
    """z = [(g/|a_mean|) acc - imu_a - ba ; gyr - imu_w - bw] (KILO.cc:248-249);
    a fleet's ``gravity_over_acc_norm`` is [B]."""
    g = torch.as_tensor(gravity_over_acc_norm, dtype=acc.dtype, device=acc.device)
    za = g[..., None] * acc - state.imu_a - state.ba
    zg = gyr - state.imu_w - state.bw
    return torch.cat([za, zg], dim=-1)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def inv6(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 6, 6] via the 3x3-block Schur complement."""
    A = m[..., 0:3, 0:3]
    B = m[..., 0:3, 3:6]
    C = m[..., 3:6, 0:3]
    D = m[..., 3:6, 3:6]
    Ai = _inv3(A)
    AiB = Ai @ B
    CAi = C @ Ai
    Si = _inv3(D - C @ AiB)
    TL = Ai + AiB @ Si @ CAi
    TR = -(AiB @ Si)
    BL = -(Si @ CAi)
    return torch.cat([torch.cat([TL, TR], dim=-1), torch.cat([BL, Si], dim=-1)], dim=-2)


def transition_f(state: State, dt: torch.Tensor) -> torch.Tensor:
    """Nominal-state increment f(x) dt (getFunctionf, eskf.cc:64-70)."""
    dt = torch.as_tensor(dt, dtype=state.lin.dtype, device=state.lin.device)[..., None]
    acc_w = (state.rot @ state.imu_a[..., None])[..., 0] + state.grav
    zeros = state.lin.new_zeros(state.lin.shape[:-1] + (DIM_STATE - 9,))
    return torch.cat([dt * state.imu_w, dt * state.vel, dt * acc_w, zeros], dim=-1)


def transition_fx(state: State, dt: torch.Tensor) -> torch.Tensor:
    """Sparse 30x30 error-state transition (getFx, eskf.cc:72-81)."""
    dtype, dev = state.lin.dtype, state.lin.device
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    batch = state.lin.shape[:-1]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    F = torch.eye(DIM_STATE, dtype=dtype, device=dev).expand(batch + (DIM_STATE, DIM_STATE)).clone()
    dt_b = dt[..., None, None]
    F[..., 0:3, 0:3] = exp_so3(-dt[..., None] * state.imu_w)
    F[..., 0:3, 21:24] = dt_b * eye3
    F[..., 3:6, 6:9] = dt_b * eye3
    F[..., 6:9, 0:3] = -dt_b * (state.rot @ skew(state.imu_a))
    F[..., 6:9, 15:18] = dt_b * eye3
    F[..., 6:9, 18:21] = dt_b * state.rot
    return F


def predict_mean(state: State, dt: torch.Tensor) -> State:
    """Mean propagation: x <- x boxplus f(x) dt (predict(.., true, false))."""
    return boxplus(state, transition_f(state, dt))


def predict_cov(state: State, cov: torch.Tensor, q_diag: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """Covariance propagation: P <- F P F^T + dt^2 Q (predict, eskf.cc:83-89)."""
    dt = torch.as_tensor(dt, dtype=cov.dtype, device=cov.device)
    F = transition_fx(state, dt)
    cov = F @ cov @ F.transpose(-1, -2)
    return cov + torch.diag_embed((dt * dt)[..., None] * q_diag)


def predict(state: State, cov: torch.Tensor, q_diag: torch.Tensor, dt_mean, dt_cov
            ) -> Tuple[State, torch.Tensor]:
    """Combined predict in the KILO call pattern (KILO.cc:110-115): the
    covariance propagates over ``dt_cov`` (time since the last update) from
    the pre-propagation state, the mean over ``dt_mean`` (time since the
    last predict)."""
    new_cov = predict_cov(state, cov, q_diag, dt_cov)
    return predict_mean(state, dt_mean), new_cov


def update_by_points(state: State, cov: torch.Tensor, h6: torch.Tensor, z: torch.Tensor,
                     r: torch.Tensor, mask: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """Information-form point update (replaces updateByPoints, eskf.cc:91-123).

    h6 [..., N, 6], z, r, mask [..., N].  Masked rows carry no information;
    with none valid A = 0 and b = 0, so dx = 0 and P is unchanged."""
    dtype = cov.dtype
    w = mask.to(dtype) / (r + _R_JITTER)
    hw = h6 * w[..., None]
    A = torch.einsum("...ni,...nj->...ij", hw, h6)
    b = torch.einsum("...ni,...n->...i", hw, z)

    p66 = cov[..., 0:6, 0:6]
    g6 = inv6(_eye(6, cov) + A @ p66)
    g6_b = (g6 @ b[..., None])[..., 0]
    g6_a = g6 @ A

    p_left = cov[..., :, 0:6]
    dx = (p_left @ g6_b[..., None])[..., 0]
    kh_p = p_left @ g6_a @ cov[..., 0:6, :]
    return boxplus(state, dx), cov - kh_p


def update_by_imu(state: State, cov: torch.Tensor, z6: torch.Tensor, r6: torch.Tensor,
                  gate=None) -> Tuple[State, torch.Tensor]:
    """Structured IMU update (updateByImu, eskf.cc:125-135).

    H is I3 blocks at columns (ba, imu_a) for the acc rows and (bw, imu_w)
    for the gyr rows, so P H^T is a sum of two column blocks.  ``gate``
    scales the gain to 0 for padded event slots."""
    a, b = _IDX_BA, _IDX_IMU_A
    pht = cov[..., :, a : a + 6] + cov[..., :, b : b + 6]
    hp = cov[..., a : a + 6, :] + cov[..., b : b + 6, :]
    hpht = pht[..., a : a + 6, :] + pht[..., b : b + 6, :]
    s = hpht + torch.diag_embed(r6.expand(hpht.shape[:-1]))
    k = pht @ inv6(s)
    if gate is not None:
        k = k * gate[..., None, None]
    dx = (k @ z6[..., None])[..., 0]
    return boxplus(state, dx), cov - k @ hp


def build_kin_obs(state: State, acc, gyr, foot_pos, foot_vel, contact, noise: NoiseParams,
                  gravity_over_acc_norm):
    """The fixed-shape 18-row kinematic + IMU observation
    (predictUpdateKinImu, KILO.cc:260-314): rows 0:6 the IMU observation,
    rows 6+3i:9+3i the stance-velocity observation of foot i,

        z_i = -v - R (w x p_i + v_i)
        H_i = [-R [w x p_i + v_i]x at rot | I3 at vel | -R [p_i]x at imu_w]

    Feet off the ground get masked rows (H = 0, z = 0, R = 1).  Returns
    (h [..., 18, 30], z [..., 18], r [..., 18], mask [..., 18] bool)."""
    dtype, dev = state.lin.dtype, state.lin.device
    batch = state.lin.shape[:-1]
    rot = state.rot
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    h = torch.zeros(batch + (18, DIM_STATE), dtype=dtype, device=dev)
    h[..., 0:3, 9:12] = eye3
    h[..., 0:3, 18:21] = eye3
    h[..., 3:6, 12:15] = eye3
    h[..., 3:6, 21:24] = eye3
    z = torch.zeros(batch + (18,), dtype=dtype, device=dev)
    z[..., 0:6] = imu_innovation(state, acc, gyr, gravity_over_acc_norm)
    r = torch.ones(batch + (18,), dtype=dtype, device=dev)
    r[..., 0:6] = noise.imu_meas_r

    w_skew = skew(state.imu_w)
    wxp_v = torch.einsum("...ij,...fj->...fi", w_skew, foot_pos) + foot_vel
    c = contact.to(dtype)
    h_rot = -torch.einsum("...ij,...fjk->...fik", rot, skew(wxp_v))
    h_w = -torch.einsum("...ij,...fjk->...fik", rot, skew(foot_pos))
    z_foot = -state.vel[..., None, :] - torch.einsum("...ij,...fj->...fi", rot, wxp_v)

    cmask = c[..., :, None, None]
    one = torch.ones((), dtype=dtype, device=dev)
    for f in range(4):
        rows = slice(6 + 3 * f, 9 + 3 * f)
        h[..., rows, 0:3] = h_rot[..., f, :, :] * cmask[..., f, :, :]
        h[..., rows, 6:9] = eye3 * cmask[..., f, :, :]
        h[..., rows, 21:24] = h_w[..., f, :, :] * cmask[..., f, :, :]
        z[..., rows] = z_foot[..., f, :] * c[..., f, None]
        r[..., rows] = torch.where(c[..., f, None] > 0, noise.kin_meas_noise.to(dtype)[..., None], one)
    mask = torch.cat(
        [torch.ones(batch + (6,), dtype=torch.bool, device=dev),
         contact.to(torch.bool).repeat_interleave(3, dim=-1)],
        dim=-1,
    )
    return h, z, r, mask


def update_by_kin_imu(state: State, cov: torch.Tensor, h: torch.Tensor, z: torch.Tensor,
                      r: torch.Tensor, gate=None) -> Tuple[State, torch.Tensor]:
    """Dense fixed-shape update (updateByKinImu, eskf.cc:137-145).  Masked
    rows (H row = 0, z = 0, R = 1) give a zero gain column, so the padded
    18-row shape is exact for 0-4 feet in contact.  The innovation matrix
    H P H^T + diag(R) is SPD; its inverse is the closed-form nested-Schur
    ``eskf_fused.inv18``."""
    pht = cov @ h.transpose(-1, -2)
    s = h @ pht + torch.diag_embed(r)
    k = pht @ inv18(s)
    if gate is not None:
        k = k * gate[..., None, None]
    # K z as products summed along each row: a [30, 18] matrix-vector
    # product rounds differently on the CPU for one replica than for a
    # fleet's batch of them; the row sums round alike at any batch size.
    dx = (k * z[..., None, :]).sum(-1)
    return boxplus(state, dx), cov - k @ (h @ cov)
