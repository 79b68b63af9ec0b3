"""ESKF chain math with every small product unrolled (port of legkilo_tpu/core/eskf_fused.py).

The plain PyTorch form of the chain kernel's arithmetic
(ops/chain_stats.py), and the fused path's chain off that kernel
(filter_deferred._chain_fused_core): predict with the sparse transition applied as block
row/column updates (eskf.cc:64-89), the structured IMU update
(eskf.cc:125-135), the 18-row kinematic update with the nested-Schur 18x18
inverse (KILO.cc:260-314), and the LiDAR point update from per-bucket
40x40 sufficient statistics

    S_b = sum_n w X X^T,   [A b; b^T *] = Phi(R, t)^T S_b Phi(R, t)

with X = [vec(n (x) [p]x) (27), n (3), vec(n (x) p) (9), n.c (1)] and
w = matched / (r + 1e-4) (see the JAX module for the derivation).  The
JAX module unrolls its small products into sums of broadcasts; here
``umm``/``umv`` are one matmul each, on every device (on the card each
step of an unrolled sum would be a launch), so f32 results agree with
the JAX module's to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .ordered_sum import index_add_rows
from .state import DIM_STATE, State

_R_JITTER = 1e-4  # the reference adds this to the innovation (eskf.cc:100)
N_FEAT = 40


def umm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (the JAX module's unrolled product, as one matmul: fp32,
    TF32 off)."""
    return a @ b


def umv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a @ v (umm)."""
    return (a @ v[..., None])[..., 0]


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def exp3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential with the K@K square unrolled."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-6
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 * (1.0 / 6.0), torch.sin(safe_t) / safe_t)
    b = torch.where(
        small, 0.5 - theta2 * (1.0 / 24.0), (1.0 - torch.cos(safe_t)) / (safe_t * safe_t)
    )
    K = skew(w)
    return _eye(3, w) + a[..., None, None] * K + b[..., None, None] * umm(K, K)


def boxplus(state: State, dx: torch.Tensor) -> State:
    return State(rot=umm(state.rot, exp3(dx[..., 0:3])), lin=state.lin + dx[..., 3:DIM_STATE])


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of [..., 3, 3]."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / det
    rows = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return rows * inv_det[..., None, None]


def _inv_schur(m: torch.Tensor, k: int, inv_a, inv_s) -> torch.Tensor:
    """Block inverse via the Schur complement of the leading k x k block."""
    A = m[..., 0:k, 0:k]
    B = m[..., 0:k, k:]
    C = m[..., k:, 0:k]
    D = m[..., k:, k:]
    Ai = inv_a(A)
    AiB = umm(Ai, B)
    CAi = umm(C, Ai)
    Si = inv_s(D - umm(C, AiB))
    TL = Ai + umm(umm(AiB, Si), CAi)
    TR = -umm(AiB, Si)
    BL = -umm(Si, CAi)
    return torch.cat([torch.cat([TL, TR], dim=-1), torch.cat([BL, Si], dim=-1)], dim=-2)


def inv6(m: torch.Tensor) -> torch.Tensor:
    return _inv_schur(m, 3, inv3, inv3)


def inv9(m: torch.Tensor) -> torch.Tensor:
    return _inv_schur(m, 3, inv3, inv6)


def inv18(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 18x18 inverse (nested Schur; the system is SPD)."""
    return _inv_schur(m, 9, inv9, inv9)


def predict(
    state: State, cov: torch.Tensor, q_diag: torch.Tensor, dt_mean, dt_cov
) -> Tuple[State, torch.Tensor]:
    """Dual-clock predict (eskf.cc:64-89, KILO.cc:110-115).

    F = I except F[0:3,0:3] = Exp(-dt w), F[0:3,21:24] = dt I,
    F[3:6,6:9] = dt I, F[6:9,0:3] = -dt R [a]x, F[6:9,15:18] = dt I,
    F[6:9,18:21] = dt R; F P F^T touches only row/column blocks 0:9."""
    dtb = dt_cov[..., None, None]
    rot, w, a = state.rot, state.imu_w, state.imu_a
    E = exp3(-dt_cov[..., None] * w)
    A3 = -dtb * umm(rot, skew(a))
    Et, A3t, Rt = _t(E), _t(A3), _t(rot)

    def cols(P):
        c0 = umm(P[..., :, 0:3], Et) + dtb * P[..., :, 21:24]
        c3 = P[..., :, 3:6] + dtb * P[..., :, 6:9]
        c6 = (
            P[..., :, 6:9]
            + umm(P[..., :, 0:3], A3t)
            + dtb * P[..., :, 15:18]
            + dtb * umm(P[..., :, 18:21], Rt)
        )
        return torch.cat([c0, c3, c6, P[..., :, 9:]], dim=-1)

    def rows(Y):
        r0 = umm(E, Y[..., 0:3, :]) + dtb * Y[..., 21:24, :]
        r3 = Y[..., 3:6, :] + dtb * Y[..., 6:9, :]
        r6 = (
            Y[..., 6:9, :]
            + umm(A3, Y[..., 0:3, :])
            + dtb * Y[..., 15:18, :]
            + dtb * umm(rot, Y[..., 18:21, :])
        )
        return torch.cat([r0, r3, r6, Y[..., 9:, :]], dim=-2)

    q_mat = _eye(DIM_STATE, cov) * q_diag[..., None, :]
    new_cov = rows(cols(cov)) + (dt_cov * dt_cov)[..., None, None] * q_mat

    dt_m = dt_mean[..., None]
    acc_w = umv(rot, a) + state.grav
    dx = torch.cat(
        [dt_m * w, dt_m * state.vel, dt_m * acc_w, cov.new_zeros(state.lin.shape[:-1] + (21,))],
        dim=-1,
    )
    return boxplus(state, dx), new_cov


def update_by_imu(state, cov, z6, r6, gate=None) -> Tuple[State, torch.Tensor]:
    """Structured IMU update (eskf.cc:125-135)."""
    pht = cov[..., :, 9:15] + cov[..., :, 18:24]
    hp = cov[..., 9:15, :] + cov[..., 18:24, :]
    hpht = pht[..., 9:15, :] + pht[..., 18:24, :]
    s = hpht + _eye(6, cov) * r6[..., None, :]
    k = umm(pht, inv6(s))
    if gate is not None:
        k = k * gate[..., None, None]
    dx = umv(k, z6)
    return boxplus(state, dx), cov - umm(k, hp)


def _active_cols(m):
    return torch.cat([m[..., :, 0:3], m[..., :, 6:15], m[..., :, 18:24]], dim=-1)


def _active_rows(m):
    return torch.cat([m[..., 0:3, :], m[..., 6:15, :], m[..., 18:24, :]], dim=-2)


def update_by_kin_imu(state, cov, h, z, r, gate=None) -> Tuple[State, torch.Tensor]:
    """18-row kinematic + IMU update (KILO.cc:260-314, eskf.cc:137-145).

    H is nonzero only on the columns rot(0:3), vel(6:9), ba(9:12),
    bw(12:15), imu_a(18:21), imu_w(21:24), so P H^T contracts over those
    18 columns only."""
    hb = _active_cols(h)
    pht = umm(_active_cols(cov), _t(hb))
    s = umm(hb, _active_rows(pht)) + _eye(18, cov) * r[..., None, :]
    k = umm(pht, inv18(s))
    if gate is not None:
        k = k * gate[..., None, None]
    dx = (k * z[..., None, :]).sum(-1)  # as core/eskf.update_by_kin_imu: any batch size rounds alike
    return boxplus(state, dx), cov - umm(k, umm(hb, _active_rows(cov)))


def build_kin_obs(state, acc, gyr, foot_pos, foot_vel, contact, noise, gravity_over_acc_norm):
    """18-row observation: rows 0:6 IMU, rows 6+3f:9+3f the stance-velocity
    observation of foot f (KILO.cc:292-309); non-contact feet get H = 0,
    z = 0, R = 1."""
    batch = state.lin.shape[:-1]
    rot = state.rot
    eye3 = _eye(3, rot)
    z3 = torch.zeros_like(eye3)
    rows_acc = torch.cat([z3, z3, z3, eye3, z3, z3, eye3, z3, z3, z3], dim=-1)
    rows_gyr = torch.cat([z3, z3, z3, z3, eye3, z3, z3, eye3, z3, z3], dim=-1)
    h_imu = torch.cat([rows_acc, rows_gyr], dim=-2).expand(batch + (6, DIM_STATE))

    w_skew = skew(state.imu_w)
    wxp_v = umv(w_skew[..., None, :, :], foot_pos) + foot_vel
    c = contact.to(rot.dtype)
    h_rot = -umm(rot[..., None, :, :], skew(wxp_v))
    h_w = -umm(rot[..., None, :, :], skew(foot_pos))
    z_foot = -state.vel[..., None, :] - umv(rot[..., None, :, :], wxp_v)

    cm = c[..., :, None, None]
    zpad = rot.new_zeros(batch + (4, 3, 3))
    eye_f = eye3.expand(batch + (4, 3, 3)) * cm
    h_feet = torch.cat(
        [h_rot * cm, zpad, eye_f, zpad, zpad, zpad, zpad, h_w * cm, zpad, zpad], dim=-1
    )
    h = torch.cat([h_imu, h_feet.reshape(batch + (12, DIM_STATE))], dim=-2)

    za = gravity_over_acc_norm[..., None] * acc - state.imu_a - state.ba
    zg = gyr - state.imu_w - state.bw
    z = torch.cat([za, zg, (z_foot * c[..., :, None]).reshape(batch + (12,))], dim=-1)

    r_imu = noise.imu_meas_r.expand(batch + (6,))
    r_feet = torch.where(
        c[..., :, None] > 0,
        noise.kin_meas_noise[..., None, None].expand(batch + (4, 3)),
        rot.new_ones(batch + (4, 3)),
    ).reshape(batch + (12,))
    r = torch.cat([r_imu, r_feet], dim=-1)
    mask = torch.cat(
        [torch.ones(batch + (6,), dtype=torch.bool, device=rot.device),
         contact.repeat_interleave(3, dim=-1)],
        dim=-1,
    )
    return h, z, r, mask


def point_features(p_i: torch.Tensor, normal: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Per-point 40-feature vector X: block 0:27 is n_c [p]x_{i,b} at
    9i + (3c+b), block 30:39 is n_c p_a at 3c+a."""
    sp = skew(p_i)
    mt = (normal[..., None, :, None] * sp[..., :, None, :]).reshape(p_i.shape[:-1] + (27,))
    v = (normal[..., :, None] * p_i[..., None, :]).reshape(p_i.shape[:-1] + (9,))
    d = torch.sum(normal * center, dim=-1, keepdim=True)
    return torch.cat([mt, normal, v, d], dim=-1)


def point_suffstats(p_i, normal, center, r, matched) -> torch.Tensor:
    """Per-bucket S = sum_n w X X^T in the dense [..., NB, P] layout (the
    JAX module's one batched contraction): points [..., NB, P, 3], normals
    and centres likewise, variances and validity [..., NB, P] ->
    [..., NB, 40, 40]."""
    w = matched.to(p_i.dtype) / (r + _R_JITTER)
    x = point_features(p_i, normal, center)
    return torch.einsum("...pi,...pj->...ij", x * w[..., None], x)


def point_suffstats_compact(p_i, normal, center, r, matched, bidx, nb: int) -> torch.Tensor:
    """Per-bucket S = sum w X X^T over compacted rows, summed in row order
    on every device (core/ordered_sum.py); rows whose bucket index is out
    of range (padding, bidx == nb) are dropped."""
    w = matched.to(p_i.dtype) / (r + _R_JITTER)
    x = point_features(p_i, normal, center)
    outer = (x * w[:, None])[:, :, None] * x[:, None, :]
    keep = (bidx >= 0) & (bidx < nb)
    tgt = torch.where(keep, bidx, torch.full_like(bidx, nb)).long()
    s40 = outer.new_zeros((nb + 1, N_FEAT, N_FEAT))
    index_add_rows((s40,), tgt, (outer,), drop=nb)
    return s40[:nb]


def point_update_from_stats(state: State, cov: torch.Tensor, s40: torch.Tensor):
    """Information-form point update from S (eskf.update_by_points semantics).

    Phi(R, t) [40, 7]: rows 0:27 -> col i gets Rf[q]; rows 27:30 -> cols
    3:6 = I3, col 6 = -t; rows 30:39 -> col 6 = -Rf; row 39 -> col 6 = 1.
    An empty bucket (S = 0) is an exact no-op."""
    batch = cov.shape[:-2]
    rf = state.rot.reshape(batch + (9,))
    eye3 = _eye(3, cov)
    top = torch.cat(
        [(eye3[:, None, :] * rf[..., None, :, None]).reshape(batch + (27, 3)),
         cov.new_zeros(batch + (27, 4))],
        dim=-1,
    )
    mid = torch.cat(
        [cov.new_zeros(batch + (3, 3)), eye3.expand(batch + (3, 3)), -state.pos[..., :, None]],
        dim=-1,
    )
    vrow = torch.cat([cov.new_zeros(batch + (9, 6)), -rf[..., :, None]], dim=-1)
    last = torch.cat([cov.new_zeros(batch + (1, 6)), cov.new_ones(batch + (1, 1))], dim=-1)
    phi = torch.cat([top, mid, vrow, last], dim=-2)

    nq = umm(_t(phi), umm(s40, phi))
    a66 = nq[..., 0:6, 0:6]
    b6 = nq[..., 0:6, 6]
    p66 = cov[..., 0:6, 0:6]
    g6 = inv6(_eye(6, cov) + umm(a66, p66))
    g6_b = umv(g6, b6)
    g6_a = umm(g6, a66)
    p_left = cov[..., :, 0:6]
    dx = umv(p_left, g6_b)
    kh_p = umm(umm(p_left, g6_a), cov[..., 0:6, :])
    return boxplus(state, dx), cov - kh_p
