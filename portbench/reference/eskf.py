"""The 30-dimensional error-state Kalman filter of Leg-KILO (eskf.cc,
KILO.cc), written out plainly: explicit Jacobians and a dense gain.

Nominal state: the rotation R and ``x`` [27] = position, velocity,
accelerometer bias, gyroscope bias, gravity, the latched specific force
and angular rate, the kinematic bias and the contact block.  The error
state [30] puts the rotation first (so error index 3 + i is ``x[i]``),
and R is retracted on the right: R <- R Exp(dx[0:3]).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .arith import Arith, exp_so3, skew

POS, VEL, BA, BW, GRAV, ACC, RATE = (slice(3 * i, 3 * i + 3) for i in range(7))
R_JITTER = 1e-4  # the upstream adds it to each point's measurement variance


class Noise(NamedTuple):
    q: np.ndarray          # [30] process noise, per second^2 of the covariance's dt
    imu_r: np.ndarray      # [6]
    kin_r: float
    ratio: float           # lidar_point_meas_ratio
    g_an: float            # gravity over the first packet's mean |acc|


class Filter(NamedTuple):
    R: np.ndarray
    x: np.ndarray
    P: np.ndarray
    lp: float              # time of the last predict
    lu: float              # time of the last update


def retract(ar: Arith, R, x, dx):
    return ar.mm(R, exp_so3(ar, dx[0:3])), (x + dx[3:]).astype(ar.dt)


def predict(ar: Arith, f: Filter, q, t: float) -> Filter:
    """Propagate to time t: the covariance over t - lu (time since the last
    update) from the state before the step, the mean over t - lp."""
    R, x, P = f.R, f.x, f.P
    dc, dm = t - f.lu, t - f.lp
    F = ar.f(np.eye(30))
    F[0:3, 0:3] = exp_so3(ar, -dc * x[RATE])
    F[0:3, 21:24] = dc * np.eye(3)
    F[3:6, 6:9] = dc * np.eye(3)
    F[6:9, 0:3] = -dc * ar.mm(R, skew(x[ACC]))
    F[6:9, 15:18] = dc * np.eye(3)
    F[6:9, 18:21] = dc * R
    P = ar.mm(ar.mm(F, P), F.T) + np.diag(dc * dc * q).astype(ar.dt)
    x2 = x.copy()
    x2[POS] = x[POS] + dm * x[VEL]
    x2[VEL] = x[VEL] + dm * (ar.mm(R, x[ACC]) + x[GRAV])
    R2 = ar.mm(R, exp_so3(ar, dm * x[RATE]))
    return Filter(R2, x2.astype(ar.dt), P.astype(ar.dt), t, f.lu)


def _kalman(ar: Arith, f: Filter, H, z, r) -> Filter:
    """x <- x [+] K z, P <- P - K H P with K = P H^T (H P H^T + diag r)^-1."""
    PHt = ar.mm(f.P, H.T)
    S = ar.mm(H, PHt) + np.diag(r).astype(ar.dt)
    K = np.linalg.solve(S.T, PHt.T).T.astype(ar.dt)
    R, x = retract(ar, f.R, f.x, ar.mm(K, z))
    return Filter(R, x, (f.P - ar.mm(K, ar.mm(H, f.P))).astype(ar.dt), f.lp, f.lu)


def imu_obs(f: Filter, acc, gyr, g_an: float):
    """The IMU observation: the scaled specific force against the latched
    force plus the bias, the rate against the latched rate plus the bias."""
    H = np.zeros((6, 30))
    H[0:3, 9:12] = H[0:3, 18:21] = np.eye(3)
    H[3:6, 12:15] = H[3:6, 21:24] = np.eye(3)
    z = np.concatenate([g_an * np.asarray(acc) - f.x[ACC] - f.x[BA],
                        np.asarray(gyr) - f.x[RATE] - f.x[BW]])
    return H, z


def imu_update(ar: Arith, f: Filter, noise: Noise, acc, gyr) -> Filter:
    H, z = imu_obs(f, acc, gyr, noise.g_an)
    return _kalman(ar, f, ar.f(H), ar.f(z), ar.f(noise.imu_r))


def kin_update(ar: Arith, f: Filter, noise: Noise, acc, gyr, foot_pos, foot_vel, contact
               ) -> Filter:
    """The IMU observation and, for each foot in contact, its stance
    velocity: 0 = v + R (w x p_f + v_f), w the latched rate."""
    H6, z6 = imu_obs(f, acc, gyr, noise.g_an)
    Hs, zs, rs = [H6], [z6], [np.asarray(noise.imu_r, dtype=np.float64)]
    R, w = f.R, f.x[RATE]
    for p, v, c in zip(np.asarray(foot_pos), np.asarray(foot_vel), np.asarray(contact)):
        if not c:
            continue
        u = np.cross(w, p) + v
        H = np.zeros((3, 30))
        H[:, 0:3] = -ar.mm(R, skew(u))
        H[:, 6:9] = np.eye(3)
        H[:, 21:24] = -ar.mm(R, skew(p))
        Hs.append(H)
        zs.append(-f.x[VEL] - ar.mm(R, u))
        rs.append(np.full(3, noise.kin_r))
    return _kalman(ar, f, ar.f(np.concatenate(Hs)), ar.f(np.concatenate(zs)),
                   ar.f(np.concatenate(rs)))


def point_update(ar: Arith, f: Filter, p_i, normal, centre, w) -> Filter:
    """The point-to-plane update of one bucket's matched points (LiDAR
    points p_i in the IMU frame, each with its plane's normal and centre
    and weight 1 / variance), linearised at the filter's state: residual
    n.c - n.(R p_i + t), Jacobian [p_i x R^T n, n] on (rotation, position).
    The information form, exact for any number of points."""
    if len(w) == 0:
        return f
    R, P = f.R, f.P
    rtn = ar.mm(normal, R)                                   # R^T n, row by row
    h = np.concatenate([np.cross(p_i, rtn), normal], axis=1).astype(ar.dt)
    z = (np.sum(normal * centre, 1) - np.sum(normal * (ar.mm(p_i, R.T) + f.x[POS]), 1)).astype(ar.dt)
    A = ar.ein("ni,n,nj->ij", h, w, h)
    b = ar.ein("ni,n,n->i", h, w, z)
    G = np.linalg.inv(np.eye(6) + ar.mm(A, P[0:6, 0:6])).astype(ar.dt)
    Pl = P[:, 0:6]
    dx = ar.mm(Pl, ar.mm(G, b))
    Rn, xn = retract(ar, R, f.x, dx)
    Pn = P - ar.mm(ar.mm(Pl, ar.mm(G, A)), P[0:6, :])
    return Filter(Rn, xn, Pn.astype(ar.dt), f.lp, f.lu)
