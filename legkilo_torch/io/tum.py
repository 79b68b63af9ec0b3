"""TUM-format trajectory writer + ATE/RPE evaluation helpers.

The port's own copy of ``legkilo_tpu/io/tum.py``.  Parity: TrajectorySaver
(legkilo/src/common/trajectory_saver.hpp:43-50)
writes ``time x y z qx qy qz qw`` lines for offline evaluation with evo-style
tools; reading them back (``read_tum``), nearest-time association, ATE and
RPE are what ``python -m legkilo_torch eval`` reports (the reference leaves
evaluation to external tools).
"""

from __future__ import annotations

import os
import time as _time
from typing import Optional, Tuple

import numpy as np


def quat_xyzw_from_rot(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), numpy, batched."""
    R = np.asarray(R, dtype=np.float64)
    w = np.sqrt(np.maximum(1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], 0.0)) / 2
    w = np.maximum(w, 1e-12)
    x = (R[..., 2, 1] - R[..., 1, 2]) / (4 * w)
    y = (R[..., 0, 2] - R[..., 2, 0]) / (4 * w)
    z = (R[..., 1, 0] - R[..., 0, 1]) / (4 * w)
    return np.stack([x, y, z, w], axis=-1)


class TrajectoryWriter:
    """Streaming TUM writer (trajectory_saver.hpp analog)."""

    def __init__(self, path: Optional[str] = None, directory: str = "result/traj"):
        if path is None:
            os.makedirs(directory, exist_ok=True)
            stamp = _time.strftime("%Y%m%d_%H%M%S")
            path = os.path.join(directory, f"traj_{stamp}.txt")
        self.path = path
        self._f = open(path, "w")

    def write(self, t: float, rot: np.ndarray, pos: np.ndarray) -> None:
        q = quat_xyzw_from_rot(np.asarray(rot))
        p = np.asarray(pos, dtype=np.float64)
        self._f.write(
            f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
        )

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tum(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a TUM file -> (times [N], pos [N,3], quat_xyzw [N,4])."""
    data = np.loadtxt(path, comments="#").reshape(-1, 8)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """SE(3) (optionally Sim(3)) alignment of src onto dst (Umeyama)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (D * S.diagonal()).sum() / (xs**2).sum() * len(src) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_pos: np.ndarray, gt_pos: np.ndarray, align: bool = True
) -> float:
    """Absolute trajectory error (RMSE) after optional SE(3) alignment."""
    est, gt = np.asarray(est_pos, np.float64), np.asarray(gt_pos, np.float64)
    if align:
        s, R, t = umeyama_align(est, gt)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


def rot_from_quat_xyzw(q: np.ndarray) -> np.ndarray:
    """Batched quaternion (xyzw, TUM convention) -> rotation matrices."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def rpe(
    est_pos: np.ndarray,
    gt_pos: np.ndarray,
    est_quat: np.ndarray = None,
    gt_quat: np.ndarray = None,
    delta: int = 1,
) -> Tuple[float, float]:
    """Relative pose error over a fixed frame delta (the evo/TUM-benchmark
    metric the reference's evaluation workflow reports alongside ATE).

    Returns (translational RMSE [m], rotational RMSE [rad]); the rotation
    term is NaN when quaternions are not given.  Alignment-free by
    construction (relative motions cancel any global SE(3) offset).
    """
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    n = len(est) - delta
    if n < 1:
        return float("nan"), float("nan")
    if est_quat is None or gt_quat is None:
        # Translation-only: compare relative displacement magnitudes in a
        # rotation-free way (|Δest| vs |Δgt| per window).
        d_est = est[delta:] - est[:-delta]
        d_gt = gt[delta:] - gt[:-delta]
        err = np.linalg.norm(d_est, axis=-1) - np.linalg.norm(d_gt, axis=-1)
        return float(np.sqrt(np.mean(err**2))), float("nan")
    R_e = rot_from_quat_xyzw(est_quat)
    R_g = rot_from_quat_xyzw(gt_quat)
    # Relative motions E_i = (G_i^-1 G_{i+d})^-1 (E_i^-1 E_{i+d})
    rel_e_R = np.einsum("nji,njk->nik", R_e[:-delta], R_e[delta:])
    rel_e_t = np.einsum(
        "nji,nj->ni", R_e[:-delta], est[delta:] - est[:-delta]
    )
    rel_g_R = np.einsum("nji,njk->nik", R_g[:-delta], R_g[delta:])
    rel_g_t = np.einsum("nji,nj->ni", R_g[:-delta], gt[delta:] - gt[:-delta])
    dR = np.einsum("nji,njk->nik", rel_g_R, rel_e_R)
    dt = np.einsum("nji,nj->ni", rel_g_R, rel_e_t - rel_g_t)
    t_rmse = float(np.sqrt(np.mean(np.sum(dt**2, axis=-1))))
    tr = np.clip((np.trace(dR, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    r_rmse = float(np.sqrt(np.mean(np.arccos(tr) ** 2)))
    return t_rmse, r_rmse


def associate(
    t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association of two trajectories."""
    idx_b = np.searchsorted(t_b, t_a)
    idx_b = np.clip(idx_b, 1, len(t_b) - 1)
    left, right = t_b[idx_b - 1], t_b[idx_b]
    choose_left = (t_a - left) < (right - t_a)
    nearest = np.where(choose_left, idx_b - 1, idx_b)
    ok = np.abs(t_b[nearest] - t_a) <= max_dt
    return np.nonzero(ok)[0], nearest[ok]
