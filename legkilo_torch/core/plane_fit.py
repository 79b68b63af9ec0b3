"""Plane fits from per-voxel moments (port of legkilo_tpu/core/plane_fit.py).

Each voxel keeps n, m1 = sum p~, m2 = sum p~ p~^T, S0 = sum V, S1 = sum V (x) p~
and S2 = sum V (x) p~ p~^T (p~ relative to the voxel centre); the plane
normal, centre, eigenvalues and the 6x6 plane covariance of the reference's
init_plane (voxel_map.cc:42-117) follow in closed form.  ``fit_planes`` is
the refit with ``use_pallas_refit`` off; with it on the refit kernel runs
(ops/plane_fit_rows.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.eig3x3 import eigh3x3

_DEG2RAD = math.pi / 180.0
_ALPHA_EPS = 1e-7


class PlaneMoments(NamedTuple):
    n: torch.Tensor    # [...]
    m1: torch.Tensor   # [..., 3]
    m2: torch.Tensor   # [..., 3, 3]
    s0: torch.Tensor   # [..., 3, 3]
    s1: torch.Tensor   # [..., 3, 3, 3]
    s2: torch.Tensor   # [..., 3, 3, 3, 3]


class PlaneFit(NamedTuple):
    center_rel: torch.Tensor  # [..., 3]
    normal: torch.Tensor      # [..., 3]
    evals: torch.Tensor       # [..., 3] ascending
    radius: torch.Tensor      # [...]
    plane_var: torch.Tensor   # [..., 6, 6]
    is_plane: torch.Tensor    # [...] bool


def point_moments(p_rel: torch.Tensor, var: torch.Tensor) -> PlaneMoments:
    """Moments contributed by single points (for scatter-add into slots)."""
    m2 = p_rel[..., :, None] * p_rel[..., None, :]
    s1 = var[..., :, :, None] * p_rel[..., None, None, :]
    s2 = var[..., :, :, None, None] * m2[..., None, None, :, :]
    return PlaneMoments(
        n=torch.ones(p_rel.shape[:-1], dtype=p_rel.dtype, device=p_rel.device),
        m1=p_rel, m2=m2, s0=var, s1=s1, s2=s2,
    )


def fit_planes(m: PlaneMoments, planer_threshold: float) -> PlaneFit:
    """Closed-form plane fit from moments (init_plane, voxel_map.cc:42-117)."""
    n = torch.clamp(m.n, min=1.0)
    inv_n = 1.0 / n
    cr = m.m1 * inv_n[..., None]
    cov = m.m2 * inv_n[..., None, None] - cr[..., :, None] * cr[..., None, :]
    evals, evecs = eigh3x3(cov)
    e_min = evecs[..., :, 0]
    lam_min = evals[..., 0]
    is_plane = lam_min < planer_threshold

    alphas, bs = [], []
    for k in (1, 2):
        e_m = evecs[..., :, k]
        denom = n * (lam_min - evals[..., k])
        denom = torch.where(torch.abs(denom) < _ALPHA_EPS, torch.full_like(denom, -_ALPHA_EPS), denom)
        alphas.append(1.0 / denom)
        bs.append(e_m[..., :, None] * e_min[..., None, :] + e_min[..., :, None] * e_m[..., None, :])

    s1 = m.s1
    t = (
        m.s2
        - s1[..., :, :, :, None] * cr[..., None, None, None, :]
        - s1[..., :, :, None, :] * cr[..., None, None, :, None]
        + m.s0[..., :, :, None, None] * (cr[..., :, None] * cr[..., None, :])[..., None, None, :, :]
    )
    p1 = s1 - m.s0[..., :, :, None] * cr[..., None, None, :]

    t_nn = torch.zeros_like(cov)
    t_nq = torch.zeros_like(cov)
    for i, (a_i, b_i) in enumerate(zip(alphas, bs)):
        e_i = evecs[..., :, i + 1]
        u_i = torch.einsum("...ab,...bca->...c", b_i, p1)
        t_nq = t_nq + (a_i * inv_n)[..., None, None] * (e_i[..., :, None] * u_i[..., None, :])
        for j, (a_j, b_j) in enumerate(zip(alphas, bs)):
            e_j = evecs[..., :, j + 1]
            c_ij = torch.einsum("...ab,...cd,...bcda->...", b_i, b_j, t)
            t_nn = t_nn + (a_i * a_j * c_ij)[..., None, None] * (e_i[..., :, None] * e_j[..., None, :])

    t_qq = m.s0 * (inv_n * inv_n)[..., None, None]
    plane_var = torch.cat(
        [torch.cat([t_nn, t_nq], dim=-1), torch.cat([t_nq.transpose(-1, -2), t_qq], dim=-1)],
        dim=-2,
    )
    plane_var = torch.where(is_plane[..., None, None], plane_var, torch.zeros_like(plane_var))
    return PlaneFit(
        center_rel=cr,
        normal=e_min,
        evals=evals,
        radius=torch.sqrt(torch.clamp(evals[..., 2], min=0.0)),
        plane_var=plane_var,
        is_plane=is_plane,
    )


def calc_body_cov(pb: torch.Tensor, range_inc: float, degree_inc: float) -> torch.Tensor:
    """Per-point sensor covariance in the LiDAR frame (calcBodyCov,
    voxel_map.cc:22-40): range noise along the bearing plus beam noise in
    the tangent plane; |z| < 1e-8 is nudged to 1e-4."""
    z = pb[..., 2]
    pb = torch.cat([pb[..., 0:2], torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-4), z)[..., None]], dim=-1)
    rng = torch.linalg.norm(pb, dim=-1)
    range_var = range_inc * range_inc
    tangent_var = math.sin(degree_inc * _DEG2RAD) ** 2

    direction = pb / torch.clamp(rng[..., None], min=1e-12)
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    zero = torch.zeros_like(dx)
    dhat = torch.stack(
        [
            torch.stack([zero, -dz, dy], dim=-1),
            torch.stack([dz, zero, -dx], dim=-1),
            torch.stack([-dy, dx, zero], dim=-1),
        ],
        dim=-2,
    )
    dz_safe = torch.where(torch.abs(dz) < 1e-12, torch.full_like(dz, 1e-12), dz)
    base1 = torch.stack([torch.ones_like(dx), torch.ones_like(dx), -(dx + dy) / dz_safe], dim=-1)
    base1 = base1 / torch.linalg.norm(base1, dim=-1, keepdim=True)
    base2 = torch.linalg.cross(base1, direction, dim=-1)
    base2 = base2 / torch.linalg.norm(base2, dim=-1, keepdim=True)
    nmat = torch.stack([base1, base2], dim=-1)
    amat = rng[..., None, None] * (dhat @ nmat)
    return range_var * direction[..., :, None] * direction[..., None, :] + tangent_var * (
        amat @ amat.transpose(-1, -2)
    )
