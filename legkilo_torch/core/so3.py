"""SO(3) primitives, batched over leading dims (port of legkilo_tpu/core/so3.py).

Skew, the Rodrigues exponential and the logarithm with the JAX module's
small-angle Taylor fallbacks (so f32 results match it op for op), the ZYX
Euler angles and the rotation -> quaternion conversion
(math_utils.hpp:12-94).
"""

from __future__ import annotations

import torch

_SMALL_ANGLE = 1e-6


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]x (math_utils.hpp:12-17)."""
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


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential, axis-angle -> rotation (math_utils.hpp:19-68)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < _SMALL_ANGLE
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 * (1.0 / 6.0), torch.sin(safe_t) / safe_t)
    b = torch.where(
        small, 0.5 - theta2 * (1.0 / 24.0), (1.0 - torch.cos(safe_t)) / (safe_t * safe_t)
    )
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Logarithm, rotation -> axis-angle (Log(R), math_utils.hpp:70-76):
    theta = acos((tr R - 1) / 2), the axis from the antisymmetric part,
    clamped, with theta / (2 sin theta) ~ 0.5 + theta^2 / 12 near 0.  Near
    theta = pi the antisymmetric part vanishes, as in the reference."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    ax = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    small = theta < _SMALL_ANGLE
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * safe_sin))
    return scale[..., None] * ax


def rot_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> (roll, pitch, yaw), ZYX (RotMtoEuler, math_utils.hpp:78-94)."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                    torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


def quat_from_rot(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> unit quaternion (w, x, y, z), branch-free: Shepperd's
    four constructions, the one with the largest magnitude taken."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cases = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1),
    ], dim=-2)                                            # [..., 4, 4]
    mags = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], dim=-1
    )
    best = torch.argmax(mags, dim=-1)
    q = torch.take_along_dim(cases, best[..., None, None].expand(best.shape + (1, 4)), dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
