"""SO(3) primitives, batched over leading dims (port of legkilo_tpu/core/so3.py).

Only what the deferred main path uses: skew and the Rodrigues exponential
with the same small-angle Taylor fallback, so f32 results match the JAX
package op for op.
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
