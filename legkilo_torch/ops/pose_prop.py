"""IMU-propagated per-bucket match poses: CUDA kernel + plain version.

Replaces the JAX package's Pallas kernel ``_pose_kernel``
(ops/pallas/pose_prop.py:57, driven by ``pose_call`` :194) with its row
contract over the flat event/bucket timeline (MP slots, a multiple of 128):

    par [32]: rot0(9) pos0(3) vel0(3) ba(3) bw(3) grav(3) imu_w(3) imu_a(3)
    last_predict_t g_over_acc_norm;  rows [9,MP]: t, gate, is_event, gyr(3),
    acc(3)  ->  [12,MP]: r_end row-major (9), p_end (3) at every slot

The latched rates, the last-predict clock, the prefix product of the delta
rotations and the two cumulative sums are inclusive doubling
(Hillis-Steele) scans.  On a CUDA tensor ``pose_call`` launches
``csrc/pose_prop.cu`` (one block, one thread a slot, MP <= 1024); on a CPU
tensor it runs ``pose_plain``, which takes the same doubling steps in the
same order, so the two round their sums and products alike.  Padded slots
(gate 0) are exact no-ops.
"""

from __future__ import annotations

import torch

from . import _build

F32 = torch.float32

# par layout
P_ROT, P_POS, P_VEL, P_BA, P_BW, P_GRAV, P_IMU_W, P_IMU_A, P_LP, P_GSC = (
    0, 9, 12, 15, 18, 21, 24, 27, 30, 31)
PAR_W = 32
# rows layout: t(0) gate(1) is_ev(2) gyr(3:6) acc(6:9)
IN_W = 9
MAX_MP = 1024  # one thread a slot in one block

_NEG = -3.0e38
_SMALL_ANGLE = 1e-6  # core/so3._SMALL_ANGLE


def _shift(x, n, fill):
    """x moved n slots to the right, the first n slots reading ``fill``."""
    head = torch.zeros_like(x[:n]) + fill
    return torch.cat([head, x[:-n]]) if n < x.shape[0] else head[: x.shape[0]]


def _mat_mul(a, b):
    return [a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
            for i in range(3) for j in range(3)]


def _steps(mp):
    n = 1
    while n < mp:
        yield n
        n *= 2


def pose_plain(par, rows):
    """Plain PyTorch version of the pose kernel (same contract)."""
    s = par.reshape(-1)
    mp = rows.shape[1]
    t = rows[0]
    gate = rows[1] > 0.5
    has = rows[2]
    val = [rows[3 + i] - s[P_BW + i] for i in range(3)]
    val += [s[P_GSC] * rows[6 + i] - s[P_BA + i] for i in range(3)]

    # Latch: the rates of the last valid event strictly before each slot.
    for n in _steps(mp):
        has_sh = _shift(has, n, 0.0)
        val = [torch.where(has > 0.5, v, _shift(v, n, 0.0)) for v in val]
        has = torch.maximum(has, has_sh)
    has_p = _shift(has, 1, 0.0) > 0.5
    w_seg = [torch.where(has_p, _shift(val[i], 1, 0.0), s[P_IMU_W + i]) for i in range(3)]
    a_seg = [torch.where(has_p, _shift(val[3 + i], 1, 0.0), s[P_IMU_A + i]) for i in range(3)]

    # dt replicates the chain's last-predict clock; masked slots are no-ops.
    lp = s[P_LP]
    tv = torch.where(gate, t, torch.full_like(t, _NEG))
    for n in _steps(mp):
        tv = torch.maximum(tv, _shift(tv, n, _NEG))
    t_end = torch.maximum(tv, lp)
    dt = torch.where(gate, t - _shift(t_end, 1, lp), torch.zeros_like(t))

    # d_r = exp_so3(w_seg dt): Rodrigues with the Taylor branch.
    wx, wy, wz = w_seg[0] * dt, w_seg[1] * dt, w_seg[2] * dt
    th2 = wx * wx + wy * wy + wz * wz
    th = torch.sqrt(th2)
    small = th < _SMALL_ANGLE
    safe = torch.where(small, torch.ones_like(th), th)
    a_c = torch.where(small, 1.0 - th2 * (1.0 / 6.0), torch.sin(safe) / safe)
    b_c = torch.where(small, 0.5 - th2 * (1.0 / 24.0), (1.0 - torch.cos(safe)) / (safe * safe))
    zero = torch.zeros_like(wx)
    kk = [-(wy * wy + wz * wz), wx * wy, wx * wz,
          wx * wy, -(wx * wx + wz * wz), wy * wz,
          wx * wz, wy * wz, -(wx * wx + wy * wy)]
    k = [zero, -wz, wy, wz, zero, -wx, -wy, wx, zero]
    eye = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    pref = [eye[i] + a_c * k[i] + b_c * kk[i] for i in range(9)]

    # Inclusive prefix product, order-preserving: shifted @ current.
    for n in _steps(mp):
        pref = _mat_mul([_shift(pref[i], n, eye[i]) for i in range(9)], pref)

    r0 = [s[P_ROT + i] for i in range(9)]
    r_end = _mat_mul(r0, pref)
    r_start = [_shift(r_end[i], 1, r0[i]) for i in range(9)]
    csum = [dt * (r_start[3 * i] * a_seg[0] + r_start[3 * i + 1] * a_seg[1]
                  + r_start[3 * i + 2] * a_seg[2] + s[P_GRAV + i]) for i in range(3)]
    for n in _steps(mp):
        csum = [c + _shift(c, n, 0.0) for c in csum]
    v_end = [s[P_VEL + i] + csum[i] for i in range(3)]
    dp = [dt * _shift(v_end[i], 1, s[P_VEL + i]) for i in range(3)]
    for n in _steps(mp):
        dp = [p + _shift(p, n, 0.0) for p in dp]
    p_end = [s[P_POS + i] + dp[i] for i in range(3)]
    return torch.stack(r_end + p_end)


def pose_call(par, rows):
    """The pose kernel on a CUDA tensor, its plain version on a CPU one."""
    if rows.device.type != "cuda":
        return pose_plain(par, rows)
    mp = rows.shape[1]
    args = (par.reshape(-1), rows)
    if rows.shape[0] != IN_W or mp % 128 != 0 or not 0 < mp <= MAX_MP:
        raise ValueError(f"pose_call: rows {tuple(rows.shape)}, expected ({IN_W}, MP) with MP a "
                         f"multiple of 128 up to {MAX_MP}")
    if args[0].numel() != PAR_W:
        raise ValueError(f"pose_call: par must hold {PAR_W} floats")
    dev = _build.check_tensors("pose_call", args, [F32] * 2)
    out = torch.empty((12, mp), dtype=F32, device=dev)
    _build.launch("pose_launch", args + (out,), [mp])
    pose_call.launches += 1
    return out


pose_call.launches = 0
