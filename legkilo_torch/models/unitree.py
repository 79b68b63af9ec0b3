"""Unitree Go1/Go2 leg kinematics: FK, foot Jacobian velocity, contact.

The port's own copy of ``legkilo_tpu/models/unitree.py`` (float64 numpy).
Capability parity with legkilo/src/preprocess/kinematics.{h,cc}:
closed-form 3-DoF forward kinematics per leg (hip abduction, thigh, calf),
analytic Jacobian for foot velocity, Schmitt-trigger contact detection from
foot-force, and the Unitree->internal leg reorder (FL,FR,RL,RR published ->
FR,FL,RR,RL internal, kinematics.cc:13-32).

Vectorized in NumPy — this is a host-side decode step feeding the packet
builder, like the reference's kinematic callback thread.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..config import KinematicsConfig
from ..io.dataset import KinImuEvent

# Motor index base per internal leg (FR, FL, RR, RL) in the Unitree
# motorState array (kinematics.cc:24-33).
_MOTOR_BASE = np.array([3, 0, 9, 6])
# footForce publishes in Unitree order FL,FR,RL,RR; internal order FR,FL,RR,RL
# (kinematics.cc:17-20).
_FORCE_INDEX = np.array([1, 0, 3, 2])
# Leg mirror signs per internal leg, as the reference sets them
# (kinematics.cc:57-59): lfoot +1 for i in {0, 2} (FR, RR), ffoot +1 for
# i < 2 (the front legs).
_LFOOT = np.array([1.0, -1.0, 1.0, -1.0])
_FFOOT = np.array([1.0, 1.0, -1.0, -1.0])


def foot_pos_vel(
    q: np.ndarray, dq: np.ndarray, cfg: KinematicsConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form FK + Jacobian foot velocity for all 4 legs, batched.

    q, dq: [..., 4, 3] joint angles / velocities in internal leg order.
    Returns (foot_pos [..., 4, 3], foot_vel [..., 4, 3]) in the body frame.
    Parity: caculateFootPosVel (kinematics.cc:54-90).
    """
    ox, oy = cfg.leg_offset_x, cfg.leg_offset_y
    lc, lt, d = cfg.leg_calf_length, cfg.leg_thigh_length, cfg.leg_thigh_offset
    lfoot = _LFOOT
    ffoot = _FFOOT

    s1, s2 = np.sin(q[..., 0]), np.sin(q[..., 1])
    s23 = np.sin(q[..., 1] + q[..., 2])
    c1, c2 = np.cos(q[..., 0]), np.cos(q[..., 1])
    c23 = np.cos(q[..., 1] + q[..., 2])

    px = -lt * s2 - lc * s23 + ffoot * ox
    py = lfoot * d * c1 + lc * s1 * c23 + lt * c2 * s1 + lfoot * oy
    pz = lfoot * d * s1 - lc * c1 * c23 - lt * c1 * c2
    foot_pos = np.stack([px, py, pz], axis=-1)

    j01 = -lc * c23 - lt * c2
    j02 = -lc * c23
    j10 = lt * c1 * c2 - lfoot * d * s1 + lc * c1 * c23
    j11 = -s1 * (lc * s23 + lt * s2)
    j12 = -lc * s23 * s1
    j20 = lt * c2 * s1 + lfoot * d * c1 + lc * s1 * c23
    j21 = c1 * (lc * s23 + lt * s2)
    j22 = lc * s23 * c1

    dq0, dq1, dq2 = dq[..., 0], dq[..., 1], dq[..., 2]
    vx = j01 * dq1 + j02 * dq2
    vy = j10 * dq0 + j11 * dq1 + j12 * dq2
    vz = j20 * dq0 + j21 * dq1 + j22 * dq2
    foot_vel = np.stack([vx, vy, vz], axis=-1)
    return foot_pos, foot_vel


class ContactDetector:
    """Per-foot Schmitt trigger on foot force (kinematics.h:10-23)."""

    def __init__(self, t_on: float, t_off: float, n_feet: int = 4):
        self.t_on = t_on
        self.t_off = t_off
        self.in_contact = np.ones(n_feet, dtype=bool)

    def update(self, force: np.ndarray) -> np.ndarray:
        turn_on = ~self.in_contact & (force > self.t_on)
        turn_off = self.in_contact & (force < self.t_off)
        self.in_contact = (self.in_contact | turn_on) & ~turn_off
        return self.in_contact.copy()


@dataclasses.dataclass
class HighState:
    """Decoded unitree_legged_msgs/HighState essentials."""

    stamp: float
    accelerometer: np.ndarray   # [3]
    gyroscope: np.ndarray       # [3]
    motor_q: np.ndarray         # [12+]
    motor_dq: np.ndarray        # [12+]
    foot_force: np.ndarray      # [4] Unitree order


class Kinematics:
    """HighState -> KinImuEvent (Kinematics::processing, kinematics.cc:5-52)."""

    def __init__(self, cfg: KinematicsConfig):
        self.cfg = cfg
        self.contacts = ContactDetector(
            cfg.contact_force_threshold_up, cfg.contact_force_threshold_down
        )

    def processing(self, hs: HighState) -> KinImuEvent:
        contact = self.contacts.update(hs.foot_force[_FORCE_INDEX])
        q = np.stack([hs.motor_q[b : b + 3] for b in _MOTOR_BASE])
        dq = np.stack([hs.motor_dq[b : b + 3] for b in _MOTOR_BASE])
        foot_pos, foot_vel = foot_pos_vel(q, dq, self.cfg)
        return KinImuEvent(
            time=hs.stamp,
            acc=np.asarray(hs.accelerometer, dtype=np.float64),
            gyr=np.asarray(hs.gyroscope, dtype=np.float64),
            foot_pos=foot_pos,
            foot_vel=foot_vel,
            contact=contact,
        )
