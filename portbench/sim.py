"""The benchmark's own sensor simulator: a legged robot walking a circle in a
box room, with a 16-ring LiDAR, an IMU and leg kinematics.

A frozen copy of ``legkilo_torch/models/sim.py`` (the box world, the
default ``Trajectory`` and ``simulate``), so that a later change to the
port's sim cannot change the benchmark's inputs.  One change: a scan is
ray-cast in one call over all its time offsets instead of one call an
offset.  The world, the trajectory, the random draws and their order are
the port's: the same ``SimConfig`` gives the same scans, events and
ground truth (portbench/tests/test_portbench_inputs.py holds the two).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RawScan:
    begin_time: float
    end_time: float
    points: np.ndarray       # [N, 3] float32, LiDAR frame
    time_offset: np.ndarray  # [N] float32, seconds since begin_time
    intensity: Optional[np.ndarray] = None


@dataclasses.dataclass
class ImuEvent:
    time: float
    acc: np.ndarray  # [3]
    gyr: np.ndarray  # [3]


@dataclasses.dataclass
class KinImuEvent:
    time: float
    acc: np.ndarray       # [3]
    gyr: np.ndarray       # [3]
    foot_pos: np.ndarray  # [4, 3]
    foot_vel: np.ndarray  # [4, 3]
    contact: np.ndarray   # [4] bool


@dataclasses.dataclass
class Plane:
    point: np.ndarray
    normal: np.ndarray


def box_world(half_x=6.0, half_y=5.0, height=3.0) -> List[Plane]:
    """A rectangular room: floor, ceiling, 4 walls."""
    e = np.eye(3)
    return [
        Plane(np.array([0.0, 0.0, 0.0]), e[2]),
        Plane(np.array([0.0, 0.0, height]), -e[2]),
        Plane(np.array([half_x, 0.0, 0.0]), -e[0]),
        Plane(np.array([-half_x, 0.0, 0.0]), e[0]),
        Plane(np.array([0.0, half_y, 0.0]), -e[1]),
        Plane(np.array([0.0, -half_y, 0.0]), e[1]),
    ]


@dataclasses.dataclass
class Trajectory:
    """Circular walk, stationary at identity until ``t0``, the speed ramped
    in by a smoothstep over ``ramp`` seconds, with a vertical bob."""

    speed: float = 0.8
    radius: float = 2.5
    z0: float = 0.35
    bob: float = 0.02
    bob_freq: float = 2.0
    t0: float = 0.5
    ramp: float = 1.0

    def _arc(self, t: float) -> Tuple[float, float]:
        """Arc length s(t) and the speed's share of its maximum q(t)."""
        if t <= self.t0:
            return 0.0, 0.0
        u = min((t - self.t0) / self.ramp, 1.0)
        q = 3 * u * u - 2 * u**3
        s = self.ramp * (self.speed * (u**3 - 0.5 * u**4))
        if t <= self.t0 + self.ramp:
            return s, abs(q * self.speed) / abs(self.speed)
        return s + self.speed * (t - (self.t0 + self.ramp)), 1.0

    def poses(self, ts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Rotations [T, 3, 3] and positions [T, 3] at the times ``ts``."""
        ts = np.asarray(ts, dtype=np.float64).reshape(-1)
        sq = np.array([self._arc(float(t)) for t in ts]).reshape(-1, 2)
        a = sq[:, 0] / self.radius
        pos = np.stack([
            self.radius * np.sin(a),
            self.radius * (1.0 - np.cos(a)),
            self.z0 + sq[:, 1] * self.bob * np.sin(2 * np.pi * self.bob_freq * (ts - self.t0)),
        ], axis=-1)
        c, sn = np.cos(a), np.sin(a)
        rot = np.zeros((len(ts), 3, 3))
        rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c, -sn, sn, c
        rot[:, 2, 2] = 1.0
        return rot, pos

    def pose(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        rot, pos = self.poses(np.array([t]))
        return rot[0], pos[0]

    def derivatives(self, t: float, eps: float = 1e-4):
        """Numeric velocity, acceleration and body angular velocity."""
        r0, p0 = self.pose(t - eps)
        r1, p1 = self.pose(t)
        r2, p2 = self.pose(t + eps)
        vel = (p2 - p0) / (2 * eps)
        acc = (p2 - 2 * p1 + p0) / (eps * eps)
        w_body = _log_so3(r1.T @ r2) / eps
        return r1, p1, vel, acc, w_body


def _log_so3(r):
    theta = np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))
    ax = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    if theta < 1e-10:
        return 0.5 * ax
    return theta / (2 * np.sin(theta)) * ax


@dataclasses.dataclass
class SimConfig:
    duration: float = 10.0
    scan_period: float = 0.1
    scan_points: int = 4000
    n_rings: int = 16
    imu_rate: float = 50.0
    gravity: float = 9.81
    acc_norm: float = 9.81
    acc_noise: float = 0.02
    gyr_noise: float = 0.002
    acc_bias: Tuple[float, float, float] = (0.05, -0.03, 0.02)
    gyr_bias: Tuple[float, float, float] = (0.002, -0.001, 0.003)
    lidar_range_noise: float = 0.005
    max_range: float = 30.0
    kin_noise: float = 0.01
    seed: int = 0


@dataclasses.dataclass
class SimData:
    scans: List[RawScan]
    imu: List[ImuEvent]
    kin: List[KinImuEvent]
    gt_times: np.ndarray  # [M] scan end times
    gt_rot: np.ndarray    # [M, 3, 3]
    gt_pos: np.ndarray    # [M, 3]


def _raycast(origin: np.ndarray, dirs: np.ndarray, world: List[Plane], max_range: float):
    """First front-face hits of rays (origins [N, 3], directions [N, 3])."""
    best = np.full(len(dirs), max_range)
    for pl in world:
        denom = dirs @ pl.normal
        num = (pl.point - origin) @ pl.normal
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        valid = (denom < -1e-9) & (t > 0.1)
        best = np.where(valid & (t < best), t, best)
    return best, best < max_range


def simulate(cfg: SimConfig) -> SimData:
    rng = np.random.default_rng(cfg.seed)
    planes = box_world()
    traj = Trajectory()
    ext_t = np.array([0.0, 0.0, 0.2])
    ba, bw = np.array(cfg.acc_bias), np.array(cfg.gyr_bias)
    grav = np.array([0.0, 0.0, -cfg.gravity])

    imu_events: List[ImuEvent] = []
    kin_events: List[KinImuEvent] = []
    nominal_feet = np.array([[0.19, -0.13, -0.32], [0.19, 0.13, -0.32],
                             [-0.19, -0.13, -0.32], [-0.19, 0.13, -0.32]])
    t = 0.0
    dt_imu = 1.0 / cfg.imu_rate
    while t <= cfg.duration + dt_imu:
        rot, pos, vel, acc_w, w_body = traj.derivatives(t)
        spec_force = rot.T @ (acc_w - grav)
        raw_acc = (cfg.acc_norm / cfg.gravity) * (
            spec_force + ba + rng.normal(scale=cfg.acc_noise, size=3))
        raw_gyr = w_body + bw + rng.normal(scale=cfg.gyr_noise, size=3)
        imu_events.append(ImuEvent(time=t, acc=raw_acc, gyr=raw_gyr))
        phase = int(t * 2.0) % 2  # trot: diagonal pairs alternate at 2 Hz
        contact = np.array([phase == 0, phase == 1, phase == 1, phase == 0])
        foot_pos = nominal_feet + rng.normal(scale=0.005, size=(4, 3))
        v_f = -(np.cross(w_body, foot_pos)) - (rot.T @ vel)
        foot_vel = v_f + rng.normal(scale=cfg.kin_noise, size=(4, 3))
        kin_events.append(KinImuEvent(time=t, acc=raw_acc, gyr=raw_gyr, foot_pos=foot_pos,
                                      foot_vel=foot_vel, contact=contact))
        t += dt_imu

    scans: List[RawScan] = []
    gt_t, gt_r, gt_p = [], [], []
    ring_elev = np.deg2rad(np.linspace(-15, 15, cfg.n_rings))
    per_ring = cfg.scan_points // cfg.n_rings
    az = np.tile(np.linspace(0, 2 * np.pi, per_ring, endpoint=False), cfg.n_rings)
    el = np.repeat(ring_elev, per_ring)
    toff = np.tile(np.linspace(0.0, cfg.scan_period, per_ring, endpoint=False), cfg.n_rings)
    order = np.argsort(toff, kind="stable")
    az, el, toff = az[order], el[order], toff[order]
    uniq, inv = np.unique(toff, return_inverse=True)
    d_l = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1)
    for si in range(int(cfg.duration / cfg.scan_period)):
        t0 = si * cfg.scan_period
        rots, poss = traj.poses(t0 + uniq)
        rot, pos = rots[inv], poss[inv]
        d_w = np.einsum("nij,nj->ni", rot, d_l)
        origin = np.einsum("nij,j->ni", rot, ext_t) + pos
        dist, hit = _raycast(origin, d_w, planes, cfg.max_range)
        dist = dist + rng.normal(scale=cfg.lidar_range_noise, size=len(dist))
        pts = (d_l * dist[:, None]).astype(np.float32)
        scans.append(RawScan(begin_time=t0, end_time=t0 + cfg.scan_period, points=pts[hit],
                             time_offset=toff[hit].astype(np.float32)))
        rot_e, pos_e = traj.pose(t0 + cfg.scan_period)
        gt_t.append(t0 + cfg.scan_period)
        gt_r.append(rot_e)
        gt_p.append(pos_e)
    return SimData(scans=scans, imu=imu_events, kin=kin_events, gt_times=np.asarray(gt_t),
                   gt_rot=np.stack(gt_r), gt_pos=np.stack(gt_p))
