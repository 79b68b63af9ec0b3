"""Synthetic legged-robot world simulator (golden-sequence test + bench data).

The port's own copy of ``legkilo_tpu/models/sim.py`` (numpy only): the box
world the port's sim command and chip_smoke use, and the corridor, floor
and cluttered worlds of the robustness tests (the last with bounded facets
that refuse a plane fit); the same world and seed give the same scans and
events in both packages.

The reference has no tests; its validation is dataset replay (SURVEY.md §4).
For hermetic tests and benchmarking we generate a synthetic box world
with an analytically-known trajectory, ray-cast LiDAR scans against the
walls, and derive IMU / leg-kinematic streams that are *exactly* consistent
with the reference's measurement models:

  IMU (KILO.cc:248-249):   raw_acc = (acc_norm/g)(R^T(a_w - grav) + ba) + n
                           raw_gyr = w_body + bw + n
  Kin (KILO.cc:292-309):   0 = v + R(w x p_foot + v_foot)  for stance feet

so the filter's estimate must track the ground truth to within noise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..io.dataset import ImuEvent, KinImuEvent, RawScan


@dataclasses.dataclass
class Plane:
    point: np.ndarray   # [3] a point on the plane
    normal: np.ndarray  # [3] unit


def box_world(half_x=6.0, half_y=5.0, height=3.0) -> List[Plane]:
    """A rectangular room: floor, ceiling, 4 walls."""
    e = np.eye(3)
    return [
        Plane(np.array([0.0, 0.0, 0.0]), e[2]),             # floor
        Plane(np.array([0.0, 0.0, height]), -e[2]),          # ceiling
        Plane(np.array([half_x, 0.0, 0.0]), -e[0]),
        Plane(np.array([-half_x, 0.0, 0.0]), e[0]),
        Plane(np.array([0.0, half_y, 0.0]), -e[1]),
        Plane(np.array([0.0, -half_y, 0.0]), e[1]),
    ]


def corridor_world(half_y=2.0, height=2.5, half_x=1e4) -> List[Plane]:
    """A long corridor along +x: floor, ceiling, 2 side walls; end caps
    pushed beyond sensor range.  Geometrically degenerate along x — every
    visible plane normal is ⊥ x̂, so forward translation is unobservable
    from LiDAR alone and must come from IMU/leg-kinematic fusion (the
    regime the reference's contact-velocity update, KILO.cc:260-314, is
    built for)."""
    e = np.eye(3)
    return [
        Plane(np.array([0.0, 0.0, 0.0]), e[2]),
        Plane(np.array([0.0, 0.0, height]), -e[2]),
        Plane(np.array([0.0, half_y, 0.0]), -e[1]),
        Plane(np.array([0.0, -half_y, 0.0]), e[1]),
        Plane(np.array([half_x, 0.0, 0.0]), -e[0]),
        Plane(np.array([-half_x, 0.0, 0.0]), e[0]),
    ]


def floor_world() -> List[Plane]:
    """A single dominant plane (open field): only z / roll / pitch are
    LiDAR-observable — the hardest degenerate stretch."""
    return [Plane(np.array([0.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]))]


@dataclasses.dataclass
class Facet:
    """A bounded plane patch (disc): rays hit it only within ``radius`` of
    ``center``, from either side.  Dense differently-oriented facets inside
    one voxel are geometry that genuinely refuses a plane fit — the
    is-plane=false regime (init_plane eigen gate + cut_octo_tree descent,
    voxel_map.cc:42-183) that infinite-plane worlds can never exercise."""

    center: np.ndarray  # [3]
    normal: np.ndarray  # [3] unit
    radius: float


def cluttered_world(
    seed: int = 0,
    half_x: float = 6.0,
    half_y: float = 5.0,
    height: float = 3.0,
    rubble: bool = True,
    rubble_grid: float = 0.6,
    rubble_h: float = 0.65,
    n_clusters: int = 40,
    facets_per_cluster: int = 6,
    walls: bool = True,
) -> List:
    """A world with genuine non-planar structure: rubble terrain (the floor
    is overlapping horizontal discs at random stepped heights — voxels
    straddling a step hold two height levels and fail the plane eigen-gate)
    plus vegetation-like clusters of crossing discs.

    Purpose: stress the is-plane=false regime (init_plane eigen gate +
    cut_octo_tree level descent, voxel_map.cc:42-183) with geometry that
    LEGITIMATELY refuses a plane fit — infinite-plane worlds can never
    produce one.  Calibration notes (measured at the reference's own
    0.5 m / 0.01 gate): an isolated disc is locally planar; even two
    perfectly crossing planes inside a 0.5 m voxel only reach
    lam_min ~ 0.005, so sparse scatter produces almost no non-planar
    voxels — stepped rubble with ~0.6 m height jumps is what reliably
    crosses the gate (~25 L0 descent sites on a 4 s run), with the
    cluster scatter adding a few more."""
    rng = np.random.default_rng(seed)
    e = np.eye(3)
    world: List = []
    if walls:
        world += [
            Plane(np.array([half_x, 0.0, 0.0]), -e[0]),
            Plane(np.array([-half_x, 0.0, 0.0]), e[0]),
            Plane(np.array([0.0, half_y, 0.0]), -e[1]),
            Plane(np.array([0.0, -half_y, 0.0]), e[1]),
            Plane(np.array([0.0, 0.0, height]), -e[2]),
        ]
    # bedrock below the rubble so downward rays always terminate
    world.append(Plane(np.array([0.0, 0.0, 0.0]), e[2].copy()))
    if rubble:
        for gx in np.arange(-half_x + 0.3, half_x - 0.3, rubble_grid):
            for gy in np.arange(-half_y + 0.3, half_y - 0.3, rubble_grid):
                c = np.array([
                    gx + rng.uniform(-0.1, 0.1),
                    gy + rng.uniform(-0.1, 0.1),
                    rng.uniform(0.05, rubble_h),
                ])
                world.append(Facet(c, e[2].copy(), 0.5))
    for _ in range(n_clusters):
        c0 = np.array([
            rng.uniform(-half_x + 0.5, half_x - 0.5),
            rng.uniform(-half_y + 0.5, half_y - 0.5),
            rng.uniform(rubble_h + 0.2, height - 0.3),
        ])
        for _ in range(facets_per_cluster):
            c = c0 + rng.normal(scale=0.25, size=3)
            n = rng.normal(size=3)
            n /= np.linalg.norm(n)
            world.append(Facet(c, n, float(rng.uniform(0.15, 0.4))))
    return world


@dataclasses.dataclass
class Trajectory:
    """Smooth analytic circular walk, stationary at identity until t0.

    pose(0) = (I at (0, 0, z0)); the speed ramps in with a smoothstep
    profile so accelerations stay continuous — like the reference datasets,
    the robot stands still while the filter initializes (StateInitial
    assumes a stationary first packet, state_initial.hpp:30-73).

    Legged-robot motion knobs (all default-off so the tame round-1/2
    trajectory is unchanged):

    * ``speed_segments`` — [(t_i, v_i)] speed retargets: at each t_i the
      speed smoothsteps from its previous value to v_i over ``ramp``
      seconds.  v_i = 0 gives stop-and-go.  Knots must be ≥ ramp apart.
    * ``roll_amp`` / ``pitch_amp`` / ``gait_freq`` — body-attitude gait
      oscillation (rad / Hz) superimposed on the path heading, the
      defining excitation of quadruped data (what the reference's
      contact-velocity fusion at KILO.cc:260-314 exists to survive).
      Gated by the current-speed fraction so the stationary init window
      stays truly stationary.
    """

    speed: float = 0.8
    radius: float = 2.5
    z0: float = 0.35
    bob: float = 0.02       # vertical bobbing amplitude
    bob_freq: float = 2.0   # Hz
    t0: float = 0.5         # stationary until here
    ramp: float = 1.0       # smoothstep ramp duration
    speed_segments: Optional[List[Tuple[float, float]]] = None
    roll_amp: float = 0.0   # rad
    pitch_amp: float = 0.0  # rad
    gait_freq: float = 2.0  # Hz

    def _knots(self) -> List[Tuple[float, float]]:
        knots = [(self.t0, self.speed)]
        if self.speed_segments:
            knots += sorted(self.speed_segments)
        return knots

    def _arc(self, t: float) -> Tuple[float, float]:
        """Arc length s(t) and activity factor q(t) = v(t)/max_speed.

        v(t) is piecewise: constant between knots, smoothstep-blended over
        ``ramp`` at each knot (C¹ velocity → continuous acceleration, so
        the numeric second differences in ``derivatives`` stay clean)."""
        knots = self._knots()
        vmax = max(abs(v) for _, v in knots) or 1.0
        s, v, t_cur = 0.0, 0.0, 0.0
        for ti, vtgt in knots:
            if t <= ti:
                return s + v * (t - t_cur), abs(v) / vmax
            s += v * (ti - t_cur)
            u = min((t - ti) / self.ramp, 1.0)
            q = 3 * u * u - 2 * u**3
            # ∫ smoothstep du = u³ − u⁴/2 (the round-1 formula, generalized
            # to a v→vtgt blend instead of 0→speed).
            s += self.ramp * (v * u + (vtgt - v) * (u**3 - 0.5 * u**4))
            if t <= ti + self.ramp:
                return s, abs(v + (vtgt - v) * q) / vmax
            v, t_cur = vtgt, ti + self.ramp
        return s + v * (t - t_cur), abs(v) / vmax

    def pose(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        s, q = self._arc(t)
        a = s / self.radius
        pos = np.array(
            [
                self.radius * np.sin(a),
                self.radius * (1.0 - np.cos(a)),
                self.z0 + q * self.bob * np.sin(2 * np.pi * self.bob_freq * (t - self.t0)),
            ]
        )
        yaw = a
        c, sn = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]])
        if self.roll_amp or self.pitch_amp:
            tau = 2 * np.pi * self.gait_freq * (t - self.t0)
            roll = q * self.roll_amp * np.sin(tau)
            pitch = q * self.pitch_amp * np.cos(tau)
            cr, sr = np.cos(roll), np.sin(roll)
            cp, sp = np.cos(pitch), np.sin(pitch)
            r_x = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
            r_y = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            rot = rot @ r_x @ r_y
        return rot, pos

    def derivatives(self, t: float, eps: float = 1e-4):
        """Numeric velocity, acceleration, body angular velocity."""
        r0, p0 = self.pose(t - eps)
        r1, p1 = self.pose(t)
        r2, p2 = self.pose(t + eps)
        vel = (p2 - p0) / (2 * eps)
        acc = (p2 - 2 * p1 + p0) / (eps * eps)
        dR = r1.T @ r2  # body-frame increment over eps
        w_body = _log_so3(dR) / eps
        return r1, p1, vel, acc, w_body


def _log_so3(R):
    tr = np.trace(R)
    theta = np.arccos(np.clip((tr - 1) / 2, -1, 1))
    ax = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
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
    acc_norm: float = 9.81       # raw accelerometer scale (|mean acc| at rest)
    acc_noise: float = 0.02
    gyr_noise: float = 0.002
    acc_bias: Tuple[float, float, float] = (0.05, -0.03, 0.02)
    gyr_bias: Tuple[float, float, float] = (0.002, -0.001, 0.003)
    lidar_range_noise: float = 0.005
    max_range: float = 30.0
    ext_r: Optional[np.ndarray] = None
    ext_t: Optional[np.ndarray] = None
    kin_noise: float = 0.01
    seed: int = 0


@dataclasses.dataclass
class SimData:
    scans: List[RawScan]
    imu: List[ImuEvent]
    kin: List[KinImuEvent]
    gt_times: np.ndarray        # [M] scan end times
    gt_rot: np.ndarray          # [M, 3, 3]
    gt_pos: np.ndarray          # [M, 3]
    mean_acc: np.ndarray
    mean_gyr: np.ndarray
    anchor_rot: np.ndarray = None  # pose at t=0 (filter world anchor)
    anchor_pos: np.ndarray = None

    def gt_in_filter_frame(self):
        """Ground truth expressed in the filter's world frame (anchored at
        the initial pose, odometry convention)."""
        r0t = self.anchor_rot.T
        pos = (self.gt_pos - self.anchor_pos) @ r0t.T
        rot = np.einsum("ij,njk->nik", r0t, self.gt_rot)
        return rot, pos


def _raycast(origin: np.ndarray, dirs: np.ndarray, world: List, max_range: float):
    """First-hit distances of rays against planes and facet discs.
    Returns (t [N], hit [N])."""
    n = len(dirs)
    best = np.full(n, max_range)
    for pl in world:
        if not isinstance(pl, Plane):
            continue
        denom = dirs @ pl.normal
        num = (pl.point - origin) @ pl.normal
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        valid = (denom < -1e-9) & (t > 0.1)  # hit front face only
        best = np.where(valid & (t < best), t, best)
    facets = [f for f in world if isinstance(f, Facet)]
    if facets:
        fn = np.stack([f.normal for f in facets])          # [F, 3]
        fc = np.stack([f.center for f in facets])          # [F, 3]
        fr = np.array([f.radius for f in facets])          # [F]
        denom = dirs @ fn.T                                 # [N, F]
        num = np.einsum("fj,fj->f", fc - origin, fn)        # [F]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num[None, :] / denom                        # [N, F]
        hitp = origin + t[..., None] * dirs[:, None, :]     # [N, F, 3]
        d2 = ((hitp - fc[None, :, :]) ** 2).sum(-1)         # [N, F]
        valid = (np.abs(denom) > 1e-9) & (t > 0.1) & (d2 <= fr[None, :] ** 2)
        t = np.where(valid, t, max_range)
        best = np.minimum(best, t.min(axis=1))
    hit = best < max_range
    return best, hit


def simulate(
    cfg: SimConfig,
    world: Optional[List[Plane]] = None,
    traj: Optional[Trajectory] = None,
) -> SimData:
    rng = np.random.default_rng(cfg.seed)
    planes = world if world is not None else box_world()
    traj = traj if traj is not None else Trajectory()
    ext_r = cfg.ext_r if cfg.ext_r is not None else np.eye(3)
    ext_t = cfg.ext_t if cfg.ext_t is not None else np.array([0.0, 0.0, 0.2])
    ba = np.array(cfg.acc_bias)
    bw = np.array(cfg.gyr_bias)
    grav = np.array([0.0, 0.0, -cfg.gravity])

    # --- IMU + kinematic streams -----------------------------------------
    imu_events: List[ImuEvent] = []
    kin_events: List[KinImuEvent] = []
    nominal_feet = np.array(
        [
            [0.19, -0.13, -0.32],   # FR
            [0.19, 0.13, -0.32],    # FL
            [-0.19, -0.13, -0.32],  # RR
            [-0.19, 0.13, -0.32],   # RL
        ]
    )
    t = 0.0
    dt_imu = 1.0 / cfg.imu_rate
    while t <= cfg.duration + dt_imu:
        rot, pos, vel, acc_w, w_body = traj.derivatives(t)
        spec_force = rot.T @ (acc_w - grav)  # = imu_a in the state model
        raw_acc = (cfg.acc_norm / cfg.gravity) * (
            spec_force + ba + rng.normal(scale=cfg.acc_noise, size=3)
        )
        raw_gyr = w_body + bw + rng.normal(scale=cfg.gyr_noise, size=3)
        imu_events.append(ImuEvent(time=t, acc=raw_acc, gyr=raw_gyr))

        # Stance-feet: trot gait, diagonal pairs alternate at 2 Hz.
        phase = int(t * 2.0) % 2
        contact = np.array([phase == 0, phase == 1, phase == 1, phase == 0])
        foot_pos = nominal_feet + rng.normal(scale=0.005, size=(4, 3))
        # v_foot from the zero-velocity constraint: v + R(w x p + v_f) = 0.
        v_f = -(np.cross(w_body, foot_pos)) - (rot.T @ vel)
        foot_vel = v_f + rng.normal(scale=cfg.kin_noise, size=(4, 3))
        kin_events.append(
            KinImuEvent(
                time=t, acc=raw_acc, gyr=raw_gyr,
                foot_pos=foot_pos, foot_vel=foot_vel, contact=contact,
            )
        )
        t += dt_imu

    # --- LiDAR scans -------------------------------------------------------
    scans: List[RawScan] = []
    gt_t, gt_r, gt_p = [], [], []
    n_scans = int(cfg.duration / cfg.scan_period)
    ring_elev = np.deg2rad(np.linspace(-15, 15, cfg.n_rings))
    pts_per_ring = cfg.scan_points // cfg.n_rings
    for si in range(n_scans):
        t0 = si * cfg.scan_period
        az = np.tile(np.linspace(0, 2 * np.pi, pts_per_ring, endpoint=False), cfg.n_rings)
        el = np.repeat(ring_elev, pts_per_ring)
        toff = np.tile(
            np.linspace(0.0, cfg.scan_period, pts_per_ring, endpoint=False), cfg.n_rings
        )
        order = np.argsort(toff, kind="stable")
        az, el, toff = az[order], el[order], toff[order]

        pts_body = np.zeros((len(az), 3), dtype=np.float32)
        keep = np.zeros(len(az), dtype=bool)
        # Group by unique time offset for speed (same pose per column).
        uniq, start = np.unique(toff, return_index=True)
        end = np.append(start[1:], len(toff))
        for u, s, e in zip(uniq, start, end):
            rot, pos = traj.pose(t0 + u)
            d_l = np.stack(
                [np.cos(el[s:e]) * np.cos(az[s:e]),
                 np.cos(el[s:e]) * np.sin(az[s:e]),
                 np.sin(el[s:e])], axis=-1,
            )
            # LiDAR frame -> world: R (extR d + ...) ; origin of lidar in world
            d_w = (rot @ ext_r @ d_l.T).T
            origin = rot @ ext_t + pos
            dist, hit = _raycast(origin, d_w, planes, cfg.max_range)
            dist = dist + rng.normal(scale=cfg.lidar_range_noise, size=len(dist))
            pts_body[s:e] = (d_l * dist[:, None]).astype(np.float32)
            keep[s:e] = hit
        scans.append(
            RawScan(
                begin_time=t0,
                end_time=t0 + cfg.scan_period,
                points=pts_body[keep],
                time_offset=toff[keep].astype(np.float32),
            )
        )
        rot_e, pos_e = traj.pose(t0 + cfg.scan_period)
        gt_t.append(t0 + cfg.scan_period)
        gt_r.append(rot_e)
        gt_p.append(pos_e)

    accs = np.stack([e.acc for e in imu_events[:25]])
    gyrs = np.stack([e.gyr for e in imu_events[:25]])
    r0, p0 = traj.pose(0.0)
    return SimData(
        scans=scans,
        imu=imu_events,
        kin=kin_events,
        gt_times=np.asarray(gt_t),
        gt_rot=np.stack(gt_r),
        gt_pos=np.stack(gt_p),
        mean_acc=accs.mean(0),
        mean_gyr=gyrs.mean(0),
        anchor_rot=r0,
        anchor_pos=p0,
    )
