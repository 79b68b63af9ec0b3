"""One replica of the filter: the first frame, and one scan step.

A scan step, as Leg-KILO's deferred pipeline defines it:

1. The clocks move to the new scan's start (``rebase``).
2. Match poses: the scan-start state integrated through the scan's events
   and buckets, each stretch on the rates of the last event before it
   (rate - gyroscope bias, scaled force - accelerometer bias), the latched
   rates before any event.
3. Match (``match``): each valid point (the first ``cap`` of the scan)
   goes to the world at its bucket's match pose and is tested against two
   chains of voxels, its own voxel and the neighbour on the side it lies
   more than a quarter voxel towards, one voxel a level.  A level is
   reached only while every coarser voxel of the chain exists and is no
   plane; a candidate passes when its voxel holds a plane, the point lies
   within ``radius_k`` radii of the plane's centre and within
   ``sigma_num`` sigma of the plane, sigma^2 = J PV J^T + n^T V n with V
   the point's world covariance (the scan-start covariance's pose block
   included).  The most probable passing candidate wins; the neighbour
   chain counts only where the own chain matched nothing.  The point's
   measurement variance is ``lidar_point_meas_ratio`` (J PV J^T + n^T V n),
   V now the sensor's alone.
4. The chain: bucket by bucket, each event's predict and IMU (or IMU and
   kinematic) update, then the bucket's predict and the point-to-plane
   update of its matched points at the filter's own state.
5. Insert at each bucket's updated pose, with the updated pose's
   covariance: on the fused path a point enters level l only while its
   own chain's coarser voxels (found at match time) exist and are no
   planes, the first ``tpu_map_insert_row_cap`` (point, level) rows level
   by level, into the voxels keyed at the match pose; on the per-point
   path every point enters every level, keyed at the updated pose.
6. The covariance is made symmetric.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from . import eskf, inputs
from .arith import Arith, body_cov, exp_so3, skew
from .eskf import ACC, BA, BW, GRAV, POS, RATE, VEL, Filter, Noise
from .voxels import MapCfg, VoxelMap


class Cfg(NamedTuple):
    s: dict
    map: MapCfg
    ext_R: np.ndarray
    ext_t: np.ndarray
    kin: bool
    fused: bool
    match_cap: int
    insert_cap: int


def make_cfg(s: dict) -> Cfg:
    unsupported = [k for k, bad in (
        ("map_sliding_en", bool(s.get("map_sliding_en", False))),
        ("tpu_match_iters", int(s.get("tpu_match_iters", 1)) != 1),
        ("tpu_match_pose", s.get("tpu_match_pose", "imu") != "imu"),
        ("tpu_pipeline", s.get("tpu_pipeline", "deferred") != "deferred"),
    ) if bad]
    if unsupported:
        raise NotImplementedError(f"the reference does not model {unsupported}")
    return Cfg(s=s, map=MapCfg(s), ext_R=np.reshape(np.asarray(s["extrinsic_R"], float), (3, 3)),
               ext_t=np.asarray(s["extrinsic_T"], float), kin=not bool(s["only_imu_use"]),
               fused=s.get("tpu_chain_impl", "fused") == "fused",
               match_cap=int(s.get("tpu_match_cap", 0)), insert_cap=int(s.get("tpu_insert_cap", 0)))


def world_cov(ar: Arith, cfg: Cfg, p_b, p_i, R, P_rr, P_pp, cross_on=None):
    """(sensor-only, full) world covariances [N, 3, 3] of points p_b (LiDAR
    frame; p_i in the IMU frame) at rotations R [N, 3, 3] with the pose
    covariance blocks P_rr, P_pp ([3, 3] or [N, 3, 3])."""
    s = cfg.s
    C = body_cov(ar, p_b, float(s["dept_err"]), float(s["beam_err"]))
    RE = ar.mm(R, cfg.ext_R)
    ws = ar.ein("nij,njk,nlk->nil", RE, C, RE)
    Rx = ar.mm(R, skew(p_i if cross_on is None else cross_on))
    P_rr = np.broadcast_to(P_rr, (len(p_i), 3, 3))
    P_pp = np.broadcast_to(P_pp, (len(p_i), 3, 3))
    return ws, ws + ar.ein("nij,njk,nlk->nil", Rx, P_rr, Rx) + P_pp


def init(ar: Arith, cfg: Cfg, first_pkt: inputs.Packet, first_scan):
    """(filter, map, g/|acc|) of the first frame: rotation I, gravity against
    the mean specific force, the gyroscope bias at the mean rate, the
    latched force at rest; the map from the first scan's decimated points
    at that state, every point at every level, the point's cross term on
    its LiDAR-frame position (the upstream's BuildVoxelMap)."""
    acc, gyr = inputs.first_imu_mean(first_pkt)
    an = float(np.sqrt(np.dot(acc, acc)))
    grav = -acc / an * float(cfg.s["gravity"])
    x = np.zeros(27)
    x[GRAV], x[BW], x[ACC] = grav, gyr, -grav
    t = first_pkt.end_offset
    f = Filter(ar.f(np.eye(3)), ar.f(x), ar.f(np.eye(30) * 1e-6), t, t)
    vmap = VoxelMap(cfg.map, ar)
    p_b = ar.f(inputs.first_frame_points(cfg.s, first_scan))
    p_i = ar.mm(p_b, cfg.ext_R.T) + cfg.ext_t
    p_w = ar.mm(p_i, f.R.T) + f.x[POS]
    R = np.broadcast_to(f.R, (len(p_b), 3, 3))
    _, var = world_cov(ar, cfg, p_b, p_i, R, f.P[0:3, 0:3], f.P[3:6, 3:6], cross_on=p_b)
    insert_all_levels(cfg, vmap, p_w, var)
    return f, vmap, float(cfg.s["gravity"]) / an


def insert_all_levels(cfg: Cfg, vmap: VoxelMap, p_w, var) -> int:
    L, n = cfg.map.levels, len(p_w)
    lv = np.repeat(np.arange(L), n)
    keys = np.concatenate([np.floor(p_w / cfg.map.sizes[l]).astype(np.int64) for l in range(L)])
    return vmap.insert(lv, keys, np.tile(p_w, (L, 1)), np.tile(var, (L, 1, 1)))


def match_poses(ar: Arith, f: Filter, pkt: inputs.Packet, g_an: float):
    """Each bucket's match pose [(R, t)] from the scan-start state."""
    R, p, v = f.R, f.x[POS], f.x[VEL]
    w, a = f.x[RATE], f.x[ACC]
    t_end = f.lp
    out = []

    def seg(R, p, v, dt):
        return ar.mm(R, exp_so3(ar, w * dt)), p + dt * v, v + dt * (ar.mm(R, a) + f.x[GRAV])

    for b in pkt.buckets:
        for e in b.events:
            R, p, v = seg(R, p, v, e.t - t_end)
            t_end = max(t_end, e.t)
            w, a = ar.f(e.gyr) - f.x[BW], g_an * ar.f(e.acc) - f.x[BA]
        if b.gate:
            R, p, v = seg(R, p, v, b.t - t_end)
            t_end = max(t_end, b.t)
        out.append((R, p))
    return out


class Match(NamedTuple):
    matched: np.ndarray   # [N] bool
    normal: np.ndarray
    centre: np.ndarray
    w: np.ndarray         # 1 / (measurement variance + 1e-4), 0 unmatched
    own_key: np.ndarray   # [L, N, 3]
    own_found: np.ndarray  # [L, N]
    own_plane: np.ndarray  # [L, N]


def match(ar: Arith, cfg: Cfg, vmap: VoxelMap, p_w, ws, wc, ratio: float, clamp: bool) -> Match:
    """The point-to-plane association of world points p_w [N, 3] with their
    sensor-only and full world covariances ws, wc; ``clamp`` floors the
    plane's part of sigma^2 at 0 (the per-point path)."""
    mc, t = cfg.map, vmap.t
    N, L = len(p_w), mc.levels
    chains = []
    own = ([], [], [])
    for chain in range(2):
        best = np.full(N, -np.inf)
        got = np.zeros(N, dtype=bool)
        sel_n, sel_c, sel_j = np.zeros((N, 3)), np.zeros((N, 3)), np.zeros(N)
        reach = np.ones(N, dtype=bool)
        for l in range(L):
            size = mc.sizes[l]
            key = np.floor(p_w / size).astype(np.int64)
            if chain == 1:
                rel = p_w - (key + 0.5) * size
                key = key + (rel > size / 4).astype(np.int64) - (rel < -size / 4).astype(np.int64)
            row = vmap.find(np.int64(l), key)
            found = row >= 0
            r0 = np.where(found, row, 0)
            plane = found & (t["plane"][r0] > 0.5)
            if chain == 0:
                own[0].append(key)
                own[1].append(found)
                own[2].append(plane)
            centre = (key + 0.5) * size + t["centre"][r0]
            n = t["normal"][r0]
            rel = p_w - centre
            sd = np.sum(n * rel, 1)
            dist = np.abs(sd)
            in_range = np.maximum(np.sum(rel * rel, 1) - dist * dist, 0.0) <= (mc.radius_k * t["radius"][r0]) ** 2
            J = np.concatenate([rel, -n], axis=1)
            jpj = ar.ein("ni,nij,nj->n", J, t["pv"][r0], J)
            if clamp:
                jpj = np.maximum(jpj, 0.0)
            sig = np.maximum(jpj + ar.ein("ni,nij,nj->n", n, wc, n), 1e-12)
            ok = plane & in_range & (dist < mc.sigma_num * np.sqrt(sig)) & reach
            prob = np.exp(-0.5 * dist * dist / sig) / np.sqrt(sig)
            better = ok & (prob > best)
            best = np.where(better, prob, best)
            got |= ok
            sel_n = np.where(better[:, None], n, sel_n)
            sel_c = np.where(better[:, None], centre, sel_c)
            sel_j = np.where(better, jpj, sel_j)
            reach &= found & ~plane
        chains.append((got, sel_n, sel_c, sel_j))
    (g0, n0, c0, j0), (g1, n1, c1, j1) = chains
    nbr = ~g0 & g1
    normal = np.where(nbr[:, None], n1, n0)
    centre = np.where(nbr[:, None], c1, c0)
    jpj = np.where(nbr, j1, j0)
    matched = g0 | g1
    r = ratio * (jpj + ar.ein("ni,nij,nj->n", normal, ws, normal))
    w = np.where(matched, 1.0 / (r + eskf.R_JITTER), 0.0)
    return Match(matched, ar.f(normal), ar.f(centre), ar.f(w), np.stack(own[0]),
                 np.stack(own[1]), np.stack(own[2]))


class Step(NamedTuple):
    f: Filter
    pos: np.ndarray
    n_matched: int
    overflow: tuple        # (insert rows beyond the row cap, refits beyond the budget)


def step(ar: Arith, cfg: Cfg, f: Filter, vmap: VoxelMap, pkt: inputs.Packet, noise: Noise) -> Step:
    """One scan (module doc).  ``vmap`` is updated in place."""
    f = f._replace(lp=f.lp - pkt.rebase, lu=f.lu - pkt.rebase)
    poses = match_poses(ar, f, pkt, noise.g_an)
    sizes = [len(b.points) for b in pkt.buckets]
    bidx = np.repeat(np.arange(len(sizes)), sizes)
    p_b = ar.f(np.concatenate([b.points for b in pkt.buckets])) if sizes else np.zeros((0, 3))
    if cfg.fused and max(cfg.match_cap, cfg.insert_cap):
        cap = max(cfg.match_cap, cfg.insert_cap)
        p_b, bidx = p_b[:cap], bidx[:cap]
    n_match = min(len(bidx), cfg.match_cap) if cfg.match_cap and not cfg.fused else len(bidx)
    p_i = ar.mm(p_b, cfg.ext_R.T) + cfg.ext_t
    Rb = np.stack([poses[b][0] for b in bidx]) if len(bidx) else np.zeros((0, 3, 3))
    tb = np.stack([poses[b][1] for b in bidx]) if len(bidx) else np.zeros((0, 3))
    p_w = ar.ein("nij,nj->ni", Rb, p_i) + tb
    ws, wc = world_cov(ar, cfg, p_b, p_i, Rb, f.P[0:3, 0:3], f.P[3:6, 3:6])
    m = match(ar, cfg, vmap, p_w[:n_match], ws[:n_match], wc[:n_match], noise.ratio,
              clamp=not cfg.fused)
    matched = np.zeros(len(bidx), dtype=bool)
    matched[:n_match] = m.matched

    after = []
    n_matched = 0
    for b, bucket in enumerate(pkt.buckets):
        for e in bucket.events:
            f = eskf.predict(ar, f, noise.q, e.t)
            if cfg.kin:
                f = eskf.kin_update(ar, f, noise, e.acc, e.gyr, e.foot_pos, e.foot_vel, e.contact)
            else:
                f = eskf.imu_update(ar, f, noise, e.acc, e.gyr)
            f = f._replace(lu=e.t)
        if bucket.gate:
            f = eskf.predict(ar, f, noise.q, bucket.t)
        mine = np.nonzero((bidx == b) & matched)[0]
        if len(mine):
            f = eskf.point_update(ar, f, p_i[mine], m.normal[mine], m.centre[mine], m.w[mine])
            f = f._replace(lu=bucket.t)
        n_matched += len(mine)
        after.append((f.R, f.x[POS].copy(), f.P[0:3, 0:3].copy(), f.P[3:6, 3:6].copy()))

    # The insert, at the updated bucket poses.
    L = cfg.map.levels
    if cfg.fused:
        n = len(bidx)
        gate = np.ones(n, dtype=bool)
        rows_p, rows_l = [], []
        for l in range(L):
            rows_p.append(np.nonzero(gate)[0])
            rows_l.append(np.full(int(gate.sum()), l))
            gate = gate & m.own_found[l] & ~m.own_plane[l]
        rp, rl = np.concatenate(rows_p), np.concatenate(rows_l)
        over_rows = max(0, len(rp) - cfg.map.row_cap) if cfg.map.row_cap else 0
        if cfg.map.row_cap:
            rp, rl = rp[: cfg.map.row_cap], rl[: cfg.map.row_cap]
        keys = m.own_key[rl, rp]
    else:
        rp = np.arange(min(len(bidx), cfg.insert_cap) if cfg.insert_cap else len(bidx))
        over_rows = 0
    Ra = np.stack([after[b][0] for b in bidx[rp]]) if len(rp) else np.zeros((0, 3, 3))
    ta = np.stack([after[b][1] for b in bidx[rp]]) if len(rp) else np.zeros((0, 3))
    Prr = np.stack([after[b][2] for b in bidx[rp]]) if len(rp) else np.zeros((0, 3, 3))
    Ppp = np.stack([after[b][3] for b in bidx[rp]]) if len(rp) else np.zeros((0, 3, 3))
    pw2 = ar.ein("nij,nj->ni", Ra, p_i[rp]) + ta
    _, var2 = world_cov(ar, cfg, p_b[rp], p_i[rp], Ra, Prr, Ppp)
    if cfg.fused:
        over_fit = vmap.insert(rl, keys, pw2, var2)
    else:
        over_fit = insert_all_levels(cfg, vmap, pw2, var2)
    f = f._replace(P=(0.5 * (f.P + f.P.T)).astype(ar.dt))
    return Step(f, f.x[POS].copy(), n_matched, (over_rows, over_fit))
