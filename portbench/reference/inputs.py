"""What a replica starts from, worked out from the raw scans and events.

A scan becomes a packet as the upstream's preprocessing and
synchronisation make one (lidar_processing.cc:25-108,
ros_interface.cc:271-332, KILO.cc:356-390), at the configuration's bucket
size: every ``filter_num``-th point beyond the blind radius; each point's
time rounded to the bucket quantum; a centroid voxel grid
(``voxel_grid_resolution``) that averages the points and their times,
the voxels in key order; times rounded again; the points in time order,
grouped by time into at most ``tpu_max_buckets`` buckets of at most
``tpu_max_points_per_bucket`` points.  An event goes before the first
bucket later than it, at most ``tpu_max_imu_per_bucket`` a bucket; events
after the last bucket are dropped.  The host steps run in float32, as the
sensor data are float32: the same data give the same buckets.

The first frame: the state from the first packet's mean IMU sample, the
map from its scan's decimated points, up to 8,192.  Each replica's
process noise is scaled by exp(scale z), z drawn by a CPU
``torch.Generator`` from the trial's seed.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from .eskf import Noise

FIRST_FRAME_POINTS = 8192


class Event(NamedTuple):
    t: float               # seconds from the scan's start (float32)
    acc: np.ndarray
    gyr: np.ndarray
    foot_pos: Optional[np.ndarray]
    foot_vel: Optional[np.ndarray]
    contact: Optional[np.ndarray]


class Bucket(NamedTuple):
    t: float               # seconds from the scan's start (float32)
    points: np.ndarray     # [n, 3] LiDAR frame, float32
    events: List[Event]    # before the bucket, in time order
    gate: bool = True      # False: the events alone (an event-only packet)


class Packet(NamedTuple):
    rebase: float          # this scan's start less the previous one's
    end_offset: float
    buckets: List[Bucket]


def decimate(points, toff, filter_num: int, blind: float):
    keep = np.zeros(len(points), dtype=bool)
    keep[::filter_num] = True
    keep &= np.einsum("ij,ij->i", points, points) > blind * blind
    return points[keep], toff[keep]


def _round_to(t, quantum: float):
    inv = 1.0 / quantum
    return np.floor(t * inv + 0.5) / inv


def scan_buckets(s: dict, points, toff) -> List[tuple]:
    """[(time, points [n, 3])] of one scan."""
    q = float(s["tpu_bucket_quantum_ms"]) * 1e-3
    pts, t = decimate(points, toff, int(s["filter_num"]), float(s["blind"]))
    t = _round_to(t, q)
    leaf = float(s["voxel_grid_resolution"])
    if len(pts):
        k = np.floor(pts / leaf).astype(np.int64)
        order = np.lexsort((k[:, 2], k[:, 1], k[:, 0]))
        k = k[order]
        first = np.ones(len(k), dtype=bool)
        first[1:] = (k[1:] != k[:-1]).any(1)
        grp = np.cumsum(first) - 1
        cols = np.concatenate([pts[order], t[order][:, None]], axis=1)
        sums = np.zeros((int(grp[-1]) + 1, 4))
        np.add.at(sums, grp, cols)
        cent = (sums / np.bincount(grp)[:, None]).astype(np.float32)
        pts, t = cent[:, 0:3], cent[:, 3]
    if bool(s.get("tpu_requantize_buckets", True)):
        t = _round_to(t, q)
    order = np.argsort(t, kind="stable")
    pts, t = pts[order], t[order]
    times, start = np.unique(t, return_index=True)
    nb, pmax = int(s["tpu_max_buckets"]), int(s["tpu_max_points_per_bucket"])
    ends = np.append(start[1:], len(t))
    return [(times[i], pts[start[i]:min(ends[i], start[i] + pmax)])
            for i in range(min(len(times), nb))]


def _event(e, t0: float, kin: bool) -> Event:
    return Event(float(np.float32(e.time - t0)),
                 np.asarray(e.acc, np.float32).astype(np.float64),
                 np.asarray(e.gyr, np.float32).astype(np.float64),
                 np.asarray(e.foot_pos, np.float32).astype(np.float64) if kin else None,
                 np.asarray(e.foot_vel, np.float32).astype(np.float64) if kin else None,
                 np.asarray(e.contact, bool) if kin else None)


def packets(s: dict, scans, events) -> List[Packet]:
    """The packets of the scans, each scan's events those not taken by an
    earlier packet up to the scan's end.  Where as many events as a
    bucket holds (or more) wait before a scan's start, they go first in a
    packet of their own, a bucket's worth of them a bucket, no points."""
    kin = not bool(s["only_imu_use"])
    nb, kmax = int(s["tpu_max_buckets"]), int(s["tpu_max_imu_per_bucket"])
    evs = sorted(events, key=lambda e: e.time)
    out, j, last_begin, queue = [], 0, None, []
    for scan in scans:
        while j < len(evs) and evs[j].time <= scan.end_time:
            queue.append(evs[j])
            j += 1
        while last_begin is not None:
            n_pre = next((i for i, e in enumerate(queue) if e.time > scan.begin_time), len(queue))
            if n_pre < kmax:
                break
            batch, queue = queue[:min(n_pre, nb * kmax)], queue[min(n_pre, nb * kmax):]
            t0 = batch[0].time
            out.append(Packet(
                float(np.float32(t0 - last_begin)), float(np.float32(batch[-1].time - t0)),
                [Bucket(0.0, np.zeros((0, 3), np.float32),
                        [_event(e, t0, kin) for e in batch[i: i + kmax]], gate=False)
                 for i in range(0, len(batch), kmax)]))
            last_begin = t0
        mine, queue = queue, []
        bk = scan_buckets(s, scan.points, scan.time_offset)
        abs_t = scan.begin_time + np.asarray([b[0] for b in bk], dtype=np.float32)
        slots: List[List[Event]] = [[] for _ in bk]
        for e in mine:
            i = int(np.searchsorted(abs_t, e.time, side="right"))
            if i < len(bk) and len(slots[i]) < kmax:
                slots[i].append(_event(e, scan.begin_time, kin))
        rebase = 0.0 if last_begin is None else scan.begin_time - last_begin
        out.append(Packet(float(np.float32(rebase)),
                          float(np.float32(scan.end_time - scan.begin_time)),
                          [Bucket(float(t), p, ev) for (t, p), ev in zip(bk, slots)]))
        last_begin = scan.begin_time
    return out


def first_frame_points(s: dict, scan) -> np.ndarray:
    return decimate(scan.points, scan.time_offset, int(s["filter_num"]),
                    float(s["blind"]))[0][:FIRST_FRAME_POINTS]


def first_imu_mean(pkt: Packet):
    """Mean acc and gyr over the first packet's events."""
    evs = [e for b in pkt.buckets for e in b.events]
    acc = np.mean(np.stack([np.asarray(e.acc, np.float32) for e in evs]), axis=0, dtype=np.float32)
    gyr = np.mean(np.stack([np.asarray(e.gyr, np.float32) for e in evs]), axis=0, dtype=np.float32)
    return acc.astype(np.float64), gyr.astype(np.float64)


def base_noise(s: dict, g_an: float) -> Noise:
    """The process noise diagonal (the upstream's initProcessCovQ, in error
    state order) and the measurement noises."""
    q = np.zeros(30)
    q[6:9] = s["vel_process_cov"]
    q[9:12] = s["acc_bias_process_cov"]
    q[12:15] = s["gyr_bias_process_cov"]
    q[18:21] = s["imu_acc_process_cov"]
    q[21:24] = s["imu_gyr_process_cov"]
    q[24:27] = s["kin_bias_process_cov"]
    q[27:30] = s["contact_process_cov"]
    r = [s["imu_acc_meas_noise"]] * 2 + [s["imu_acc_z_meas_noise"]] + [s["imu_gyr_meas_noise"]] * 3
    return Noise(q=q, imu_r=np.asarray(r, dtype=np.float64), kin_r=float(s["kin_meas_noise"]),
                 ratio=float(s["lidar_point_meas_ratio"]), g_an=float(g_an))


def jitter(batch: int, scale: float, seed: int) -> np.ndarray:
    """Each replica's process-noise factor exp(scale z) [batch]."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    z = torch.randn((batch, 1), generator=gen, dtype=torch.float32)[:, 0].numpy()
    return np.exp(scale * z.astype(np.float64))


def replica_noise(base: Noise, factor: float) -> Noise:
    return base._replace(q=base.q * factor)
