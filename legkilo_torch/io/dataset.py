"""Host-side scan preprocessing: raw sensor streams -> fixed-shape ScanPackets.

The port's own copy of ``legkilo_tpu/io/dataset.py`` (numpy only).  It
replaces the reference's LidarProcessing decimation/blind filter/time
quantization (lidar_processing.cc:25-108), RosInterface::syncPackage
time-sync packing (ros_interface.cc:271-332) and pcl::VoxelGrid downsampling
(KILO.cc:356-360) with a NumPy pipeline that emits statically-shaped,
padded packets.  Where the JAX package does (``tpu_use_native`` on and 2 ms
buckets), the packetizer builds the points of a packet with the committed
C++ library native/libscanprep.so (io/native.py); otherwise, when the
library cannot be loaded, or when it would key a point's leaf cell apart
from numpy (``native_keys_agree``: one scan in a hundred), with numpy.
``PacketBuilder.packetizer`` records which one built the last scan packet.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config

log = logging.getLogger(__name__)

TIME_QUANTUM = 1.0 / 500.0  # 2 ms buckets (lidar_processing.cc:48)


@dataclasses.dataclass
class RawScan:
    """Decoded LiDAR scan: body-frame points + per-point time offsets."""

    begin_time: float            # absolute seconds
    end_time: float
    points: np.ndarray           # [N, 3] float32
    time_offset: np.ndarray      # [N] float32, seconds since begin_time
    intensity: Optional[np.ndarray] = None


@dataclasses.dataclass
class ImuEvent:
    time: float
    acc: np.ndarray              # [3]
    gyr: np.ndarray              # [3]


@dataclasses.dataclass
class KinImuEvent:
    """KinImuMeas analog (sensor_types.hpp:19-26)."""

    time: float
    acc: np.ndarray              # [3]
    gyr: np.ndarray              # [3]
    foot_pos: np.ndarray         # [4, 3]
    foot_vel: np.ndarray         # [4, 3]
    contact: np.ndarray          # [4] bool


@dataclasses.dataclass
class HostPacket:
    """Numpy mirror of filter.ScanPacket plus host metadata."""

    begin_time: float
    end_time: float
    rebase: float
    end_offset: float
    bucket_time: np.ndarray      # [NB]
    bucket_mask: np.ndarray      # [NB]
    points: np.ndarray           # [NB, P, 3]
    point_mask: np.ndarray       # [NB, P]
    imu_time: np.ndarray         # [NB, K]
    imu_mask: np.ndarray         # [NB, K]
    imu_acc: np.ndarray          # [NB, K, 3]
    imu_gyr: np.ndarray          # [NB, K, 3]
    foot_pos: np.ndarray         # [NB, K, 4, 3]
    foot_vel: np.ndarray         # [NB, K, 4, 3]
    contact: np.ndarray          # [NB, K, 4]
    n_raw: int = 0               # raw cloud size (for logging parity)
    dropped_points: int = 0      # overflow diagnostics
    dropped_events: int = 0
    # [NB, P] per-point intensity (host-side only: the filter never reads
    # it; the PCD export pairs it with the world cloud — pcd_saver.hpp /
    # PointXYZINormal parity, lidar_processing.cc:46).
    intensity: Optional[np.ndarray] = None


def decimate_blind(
    points: np.ndarray, time_offset: np.ndarray, filter_num: int, blind: float,
    intensity: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """1/filter_num decimation + blind-radius removal
    (lidar_processing.cc:40-41, blindCheck lidar_processing.h:95-98).

    Intensity (when present) rides along like the reference's
    PointXYZINormal carries it (lidar_processing.cc:46)."""
    n = len(points)
    keep = np.zeros(n, dtype=bool)
    keep[::filter_num] = True
    keep &= np.einsum("ij,ij->i", points, points) > blind * blind
    return (
        points[keep],
        time_offset[keep],
        intensity[keep] if intensity is not None else None,
    )


def quantize_times(
    time_offset: np.ndarray, quantum: float = TIME_QUANTUM
) -> np.ndarray:
    """Per-point time quantization: round(t/quantum)*quantum; the reference
    hardcodes quantum = 2 ms (lidar_processing.cc:48).

    Uses half-away-from-zero rounding (C++ std::round semantics; time
    offsets are non-negative so floor(x + 0.5) is equivalent) — NOT numpy's
    banker's rounding — to stay bit-compatible with the native library.
    """
    inv = 1.0 / quantum
    return np.floor(time_offset * inv + 0.5) / inv


def voxel_downsample(
    points: np.ndarray, time_offset: np.ndarray, leaf: float,
    intensity: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Centroid voxel-grid downsample, averaging positions AND times (and
    intensity when present).

    Parity: pcl::VoxelGrid with downsample_all_data (KILO.cc:356-360) — the
    centroid's time/intensity is the mean member value, which is why bucket
    times must be re-quantized afterwards (see build_packet)."""
    if len(points) == 0:
        return points, time_offset, intensity
    keys = np.floor(points / leaf).astype(np.int64)
    # Pack 3 x int21 into one int64 for fast unique.
    packed = (
        (keys[:, 0] + (1 << 20)) << 42
        | (keys[:, 1] + (1 << 20)) << 21
        | (keys[:, 2] + (1 << 20))
    )
    uniq, inv = np.unique(packed, return_inverse=True)
    m = len(uniq)
    cols = [points, time_offset[:, None]]
    if intensity is not None:
        cols.append(intensity[:, None])
    w = np.concatenate(cols, axis=1)
    sums = np.zeros((m, w.shape[1]))
    np.add.at(sums, inv, w)
    counts = np.bincount(inv, minlength=m).astype(np.float64)
    cent = sums / counts[:, None]
    return (
        cent[:, 0:3].astype(np.float32),
        cent[:, 3].astype(np.float32),
        cent[:, 4].astype(np.float32) if intensity is not None else None,
    )


def native_keys_agree(points: np.ndarray, time_offset: np.ndarray, filter_num: int,
                      blind: float, leaf: float) -> bool:
    """Whether native/libscanprep.so puts every point the scan keeps in the
    leaf cell ``voxel_downsample`` puts it in.  The library floors the
    float64 product with 1 / leaf, numpy the float32 quotient: a point
    within a float32 rounding of a cell boundary (about one scan in a
    hundred of 8,000 sim points at a 0.3 m leaf) lands in neighbouring
    cells, and two centroids move by centimetres."""
    pts, _, _ = decimate_blind(points, time_offset, filter_num, blind)
    inv = 1.0 / float(np.float32(leaf))  # the library's float leaf, inverted in double
    return np.array_equal(np.floor(pts / leaf), np.floor(pts.astype(np.float64) * inv))


class PacketBuilder:
    """Streaming packetizer: feed scans + IMU/kin events, pull HostPackets.

    Mirrors syncPackage's lock-step policy (ros_interface.cc:271-332): a scan
    is released only once the IMU/kin stream has passed its end time; events
    with stamps <= scan end are consumed, and events between the last bucket
    and the scan end are dropped (the reference drops them with the copied
    MeasGroup deque)."""

    def __init__(self, cfg: Config, use_kin: Optional[bool] = None):
        self.cfg = cfg
        self.use_kin = (not cfg.only_imu_use) if use_kin is None else use_kin
        self.nb = cfg.tpu.max_buckets
        self.pmax = cfg.tpu.max_points_per_bucket
        self.kmax = cfg.tpu.max_imu_per_bucket
        self._scans: List[RawScan] = []
        self._events: List = []
        self._last_event_time = -np.inf
        self._last_begin: Optional[float] = None
        self._last_scan_time = -np.inf
        self.packetizer: Optional[str] = None  # "native" or "numpy", last scan packet

    def add_scan(self, scan: RawScan) -> None:
        # A scan entirely in the already-emitted past is unusable (its
        # events were consumed with earlier packets); the reference would
        # clear-and-process it with negative dt (ros_interface.cc:175-182
        # only clears the queue) — we reject it outright instead
        # (tests/test_robustness.py backward-jump scenario).
        if self._last_begin is not None and scan.end_time <= self._last_begin:
            log.warning(
                "stale scan rejected: end %.3f <= last emitted begin %.3f",
                scan.end_time, self._last_begin,
            )
            return
        # Monotonicity check with cache clear (ros_interface.cc:175-182).
        if scan.begin_time < self._last_scan_time:
            self._scans.clear()
        self._last_scan_time = scan.begin_time
        self._scans.append(scan)

    def add_imu(self, ev: ImuEvent) -> None:
        if self.use_kin:
            return
        # A single non-finite sample (sensor glitch, truncated message)
        # would poison the filter state permanently; drop it here.  The
        # reference has no such guard (raw msg fields go straight into
        # the deques, ros_interface.cc:194-219).
        if not (np.isfinite(ev.time) and np.isfinite(ev.acc).all()
                and np.isfinite(ev.gyr).all()):
            log.warning("non-finite IMU sample at t=%r dropped", ev.time)
            return
        if ev.time < self._last_event_time:
            self._events.clear()
        self._last_event_time = ev.time
        self._events.append(ev)

    def add_kin_imu(self, ev: KinImuEvent) -> None:
        if not self.use_kin:
            return
        if not (np.isfinite(ev.time) and np.isfinite(ev.acc).all()
                and np.isfinite(ev.gyr).all()
                and np.isfinite(ev.foot_pos).all()
                and np.isfinite(ev.foot_vel).all()):
            log.warning("non-finite kin sample at t=%r dropped", ev.time)
            return
        if ev.time < self._last_event_time:
            self._events.clear()
        self._last_event_time = ev.time
        self._events.append(ev)

    def ready(self) -> bool:
        return bool(self._scans) and self._last_event_time >= self._scans[0].end_time

    def pop(self) -> Optional[HostPacket]:
        """Emit the next packet if the event stream has caught up.

        A sensor gap (dropped scans, IMU dropout then resume, a bag
        splice) can queue far more events before the next scan's first
        bucket than the packet's ``kmax`` bucket-0 slots hold.  The
        reference's MeasGroup carries an unbounded IMU deque and
        KILO.cc:380-390 processes every queued event before the first
        bucket; dropping them here instead latches stale imu_a/imu_w
        across the gap and measurably diverges the filter
        (tests/test_robustness.py).  So excess pre-scan events spill
        into event-only packets (all point buckets masked) that run
        through the same device program ahead of the scan packet.
        """
        if not self.ready():
            return None
        scan = self._scans[0]
        if self._last_begin is not None:
            # _events is time-sorted (regressions clear the cache), so the
            # pre-scan events are a prefix.
            n_pre = 0
            for e in self._events:
                if e.time > scan.begin_time:
                    break
                n_pre += 1
            # Spill when the pre-scan backlog would leave bucket 0 no
            # headroom: bucket-0's kmax slots must also hold the scan's own
            # first-bucket events, so n_pre == kmax (not just > kmax) already
            # overflows whenever bucket 0 is non-empty.  >= keeps the scan
            # packet's bucket 0 entirely free for in-window events.
            if n_pre >= self.kmax:
                batch = self._events[: min(n_pre, self.nb * self.kmax)]
                self._events = self._events[len(batch):]
                return self._build_event_packet(batch)
        scan = self._scans.pop(0)
        events = [e for e in self._events if e.time <= scan.end_time]
        self._events = [e for e in self._events if e.time > scan.end_time]
        pkt = self.build_packet(scan, events)
        self._last_begin = scan.begin_time
        return pkt

    def _build_event_packet(self, events: Sequence) -> HostPacket:
        """Event-only HostPacket: buckets all masked, events packed in time
        order across the [nb, kmax] slots (the chain consumes bucket i's
        slots before bucket i, so sequential fill preserves order)."""
        t0 = float(events[0].time)
        imu_time = np.zeros((self.nb, self.kmax), dtype=np.float32)
        imu_mask = np.zeros((self.nb, self.kmax), dtype=bool)
        imu_acc = np.zeros((self.nb, self.kmax, 3), dtype=np.float32)
        imu_gyr = np.zeros((self.nb, self.kmax, 3), dtype=np.float32)
        foot_pos = np.zeros((self.nb, self.kmax, 4, 3), dtype=np.float32)
        foot_vel = np.zeros((self.nb, self.kmax, 4, 3), dtype=np.float32)
        contact = np.zeros((self.nb, self.kmax, 4), dtype=bool)
        for idx, ev in enumerate(events):
            i, k = divmod(idx, self.kmax)
            imu_time[i, k] = ev.time - t0
            imu_mask[i, k] = True
            imu_acc[i, k] = ev.acc
            imu_gyr[i, k] = ev.gyr
            if self.use_kin:
                foot_pos[i, k] = ev.foot_pos
                foot_vel[i, k] = ev.foot_vel
                contact[i, k] = ev.contact
        rebase = t0 - self._last_begin
        self._last_begin = t0
        end = float(events[-1].time)
        return HostPacket(
            begin_time=t0,
            end_time=end,
            rebase=float(rebase),
            end_offset=end - t0,
            bucket_time=np.zeros(self.nb, dtype=np.float32),
            bucket_mask=np.zeros(self.nb, dtype=bool),
            points=np.zeros((self.nb, self.pmax, 3), dtype=np.float32),
            point_mask=np.zeros((self.nb, self.pmax), dtype=bool),
            imu_time=imu_time,
            imu_mask=imu_mask,
            imu_acc=imu_acc,
            imu_gyr=imu_gyr,
            foot_pos=foot_pos,
            foot_vel=foot_vel,
            contact=contact,
            n_raw=0,
        )

    def _bucketize(self, scan: RawScan, quantum: float):
        """The numpy path: decimate, quantize, downsample and pack the
        scan's points into time buckets.  Returns (bucket_time,
        bucket_mask, points, point_mask, dropped_points, intensity,
        n_buckets), as native.process_scan's outputs."""
        cfg = self.cfg
        pts, toff, inten = decimate_blind(
            scan.points, scan.time_offset, cfg.lidar.filter_num,
            cfg.lidar.blind, intensity=scan.intensity,
        )
        toff = quantize_times(toff, quantum)
        pts, toff, inten = voxel_downsample(
            pts, toff, cfg.lidar.voxel_grid_resolution, inten
        )
        if cfg.tpu.requantize_buckets:
            # Snap averaged centroid times back to the bucket grid so the
            # bucket count stays ~scan_duration/quantum instead of
            # exploding into singletons (SURVEY.md §3.3).
            toff = quantize_times(toff, quantum)

        order = np.argsort(toff, kind="stable")
        pts, toff = pts[order], toff[order]
        if inten is not None:
            inten = inten[order]
        b_times, b_start = np.unique(toff, return_index=True)
        n_buckets = len(b_times)
        dropped_points = 0
        if n_buckets > self.nb:
            # Keep the first nb buckets; count the dropped tail.
            cut = b_start[self.nb]
            dropped_points += len(pts) - cut
            pts, toff = pts[:cut], toff[:cut]
            if inten is not None:
                inten = inten[:cut]
            b_times, b_start = b_times[: self.nb], b_start[: self.nb]
            n_buckets = self.nb
        b_end = np.append(b_start[1:], len(pts))

        points = np.zeros((self.nb, self.pmax, 3), dtype=np.float32)
        point_mask = np.zeros((self.nb, self.pmax), dtype=bool)
        bucket_time = np.zeros(self.nb, dtype=np.float32)
        bucket_mask = np.zeros(self.nb, dtype=bool)
        intens = (
            np.zeros((self.nb, self.pmax), dtype=np.float32)
            if inten is not None else None
        )
        for i in range(n_buckets):
            s, e = b_start[i], b_end[i]
            cnt = e - s
            if cnt > self.pmax:
                dropped_points += cnt - self.pmax
                cnt = self.pmax
            points[i, :cnt] = pts[s : s + cnt]
            if intens is not None:
                intens[i, :cnt] = inten[s : s + cnt]
            point_mask[i, :cnt] = True
            bucket_time[i] = b_times[i]
            bucket_mask[i] = True
        return bucket_time, bucket_mask, points, point_mask, dropped_points, intens, n_buckets

    def build_packet(self, scan: RawScan, events: Sequence) -> HostPacket:
        cfg = self.cfg
        quantum = cfg.tpu.bucket_quantum_ms * 1e-3
        native_out = None
        # The native library hardcodes the reference's 2 ms quantum; any
        # other bucket size takes the numpy path, and so does a scan whose
        # leaf cells the library would key apart from numpy.
        if (cfg.tpu.use_native and abs(quantum - TIME_QUANTUM) < 1e-9
                and native_keys_agree(scan.points, scan.time_offset, cfg.lidar.filter_num,
                                      cfg.lidar.blind, cfg.lidar.voxel_grid_resolution)):
            from . import native

            native_out = native.process_scan(
                scan.points, scan.time_offset,
                cfg.lidar.filter_num, cfg.lidar.blind,
                cfg.lidar.voxel_grid_resolution, cfg.tpu.requantize_buckets,
                self.nb, self.pmax, intensity=scan.intensity,
            )
        if native_out is not None:
            self.packetizer = "native"
            (bucket_time, bucket_mask, points, point_mask, _, dropped_points,
             intens) = native_out
            n_buckets = int(bucket_mask.sum())
        else:
            self.packetizer = "numpy"
            (bucket_time, bucket_mask, points, point_mask, dropped_points,
             intens, n_buckets) = self._bucketize(scan, quantum)

        # Assign events: an event goes before the first bucket whose absolute
        # time exceeds it (KILO.cc:380-390); events at/after the last bucket
        # time are dropped.
        imu_time = np.zeros((self.nb, self.kmax), dtype=np.float32)
        imu_mask = np.zeros((self.nb, self.kmax), dtype=bool)
        imu_acc = np.zeros((self.nb, self.kmax, 3), dtype=np.float32)
        imu_gyr = np.zeros((self.nb, self.kmax, 3), dtype=np.float32)
        foot_pos = np.zeros((self.nb, self.kmax, 4, 3), dtype=np.float32)
        foot_vel = np.zeros((self.nb, self.kmax, 4, 3), dtype=np.float32)
        contact = np.zeros((self.nb, self.kmax, 4), dtype=bool)
        dropped_events = 0
        fill = np.zeros(self.nb, dtype=np.int64)
        abs_bucket = scan.begin_time + bucket_time
        for ev in events:
            i = int(np.searchsorted(abs_bucket[:n_buckets], ev.time, side="right"))
            if i >= n_buckets:
                dropped_events += 1  # after last bucket: dropped (see class doc)
                continue
            k = fill[i]
            if k >= self.kmax:
                dropped_events += 1
                continue
            fill[i] += 1
            imu_time[i, k] = ev.time - scan.begin_time
            imu_mask[i, k] = True
            imu_acc[i, k] = ev.acc
            imu_gyr[i, k] = ev.gyr
            if self.use_kin:
                foot_pos[i, k] = ev.foot_pos
                foot_vel[i, k] = ev.foot_vel
                contact[i, k] = ev.contact

        rebase = 0.0 if self._last_begin is None else scan.begin_time - self._last_begin
        return HostPacket(
            begin_time=scan.begin_time,
            end_time=scan.end_time,
            rebase=float(rebase),
            end_offset=float(scan.end_time - scan.begin_time),
            bucket_time=bucket_time,
            bucket_mask=bucket_mask,
            points=points,
            point_mask=point_mask,
            imu_time=imu_time,
            imu_mask=imu_mask,
            imu_acc=imu_acc,
            imu_gyr=imu_gyr,
            foot_pos=foot_pos,
            foot_vel=foot_vel,
            contact=contact,
            n_raw=len(scan.points),
            dropped_points=int(dropped_points),
            dropped_events=int(dropped_events),
            intensity=intens,
        )


def to_device_packet(pkt: HostPacket, device):
    """HostPacket -> filter.ScanPacket of tensors on ``device``."""
    import torch

    from ..core.filter import ScanPacket

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    return ScanPacket(
        rebase=torch.tensor(pkt.rebase, dtype=torch.float32, device=device),
        end_offset=torch.tensor(pkt.end_offset, dtype=torch.float32, device=device),
        bucket_time=t(pkt.bucket_time),
        bucket_mask=t(pkt.bucket_mask),
        points=t(pkt.points),
        point_mask=t(pkt.point_mask),
        imu_time=t(pkt.imu_time),
        imu_mask=t(pkt.imu_mask),
        imu_acc=t(pkt.imu_acc),
        imu_gyr=t(pkt.imu_gyr),
        foot_pos=t(pkt.foot_pos),
        foot_vel=t(pkt.foot_vel),
        contact=t(pkt.contact),
    )


def first_packet_imu_stats(events: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Mean acc and gyr over the first packet's events (StateInitial,
    state_initial.hpp:34-72)."""
    accs = np.stack([e.acc for e in events])
    gyrs = np.stack([e.gyr for e in events])
    return accs.mean(axis=0), gyrs.mean(axis=0)
