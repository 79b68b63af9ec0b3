"""Odometry runner: host orchestration of the per-scan filter (subset of legkilo_tpu/runner.py).

Sensor streams -> PacketBuilder -> ``process_scan_any`` (the deferred
pipeline: the fused path, on the port's kernels where their switches are
on, or the per-point path with ``tpu_chain_impl: jax``; or the sequential
pipeline) -> trajectory and, with ``return_cloud``, each scan's registered
world cloud.  Covers streaming replay with pipelined
materialisation (up to ``tpu_pipeline_depth`` scans in flight: the card
runs scan k while the host builds scan k+1), the auto-escalation latch for
iterated matching (deferred pipeline only, as in the JAX runner), the
match-collapse alarm, the sensor-gap soft reset,
checkpoint save/load at a scan boundary (io/checkpoint.py, the JAX package's
file format) and chunked offline replay (``run_offline(chunk=K)``: K staged
scans a call through ``process_scan_chunk``, one host read a chunk, no
escalation latch).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .config import Config
from .core.eskf import make_noise_params
from .core.filter import (
    FilterParams,
    StaticConfig,
    first_frame_map,
    init_carry,
    init_state_from_imu,
    process_scan_any,
    process_scan_chunk,
    soft_reset_carry,
    stack_scan_packets,
)
from .core.filter_deferred import check_supported
from .core.voxel_map import map_config_from
from .io import checkpoint as ckpt
from .io.dataset import (
    HostPacket,
    ImuEvent,
    KinImuEvent,
    PacketBuilder,
    RawScan,
    decimate_blind,
    to_device_packet,
)

log = logging.getLogger(__name__)

_FIRST_FRAME_PAD = 8192


@dataclasses.dataclass
class ScanResult:
    time: float
    rot: np.ndarray
    pos: np.ndarray
    n_matched: int
    n_points: int
    n_raw: int
    cloud_world: Optional[np.ndarray] = None  # [M, 3] valid points only
    intensity: Optional[np.ndarray] = None    # [M] aligned with cloud_world


def bench_config() -> Config:
    """The workload of bench.py:55-129: the deferred pipeline with all five
    kernel switches on (chain, match, insert, pose, refit)."""
    cfg = Config()
    cfg.only_imu_use = True
    cfg.lidar.filter_num = 1
    cfg.lidar.blind = 0.3
    cfg.lidar.voxel_grid_resolution = 0.3
    cfg.voxel_map.capacity_log2 = 14
    cfg.voxel_map.insert_rounds = 1
    cfg.voxel_map.insert_row_cap = 4096
    cfg.voxel_map.refit_budget = 1024
    cfg.voxel_map.probe_length = 4
    cfg.tpu.bucket_quantum_ms = 4.0
    cfg.tpu.max_buckets = 28
    cfg.tpu.max_points_per_bucket = 256
    cfg.tpu.max_imu_per_bucket = 1
    cfg.tpu.insert_cap = 3584
    cfg.tpu.match_cap = 3584
    cfg.tpu.pipeline = "deferred"
    cfg.tpu.use_pallas = True
    cfg.tpu.use_pallas_match = True
    cfg.tpu.use_pallas_insert = True
    cfg.tpu.use_pallas_pose = True
    cfg.tpu.use_pallas_refit = True
    return cfg


def bench_config_points() -> Config:
    """bench.py's workload on the per-point path: ``chain_impl="jax"`` (match
    rows in bucket layout, the per-point chain kernel, the claiming insert)
    with the pose and refit kernels on.  The chain, match and insert
    switches stay as bench.py sets them; that path does not read them."""
    cfg = bench_config()
    cfg.tpu.chain_impl = "jax"
    return cfg


def make_static_config(cfg: Config, use_kin=None, return_cloud: bool = False) -> StaticConfig:
    """StaticConfig from a full Config."""
    return StaticConfig(
        map_cfg=map_config_from(cfg.voxel_map, use_pallas_refit=bool(cfg.tpu.use_pallas_refit)),
        use_kin=(not cfg.only_imu_use) if use_kin is None else bool(use_kin),
        dept_err=float(cfg.voxel_map.dept_err),
        beam_err=float(cfg.voxel_map.beam_err),
        map_sliding_en=bool(cfg.voxel_map.map_sliding_en),
        sliding_thresh=float(cfg.voxel_map.sliding_thresh),
        half_map_size=int(cfg.voxel_map.half_map_size),
        return_cloud=bool(return_cloud),
        pipeline=cfg.tpu.pipeline,
        use_pallas=bool(cfg.tpu.use_pallas),
        use_pallas_match=bool(cfg.tpu.use_pallas_match),
        use_pallas_insert=bool(cfg.tpu.use_pallas_insert),
        use_pallas_pose=bool(cfg.tpu.use_pallas_pose),
        insert_cap=max(0, int(cfg.tpu.insert_cap)),
        match_cap=max(0, int(cfg.tpu.match_cap)),
        chain_impl=cfg.tpu.chain_impl,
        insert_reuse_probe=bool(cfg.tpu.insert_reuse_probe),
        match_pose=cfg.tpu.match_pose,
        match_iters=max(1, int(cfg.tpu.match_iters)),
        symmetrize_cov=bool(cfg.tpu.symmetrize_cov),
    )


class OdometryRunner:
    """Stateful replay engine around the per-scan filter, on ``device``;
    with ``return_cloud`` each result carries its scan's world cloud."""

    def __init__(self, cfg: Config, return_cloud: bool = False, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scfg = make_static_config(cfg, return_cloud=return_cloud)
        check_supported(self.scfg, cfg.tpu.max_buckets, cfg.tpu.max_points_per_bucket)
        if cfg.tpu.dtype != "float32":
            raise NotImplementedError("legkilo_torch runs in float32 only")
        dev = self.device
        self.params = FilterParams(
            noise=make_noise_params(cfg.eskf, dev),
            ext_r=torch.tensor(np.reshape(cfg.extrinsic_R, (3, 3)), dtype=torch.float32, device=dev),
            ext_t=torch.tensor(cfg.extrinsic_T, dtype=torch.float32, device=dev),
            g_over_acc_norm=torch.tensor(1.0, device=dev),
        )
        self.builder = PacketBuilder(cfg)
        self.carry = init_carry(self.scfg, dev)
        self.initialized = False
        self.results: List[ScanResult] = []
        self.pipeline_depth = max(0, int(cfg.tpu.pipeline_depth))
        self._inflight: collections.deque = collections.deque()
        self._n_done = 0
        self._low_match_streak = 0
        esc_iters = max(0, int(cfg.tpu.match_iters_escalated))
        self._esc_ratio = float(cfg.tpu.escalate_ratio)
        self._esc_after = max(0, int(cfg.tpu.escalate_after))
        self._deesc_after = max(0, int(cfg.tpu.deescalate_after))
        self._esc_streak = 0
        self._esc_enabled = (self.scfg.pipeline == "deferred" and self._esc_after > 0
                             and esc_iters > self.scfg.match_iters)
        self._scfg_esc = self.scfg._replace(match_iters=esc_iters)
        self._scfg_active = self.scfg
        self._esc_active = False
        self._healthy_streak = 0
        self._esc_latched = False
        self._last_deesc = -(10 ** 9)

    # -- streaming input ---------------------------------------------------
    def add_scan(self, scan: RawScan) -> List[ScanResult]:
        self.builder.add_scan(scan)
        return self._drain()

    def add_imu(self, ev) -> List[ScanResult]:
        self.builder.add_imu(ev)
        return self._drain()

    def add_kin_imu(self, ev) -> List[ScanResult]:
        self.builder.add_kin_imu(ev)
        return self._drain()

    def _drain(self) -> List[ScanResult]:
        out = []
        while self.builder.ready():
            scan = self.builder._scans[0]
            pkt = self.builder.pop()
            if pkt is None:
                break
            if not self.initialized:
                out.append(self._initialize(scan, pkt))
                continue
            self._dispatch(pkt)
            while len(self._inflight) > self.pipeline_depth:
                out.append(self._materialize(*self._inflight.popleft()))
        self.results.extend(out)
        return out

    def flush(self) -> List[ScanResult]:
        """Materialize every in-flight scan (call at stream end)."""
        out = []
        while self._inflight:
            out.append(self._materialize(*self._inflight.popleft()))
        self.results.extend(out)
        return out

    # -- internals ---------------------------------------------------------
    def _initialize(self, scan: RawScan, pkt: HostPacket) -> ScanResult:
        """First-frame path (KILO.cc:332-353): state from the packet's mean
        IMU sample, map from the raw scan.  Returns the packet's result (the
        pose as it stands); a packet without events leaves the runner
        uninitialized, to be tried again with the next packet."""
        m = pkt.imu_mask
        if m.any():
            self._init_state_and_map(scan, pkt)
        else:
            log.warning("First packet has no IMU events; skipping init")
        return ScanResult(
            time=pkt.end_time,
            rot=self.carry.state.rot.cpu().numpy(),
            pos=self.carry.state.pos.cpu().numpy(),
            n_matched=0, n_points=0, n_raw=pkt.n_raw,
        )

    def _init_state_and_map(self, scan: RawScan, pkt: HostPacket) -> None:
        m = pkt.imu_mask
        dev = self.device
        mean_acc = torch.tensor(pkt.imu_acc[m].mean(axis=0), dtype=torch.float32, device=dev)
        mean_gyr = torch.tensor(pkt.imu_gyr[m].mean(axis=0), dtype=torch.float32, device=dev)
        carry, acc_norm = init_state_from_imu(
            self.carry, mean_acc, mean_gyr, float(self.cfg.gravity),
            torch.tensor(pkt.end_offset, dtype=torch.float32, device=dev),
        )
        self.params = self.params._replace(g_over_acc_norm=self.cfg.gravity / acc_norm)
        pts, _, _ = decimate_blind(
            scan.points, scan.time_offset, self.cfg.lidar.filter_num, self.cfg.lidar.blind
        )
        n = min(len(pts), _FIRST_FRAME_PAD)
        buf = np.zeros((_FIRST_FRAME_PAD, 3), dtype=np.float32)
        buf[:n] = pts[:n]
        mask = np.zeros(_FIRST_FRAME_PAD, dtype=bool)
        mask[:n] = True
        self.carry = first_frame_map(
            carry, self.scfg, self.params, torch.from_numpy(buf).to(dev), torch.from_numpy(mask).to(dev)
        )
        self.initialized = True
        g = self.carry.state.grav.cpu().numpy()
        log.info("Initialization finished: gravity=(%.3f %.3f %.3f) |acc|=%.3f",
                 g[0], g[1], g[2], float(acc_norm))

    # -- checkpoint / resume ------------------------------------------------
    def save_checkpoint(self, path: str) -> str:
        """Snapshot the resumable state at a scan boundary: the carry (state,
        covariance, clocks, voxel map) plus the host side -- the init-derived
        gravity scale, the packetizer's clocks and the events buffered past
        the last emitted scan, and the escalation latch (sticky by design,
        so a resumed run comes back escalated with its counters intact).
        Scans still pending in the packetizer are not saved."""
        self.flush()  # the step count must include the scans in flight
        b = self.builder
        extras = {
            "g_over_acc_norm": np.asarray(float(self.params.g_over_acc_norm), dtype=np.float32),
            "initialized": np.asarray(int(self.initialized)),
            "use_kin": np.asarray(int(b.use_kin)),
            "last_begin": np.asarray(np.nan if b._last_begin is None else b._last_begin),
            "last_event_time": np.asarray(b._last_event_time),
            "last_scan_time": np.asarray(b._last_scan_time),
            "esc_active": np.asarray(int(self._esc_active)),
            "esc_latched": np.asarray(int(self._esc_latched)),
            "esc_streak": np.asarray(int(self._esc_streak)),
            "n_done": np.asarray(int(self._n_done)),
        }
        if b._events:
            evs = b._events
            extras["ev_time"] = np.asarray([e.time for e in evs])
            extras["ev_acc"] = np.stack([np.asarray(e.acc) for e in evs])
            extras["ev_gyr"] = np.stack([np.asarray(e.gyr) for e in evs])
            if b.use_kin:
                extras["ev_foot_pos"] = np.stack([e.foot_pos for e in evs])
                extras["ev_foot_vel"] = np.stack([e.foot_vel for e in evs])
                extras["ev_contact"] = np.stack([e.contact for e in evs])
        if b._scans:
            log.warning("checkpoint taken with %d pending (incomplete) scans; they are not "
                        "saved -- re-feed them after resume", len(b._scans))
        return ckpt.save(path, self.carry, step=len(self.results), extras=extras)

    def load_checkpoint(self, path: str) -> int:
        """Restore a save_checkpoint snapshot (this package's or the JAX
        package's); returns the step count at save time.  Feed the sensor
        stream from the next scan onward."""
        self.carry, step, extras = ckpt.load(path, self.carry)
        self.params = self.params._replace(g_over_acc_norm=torch.tensor(
            float(extras["g_over_acc_norm"]), dtype=torch.float32, device=self.device))
        self.initialized = bool(int(extras["initialized"]))
        b = self.builder
        if bool(int(extras["use_kin"])) != b.use_kin:
            raise ValueError("checkpoint kinematic mode != config mode")
        lb = float(extras["last_begin"])
        b._last_begin = None if np.isnan(lb) else lb
        b._last_scan_time = float(extras["last_scan_time"])
        events = []
        for i, t in enumerate(extras.get("ev_time", ())):
            if b.use_kin:
                events.append(KinImuEvent(
                    time=float(t), acc=extras["ev_acc"][i], gyr=extras["ev_gyr"][i],
                    foot_pos=extras["ev_foot_pos"][i], foot_vel=extras["ev_foot_vel"][i],
                    contact=extras["ev_contact"][i]))
            else:
                events.append(ImuEvent(time=float(t), acc=extras["ev_acc"][i], gyr=extras["ev_gyr"][i]))
        b._events = events
        b._last_event_time = float(extras["last_event_time"])
        if "esc_active" in extras:
            self._esc_active = bool(int(extras["esc_active"]))
            self._esc_latched = bool(int(extras["esc_latched"]))
            self._esc_streak = int(extras["esc_streak"])
            self._n_done = int(extras["n_done"])
            if self._esc_active and self._esc_enabled:
                self._scfg_active = self._scfg_esc
        return step or 0

    def _dispatch(self, pkt: HostPacket) -> None:
        """Upload + enqueue one scan step; the card works asynchronously and
        the host syncs only in _materialize, up to pipeline_depth scans later."""
        gap = float(self.cfg.tpu.gap_reset_s)
        if gap > 0.0 and pkt.rebase > gap:
            log.warning("sensor-time gap %.1f s >= tpu_gap_reset_s=%.1f: soft reset "
                        "(pose kept, velocity zeroed, clocks realigned, covariance "
                        "inflated)", pkt.rebase, gap)
            self.carry = soft_reset_carry(self.carry, pkt.rebase)
        dev_pkt = to_device_packet(pkt, self.device)
        self.carry, out = process_scan_any(self.carry, dev_pkt, self.params, self._scfg_active)
        self._inflight.append((pkt, out))

    def _materialize(self, pkt: HostPacket, out) -> ScanResult:
        out = _to_host(out)
        self._n_done += 1
        if int(out.n_points) > 100:
            self._watch_match_rate(int(out.n_matched) / int(out.n_points))
        return _scan_result(pkt, out)

    def _watch_match_rate(self, ratio: float) -> None:
        """The collapse alarm (20% for 5 scans after warm-up) and the
        auto-escalation latch of the JAX runner (see TpuConfig)."""
        if self._n_done > 10 and ratio < 0.2:
            self._low_match_streak += 1
            if self._low_match_streak == 5:
                log.warning("match rate below 20%% for 5 consecutive scans — the estimate "
                            "may have diverged.  Check sensor timing; under aggressive "
                            "dynamics consider tpu_match_iters >= 2.")
        elif self._n_done > 10:
            self._low_match_streak = 0
        if not (self._esc_enabled and self._n_done > 3):
            return
        if not self._esc_active and ratio < self._esc_ratio:
            self._esc_streak += 1
            self._healthy_streak = 0
            if self._esc_streak >= self._esc_after:
                self._esc_active = True
                self._scfg_active = self._scfg_esc
                self._esc_streak = 0
                if self._n_done - self._last_deesc <= 3 * self._deesc_after:
                    self._esc_latched = True
                log.warning("match rate below %.0f%% for %d consecutive scans: "
                            "auto-escalating to tpu_match_iters=%d (iterated matching)%s",
                            100 * self._esc_ratio, self._esc_after, self._scfg_esc.match_iters,
                            " [latched: regime needs it]" if self._esc_latched
                            else " until the rate recovers")
        elif self._esc_active and ratio >= self._esc_ratio + 0.1:
            self._healthy_streak += 1
            if (self._deesc_after > 0 and self._healthy_streak >= self._deesc_after
                    and not self._esc_latched):
                self._esc_active = False
                self._scfg_active = self.scfg
                self._healthy_streak = 0
                self._last_deesc = self._n_done
                log.info("match rate recovered: de-escalating to tpu_match_iters=%d",
                         self.scfg.match_iters)
        else:
            self._esc_streak = 0
            self._healthy_streak = 0


def _to_host(out):
    """A ScanOutput's tensors as numpy arrays (this is the host's sync)."""
    return out._replace(**{k: v.cpu().numpy() for k, v in out._asdict().items() if v is not None})


def _scan_result(pkt: HostPacket, out) -> ScanResult:
    """One scan's host-side ScanOutput as a ScanResult, with the overflow
    warnings (the reference has no fixed caps; these must not drop silently)."""
    if pkt.dropped_points or pkt.dropped_events:
        log.warning("packet overflow: dropped %d points, %d events",
                    pkt.dropped_points, pkt.dropped_events)
    if int(out.n_cap_dropped):
        log.warning("cap overflow: %d valid points beyond match/insert cap "
                    "(raise tpu_match_cap/tpu_insert_cap)", int(out.n_cap_dropped))
    mo = out.map_overflow
    if int(mo[0]) or int(mo[2]):
        log.warning("map overflow: %d insert rows beyond insert_row_cap, %d slot claims "
                    "failed (raise tpu_map_insert_row_cap / tpu_map_capacity_log2)",
                    int(mo[0]), int(mo[2]))
    cloud = intensity = None
    if out.cloud_world is not None:
        # Valid rows only; the intensity rides along in the same order (the
        # reference's registered world cloud is PointXYZINormal).
        m = (pkt.point_mask & pkt.bucket_mask[:, None]).reshape(-1)
        cloud = out.cloud_world.reshape(-1, 3)[m]
        if pkt.intensity is not None:
            intensity = pkt.intensity.reshape(-1)[m]
    return ScanResult(
        time=pkt.end_time, rot=out.rot, pos=out.pos,
        n_matched=int(out.n_matched), n_points=int(out.n_points), n_raw=pkt.n_raw,
        cloud_world=cloud, intensity=intensity,
    )


def _scans_after_their_events(add_event, scans: Sequence[RawScan], events: Sequence) -> Iterator[RawScan]:
    """Yield each scan once the events up to (and 0.5 s past) its end have
    gone to ``add_event``, in time order (the packetizer enforces the
    lock-step sync itself)."""
    ev_iter = iter(sorted(events, key=lambda e: e.time))
    pending = next(ev_iter, None)
    for scan in scans:
        while pending is not None and pending.time <= scan.end_time + 0.5:
            add_event(pending)
            pending = next(ev_iter, None)
        yield scan


def replay(runner: OdometryRunner, scans: Sequence[RawScan], events: Sequence) -> Iterator[None]:
    """Feed pre-loaded streams to ``runner`` in time order, yielding after
    each scan: its events, then the scan.  Flushes at the end."""
    add_event = runner.add_imu if runner.cfg.only_imu_use else runner.add_kin_imu
    for scan in _scans_after_their_events(add_event, scans, events):
        runner.add_scan(scan)
        yield
    runner.flush()


def run_offline(cfg: Config, scans: Sequence[RawScan], events: Sequence, device="cuda",
                resume: Optional[str] = None, save_ckpt: Optional[str] = None,
                chunk: int = 0, return_cloud: bool = False) -> List[ScanResult]:
    """Replay pre-loaded streams (dataset/sim replay) through the filter.

    ``resume`` restores a checkpoint first (feed only the scans and events
    after the checkpointed scan; the events buffered in between come back
    from the checkpoint); ``save_ckpt`` snapshots at the stream's end.
    ``chunk`` > 1 stages every packet first and replays ``chunk`` scans a
    call through ``process_scan_chunk``: the same trajectory as per-scan
    stepping with ``match_iters`` fixed (chunked replay does not run the
    escalation latch).  ``return_cloud`` gives each result its world cloud;
    chunked replay does not return clouds and raises ValueError for it."""
    if chunk > 1:
        if return_cloud:
            raise ValueError("chunked replay does not support return_cloud")
        return _run_offline_chunked(cfg, scans, events, chunk, resume, save_ckpt, device)
    runner = OdometryRunner(cfg, return_cloud=return_cloud, device=device)
    if resume:
        log.info("Resumed from %s at step %d", resume, runner.load_checkpoint(resume))
    for _ in replay(runner, scans, events):
        pass
    if save_ckpt:
        log.info("Saved checkpoint to %s", runner.save_checkpoint(save_ckpt))
    return runner.results


def _run_offline_chunked(cfg: Config, scans: Sequence[RawScan], events: Sequence, chunk: int,
                         resume: Optional[str], save_ckpt: Optional[str], device) -> List[ScanResult]:
    """Stage every packet, then replay up to ``chunk`` scans per call."""
    runner = OdometryRunner(cfg, device=device)
    if resume:
        log.info("Resumed from %s at step %d", resume, runner.load_checkpoint(resume))
    b = runner.builder
    add_event = b.add_imu if cfg.only_imu_use else b.add_kin_imu
    staged = []  # (first RawScan of the packet, HostPacket)
    for scan in _scans_after_their_events(add_event, scans, events):
        b.add_scan(scan)
        while b.ready():
            raw = b._scans[0]
            pkt = b.pop()
            if pkt is not None:
                staged.append((raw, pkt))
    results: List[ScanResult] = []
    idx = 0
    # As _drain: a first packet without events leaves the runner
    # uninitialized, so try the following packets until one initializes it.
    while not runner.initialized and idx < len(staged):
        results.append(runner._initialize(*staged[idx]))
        idx += 1
    gap = float(cfg.tpu.gap_reset_s)

    def is_gap(pkt: HostPacket) -> bool:
        return gap > 0.0 and pkt.rebase > gap

    while idx < len(staged):
        # The streaming path's soft-reset policy (_dispatch): chunks split at
        # gap packets so the reset lands between calls.
        if is_gap(staged[idx][1]):
            log.warning("sensor-time gap %.1f s >= tpu_gap_reset_s=%.1f: soft reset "
                        "(chunked replay)", staged[idx][1].rebase, gap)
            runner.carry = soft_reset_carry(runner.carry, staged[idx][1].rebase)
        end = idx + 1
        while end < min(idx + chunk, len(staged)) and not is_gap(staged[end][1]):
            end += 1
        grp = staged[idx:end]
        idx = end
        # A ragged tail or a group cut at a gap is a shorter chunk: eager
        # PyTorch has no compiled shape to keep, so it takes the same call.
        devs = [to_device_packet(p, runner.device) for _, p in grp]
        runner.carry, outs = process_scan_chunk(
            runner.carry, stack_scan_packets(devs), runner.params, runner.scfg)
        outs = _to_host(outs)
        per_scan = [type(outs)(*(None if a is None else a[j] for a in outs)) for j in range(len(grp))]
        results.extend(_scan_result(hp, out) for (_, hp), out in zip(grp, per_scan))
    runner.results = results
    if save_ckpt:
        log.info("Saved checkpoint to %s", runner.save_checkpoint(save_ckpt))
    return results
