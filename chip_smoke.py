#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (legkilo_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines:

1. The card's name and power limit (nvidia-smi), then the kernels built
   from legkilo_torch/csrc (one nvcc per source, in parallel) with the
   registers and shared memory ptxas reports.
2. Every kernel of the two paths on seeded numpy inputs at the paths'
   shapes (C = 3584 match rows, L = 3 levels, NB = 28 buckets, K = 1 event
   slot, P = 256 points a bucket, R = 4096 insert rows, B = 1024 refit
   slots, MP = 128 timeline slots; both chains with kin off and on; the
   pose kernel at MP = 384 and 1,280 too, bit-equal at every MP),
   held against its plain PyTorch version on the same inputs within the
   stated tolerance, and timed with CUDA events (kernel and plain version).
   The fused chain (the one-warp kernel, both branches) runs with a
   gated-off and an empty bucket (and, kin, an event without contact), its
   two launches must be bit-equal, and each branch's ptxas registers,
   spills (must be 0) and shared memory are printed; so does the per-point
   chain (one warp too, both branches, with its empty and its gated-off
   bucket).
   moments and fit read their rows by index, as the insert hands them
   over: moments from the chain's per-bucket outputs and the keys
   kernel's [component, point] rows (R = 4096 gated rows over 3,584
   points, 200 of them in no bucket), fit from the sentinel-extended
   tables of a short run's map (its refit rows, then the sentinel row up
   to the budget); the slots on which fit and its plain version took
   different branches are counted, both print their ptxas lines (no
   spills allowed; fit's three moms storage instantiations) and two
   launches of each must be bit-equal.  The select kernel (one launch a call) runs at NB = 28 and at
   the 2 ms bucket shape (NB = 56, "select_56"), each also with its rows'
   bucket indices shuffled and one bucket empty; two launches must be
   bit-equal, and its ptxas registers, spills (must be 0) and shared
   memory are printed.  keys (a block of four warps a 32-row tile) and the
   two pose instantiations this phase launches print their ptxas lines
   too (no spills allowed), two keys launches must be bit-equal, and an
   empty kernel from the library is timed the same way as the launch
   floor (a line of its own, not in the kernels list).  The insert's claim
   series ("claim", no switch: every path's inserts launch it) runs on the
   calls a fleet of 64 replicas makes at 2^16 slots a level (its first
   frame, two steps), each ``torch.equal`` to claim_plain, with its two
   kernels' ptxas lines (no spills) and its ms at B = 1, 8 and 64.  The
   fused match's probe and plane gather ("probe_planes", on with the match
   kernels) runs on the calls a fleet of 64 replicas makes at the fused
   cells' map (2^16 slots a level, probe 8, caps 4,096), each
   ``torch.equal`` to probe_planes_plain, with its three storage
   instantiations' ptxas lines (no spills) and its ms at B = 1, 8 and 64.
3. The main path end to end: runner.run_offline on the bench.py workload
   (24 s sim, 8000 points a scan, seed 7) on the card with all five kernel
   switches on, streaming ("main"), with every launch counter set to 0
   before and read after; every kernel must have launched and the ATE must
   stay under the golden bound of 0.08 m.  Then the same workload through
   run_offline(chunk=32), bench.py's one-pass shape ("chunk"), the same
   way, and streaming with the escalation latch off ("stream1": one match
   pass a scan, as the chunked run), so the two shapes read side by side.
4. The configuration with the chain, match and insert kernels only (pose
   and refit in plain torch), cut to 8 s ("four").
5. torch.profiler traces of 20 scans of the four- and the five-kernel
   configuration: the device's busy share of the host wall clock, launches
   a scan, device time by operator.
6. The five-kernel workload with leg kinematics (only_imu_use off), 4 s.
7. The per-point path (chain_impl="jax": match rows in bucket layout, the
   per-point chain kernel, the claiming insert; pose and refit kernels on)
   on the same 24 s workload, uncut ("points"), a profiler window of it, and
   4 s of it with leg kinematics ("points_kin").
8. Paths that the runs above do not take, on the first 8 s of the same
   workload: the map slide with the constant-velocity match pose ("slide":
   a slide threshold of 1 m that the path crosses several times, each
   slide observed), the per-point path chunked by 32 ("points_chunk"), and
   2 ms buckets chunked by 32 ("ref2ms": bench.py:350-366, NB = 56,
   P = 128, the chain kernel at NB = 56).
9. The configurations off the kernels, on the same workload: ``main``'s
   configuration streamed twice over its first 8 s ("repeat": both
   trajectories and every final map table must be equal bit for bit);
   configs/leg_fusion.yaml as ``sim --config_file`` loads it (the fused
   path with every kernel switch off, leg kinematics, NB = 64, P = 128,
   caps 4,096, three levels of 2^17 slots; 2 s, "leg_fusion"); bench.py's
   configuration with the match kernels off, the match on its torch path
   feeding the chain, moments, pose and refit kernels (8 s, "mixed"); the
   default Config(), the sequential pipeline (2 s, "seq"); and
   configs/diter.yaml, sequential with leg kinematics (2 s, "seq_kin").
   leg_fusion, seq and seq_kin launch none of the switched kernels, only
   the claim kernel, which every path's inserts launch; mixed exactly its
   four and the claim kernel.  The leg_fusion and seq runs each trace 2 of
   their scans
   after 2 (the card's activity only; "profile_leg_fusion",
   "profile_seq"), and leave those scans out of their ms/scan.
10. ``python -m legkilo_torch run`` itself, in this process: the first
    8 s of the workload written as a ROS1 bag (Imu and Velodyne-style
    PointCloud2 messages with intensity, stamps + 1000 s; this script's
    own writer), replayed with bench.py's configuration from a YAML file,
    the trajectory, the PCD export (each scan's world cloud read back) and
    the plane export (the map read back) on, then ``eval`` against the
    sim's ground truth ("bag", ATE < 0.08 m); the 4 s kin workload as unitree
    HighState messages (joint angles by IK of the feet), through the leg
    kinematics into the chain kernel's kin branch ("bag_kin", ATE < 0.12
    m).  Each prints its host ms/scan, the Timer averages of decode and
    step and the packetizer that ran; ``ref2ms`` prints its packetizer
    too (native/libscanprep.so at 2 ms buckets where it loads).
11. The fleet (legkilo_torch/parallel/sweep.py; the kernels phase first
    holds the six kernels of its path at B = 64 distinct replicas, one
    launch ``torch.equal`` to 64 launches at B = 1 and within the single
    launch's tolerances of the plain version, timed at B = 1, 8 and 64 beside
    the bound, ``[fleet_kernels]``): four ``--distinct`` worlds of 4 s
    through the fleet per scan and chunked by 8, each replica
    ``torch.equal`` to its own run_offline ("fleet_equal"); the main
    workload cut to 8 s as ``sweep --pallas`` runs it, 64 replicas with
    q_diag jittered by 0.1, chunks of 8 ("fleet": every replica's ATE
    under the bound, exactly one launch of each kernel a fleet step,
    replica-scans/s, device ms and launches a fleet step under the
    profiler, peak MB a replica); B = 1, 8, 64 and 256 for 16 scans
    ("fleet_scale": launches a step at B = 64 within 10 % of B = 1's); and
    ``sweep --bags`` in this process over two 4 s bags ("fleet_bags": a TUM
    file a bag, each under the bound).  The kernels phase also holds the
    per-point chain (both branches) at B = 64 that way.
12. The fleet on the configurations off the five kernels, each one batched
    step for all its replicas: ``sweep --replicas 8 --duration 1`` in this
    process on the JAX command's defaults (``Config()``, the sequential
    pipeline), then its fleet of 8 on the bench sim ("fleet_seq");
    configs/leg_fusion.yaml with leg kinematics, a fleet of 4
    ("fleet_leg_fusion"); bench.py's configuration on the per-point path,
    pose and refit kernels on, a fleet of 8 over 16 scans, then 3 steps
    with the constant-velocity pose and ``return_cloud`` and 4 with leg
    kinematics at B = 4 ("fleet_points": the per-point chain once a fleet
    step).  Each prints device launches a fleet step at B = 1 and 8 (8
    within 10 % of 1), replica-scans/s, host and device ms a fleet step,
    peak MB a replica, and holds 2 replicas against their own single runs
    over 2 (per-point: 3) scans at tests/test_torch_fleet_routes.py's
    tolerances.
13. The multi-device layer (legkilo_torch/parallel/: a process a card,
    torch.distributed): ``sweep --pallas --pipeline deferred --distinct 4
    --duration 4 --chunk 8`` with bench.py's configuration from a YAML
    file (the batched five-kernel route), --traj_out and --save_ckpt on two ranks
    sharing the card (gloo, by the backend rule, which each rank logs),
    ranks being subprocesses of this script that print their launch
    counters, against the same command in this process: TUM files byte for
    byte, checkpoint leaves, mean_matched and every ATE equal, each rank's
    six kernels once a fleet step; ``--replicas 8 --duration 2`` in
    broadcast mode gives the one-process final_spread_m ("mesh").  With two
    cards or more the same over NCCL and ``scale`` over 1 ... n cards; on
    one card a line says they did not run.  ``scale --devices 1`` in this
    process (the sequential pipeline, no kernel; "scale"), and bench.py's
    configuration on the cluttered world of tests/test_cluttered_world.py
    within that test's bounds ("clutter": the non-planar branches of
    select and fit on the card).

Each run sets every launch counter to 0 before and reads it after: the
kernels of the path it drives must have launched, and the others must not.

The last two lines are a JSON object with one entry per kernel (the eight
fleet kernels at B = 64 as ``<name>_fleet64``, their launches from
"fleet" and, for the per-point chain, from "fleet_points") and
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no result; so does a machine without CUDA, or a
directory holding this script without the package.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import struct
import subprocess
import sys
import time

import numpy as np

ATE_BOUND_M = 0.08
KIN_BAG_ATE_BOUND_M = 0.12  # the kin bag's bound in the JAX package (tests/test_bag_e2e.py:181)
MAIN_DURATION_S = 24.0   # bench.py's workload, uncut
FOUR_DURATION_S = 8.0    # the four-kernel configuration, cut
KIN_DURATION_S = 4.0     # 40 scans of the kin branch
EXTRA_DURATION_S = 8.0   # the slide, per-point chunked and 2 ms bucket runs
REPEAT_DURATION_S = 8.0  # main's configuration twice
BAG_DURATION_S = 8.0     # the Imu bag, cut to keep the phases within ~6.5 min
MIXED_DURATION_S = 8.0   # the match off its kernels
# The paths off every kernel launch ~10^5 small operations a scan (seconds
# a scan on the card), so they run the fewest scans a run takes (30).
SLOW_DURATION_S = 2.0    # leg_fusion.yaml, Config() sequential, diter.yaml: 20 scans
SLOW_SCANS = int(SLOW_DURATION_S * 10)
SLOW_WARM, SLOW_PROF = 2, 2  # their profiler windows: 2 scans after 2, inside the runs
SLIDE_THRESH_M = 1.0     # the sim's path moves ~5 m in 8 s
SLIDE_HALF_MAP = 20      # level-0 voxels (10 m) each side of the pose
CHUNK = 32               # bench.py:190
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 on CUDA cores, H100 SXM data sheet
REPLACES = {
    "chain_stats": "legkilo_tpu/ops/pallas/chain_stats.py:348",
    "chain_stats_kin": "legkilo_tpu/ops/pallas/chain_stats.py:348",
    "keys": "legkilo_tpu/ops/pallas/match_geom.py:74",
    "select": "legkilo_tpu/ops/pallas/match_geom.py:254",
    "select_56": "legkilo_tpu/ops/pallas/match_geom.py:254",
    "moments": "legkilo_tpu/ops/pallas/insert_rows.py:46",
    "fit": "legkilo_tpu/ops/pallas/plane_fit_rows.py:122",
    "pose": "legkilo_tpu/ops/pallas/pose_prop.py:57",
    "chain_points": "tools/experiments/eskf_chain_pallas.py:376",
    "chain_points_kin": "tools/experiments/eskf_chain_pallas.py:376",
    "claim": "legkilo_tpu/core/voxel_map.py:415",  # XLA scatter rounds, no Pallas kernel
    "probe_planes": "legkilo_tpu/core/filter_deferred.py:396",  # XLA probe and gather, no Pallas kernel
}
SOURCES = {
    "chain_stats": "legkilo_torch/csrc/chain_stats.cu",
    "chain_stats_kin": "legkilo_torch/csrc/chain_stats.cu",
    "keys": "legkilo_torch/csrc/match_geom.cu",
    "select": "legkilo_torch/csrc/match_geom.cu",
    "select_56": "legkilo_torch/csrc/match_geom.cu",
    "moments": "legkilo_torch/csrc/insert_rows.cu",
    "fit": "legkilo_torch/csrc/plane_fit_rows.cu",
    "pose": "legkilo_torch/csrc/pose_prop.cu",
    "chain_points": "legkilo_torch/csrc/chain_points.cu",
    "chain_points_kin": "legkilo_torch/csrc/chain_points.cu",
    "claim": "legkilo_torch/csrc/claim_slots.cu",
    "probe_planes": "legkilo_torch/csrc/probe_planes.cu",
}
# The wrappers whose kernels each path launches (counter names of wrappers()).
# The claim kernel has no switch: every path that builds a map on the card
# (the first frame, every insert) launches it.
ALWAYS_KERNELS = {"claim"}
FUSED_KERNELS = {"chain_stats", "keys", "probe_planes", "select", "moments", "fit", "pose"}
FOUR_KERNELS = FUSED_KERNELS - {"fit", "pose"}
MIXED_KERNELS = FUSED_KERNELS - {"keys", "probe_planes", "select"}
POINTS_KERNELS = {"chain_points", "fit", "pose"}


# -- ROS1 bag writing: the bag phases' input, from the sim (no ROS install) --
BAG_MAGIC = b"#ROSBAG V2.0\n"
BAG_TIME_OFFSET_S = 1000.0  # stamps as tests/test_bag_e2e.py:21-37 writes them
_BMS_SIZE = 4 + 4 + 2 + 2 + 2 + 20  # BmsState.msg


def _bag_header(fields: dict) -> bytes:
    out = []
    for name, value in fields.items():
        field = name + b"=" + value
        out.append(struct.pack("<I", len(field)) + field)
    return b"".join(out)


def _bag_record(fields: dict, data: bytes) -> bytes:
    h = _bag_header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _ros_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _secs_nsecs(stamp: float):
    secs = int(stamp)
    return secs, int(round((stamp - secs) * 1e9))


def _ros_header(stamp: float) -> bytes:
    return struct.pack("<III", 0, *_secs_nsecs(stamp)) + _ros_string("frame")


def serialize_imu(stamp, acc, gyr) -> bytes:
    """sensor_msgs/Imu: identity orientation, zero covariances."""
    zeros9 = struct.pack("<9d", *np.zeros(9))
    return (_ros_header(stamp) + struct.pack("<4d", 0, 0, 0, 1) + zeros9
            + struct.pack("<3d", *gyr) + zeros9 + struct.pack("<3d", *acc) + zeros9)


def serialize_pointcloud2(stamp, pts, times, intensity) -> bytes:
    """Velodyne-style sensor_msgs/PointCloud2: x y z intensity time, f32."""
    names = ("x", "y", "z", "intensity", "time")
    rows = np.zeros(len(pts), dtype=[(n, "<f4") for n in names])
    rows["x"], rows["y"], rows["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    rows["intensity"], rows["time"] = intensity, times
    payload = rows.tobytes()
    out = [_ros_header(stamp), struct.pack("<II", 1, len(pts)), struct.pack("<I", len(names))]
    out += [_ros_string(n) + struct.pack("<IBI", 4 * i, 7, 1) for i, n in enumerate(names)]
    out.append(struct.pack("<B", 0))  # is_bigendian
    out.append(struct.pack("<II", rows.itemsize, len(payload)))
    out.append(struct.pack("<I", len(payload)) + payload + struct.pack("<B", 1))  # is_dense
    return b"".join(out)


def serialize_high_state(stamp, acc, gyr, q, dq, foot_force) -> bytes:
    """unitree_legged_msgs/HighState with the fields the decoder reads."""
    out = [struct.pack("<II", *_secs_nsecs(stamp)), bytes(4),  # head, levelFlag, frameReserve
           struct.pack("<2I2IH", 0, 0, 0, 0, 0),               # SN, version, bandWidth
           struct.pack("<13f", 0, 0, 0, 1, *gyr, *acc, 0, 0, 0), struct.pack("<b", 0)]
    out += [struct.pack("<B7fb2I", 0, q[i], dq[i], 0, 0, 0, 0, 0, 0, 0, 0) for i in range(20)]
    out += [bytes(_BMS_SIZE), struct.pack("<4h", *foot_force), bytes(64)]
    return b"".join(out)


def write_bag(path, messages) -> None:
    """A ROS1 v2.0 bag of one uncompressed chunk; ``messages`` is a list of
    (topic, msg_type, stamp, raw) in time order."""
    conns = {}
    chunk = []
    for topic, msg_type, stamp, raw in messages:
        if topic not in conns:
            cid = len(conns)
            conns[topic] = cid
            conn_data = _bag_header({b"topic": topic.encode(), b"type": msg_type.encode(),
                                     b"md5sum": b"0" * 32, b"message_definition": b""})
            chunk.append(_bag_record({b"op": b"\x07", b"conn": struct.pack("<I", cid),
                                      b"topic": topic.encode()}, conn_data))
        chunk.append(_bag_record({b"op": b"\x02", b"conn": struct.pack("<I", conns[topic]),
                                  b"time": struct.pack("<II", *_secs_nsecs(stamp))}, raw))
    chunk = b"".join(chunk)
    with open(path, "wb") as f:
        f.write(BAG_MAGIC)
        f.write(_bag_record({b"op": b"\x03", b"index_pos": struct.pack("<Q", 0),
                             b"conn_count": struct.pack("<I", len(conns)),
                             b"chunk_count": struct.pack("<I", 1)}, b" " * 128))
        f.write(_bag_record({b"op": b"\x05", b"compression": b"none",
                             b"size": struct.pack("<I", len(chunk))}, chunk))


def scan_intensity(pts):
    """A per-point intensity for the sim's scans (which carry none): a
    function of range, so the PCD's intensity column is checkable."""
    return (np.linalg.norm(pts, axis=1) * 10.0 % 256.0).astype(np.float32)


def scan_messages(data, offset=BAG_TIME_OFFSET_S):
    return [("/points_raw", "sensor_msgs/PointCloud2", sc.begin_time + offset,
             serialize_pointcloud2(sc.begin_time + offset, sc.points, sc.time_offset,
                                   scan_intensity(sc.points)))
            for sc in data.scans]


def imu_bag_messages(data, offset=BAG_TIME_OFFSET_S):
    """The sim's Imu and PointCloud2 messages, stamps + ``offset``, in time order."""
    msgs = [("/imu_raw", "sensor_msgs/Imu", ev.time + offset,
             serialize_imu(ev.time + offset, ev.acc, ev.gyr)) for ev in data.imu]
    return sorted(msgs + scan_messages(data, offset), key=lambda m: m[2])


def _leg_jacobian(kcfg, q, leg):
    from legkilo_torch.models import unitree as ut

    lc, lt, d = kcfg.leg_calf_length, kcfg.leg_thigh_length, kcfg.leg_thigh_offset
    lf = ut._LFOOT[leg]
    s1, s2 = np.sin(q[0]), np.sin(q[1])
    s23, c1 = np.sin(q[1] + q[2]), np.cos(q[0])
    c2, c23 = np.cos(q[1]), np.cos(q[1] + q[2])
    return np.array([
        [0.0, -lc * c23 - lt * c2, -lc * c23],
        [lt * c1 * c2 - lf * d * s1 + lc * c1 * c23, -s1 * (lc * s23 + lt * s2), -lc * s23 * s1],
        [lt * c2 * s1 + lf * d * c1 + lc * s1 * c23, c1 * (lc * s23 + lt * s2), lc * s23 * c1],
    ])


def _fk_all(kcfg, q_all):
    from legkilo_torch.models import unitree as ut

    fp, _ = ut.foot_pos_vel(q_all[None], np.zeros((1, 4, 3)), kcfg)
    return fp[0]


def _ik_all(kcfg, targets, q0_all):
    """Newton IK of the four legs against the FK and its analytic Jacobian
    (tests/test_bag_e2e.py:76-140)."""
    q = np.array(q0_all, dtype=float)
    for _ in range(12):
        r = targets - _fk_all(kcfg, q)
        if np.abs(r).max() < 1e-10:
            break
        for leg in range(4):
            q[leg] = q[leg] + np.linalg.solve(_leg_jacobian(kcfg, q[leg], leg), r[leg])
    return q


def kin_bag_messages(data, kcfg, offset=BAG_TIME_OFFSET_S):
    """The sim's kin events as HighState messages (joint angles and rates by
    IK of the feet, foot forces across the contact threshold) and its
    PointCloud2 messages, stamps + ``offset``, in time order."""
    from legkilo_torch.models import unitree as ut

    msgs = []
    last_q = np.tile(np.array([0.0, 0.8, -1.6]), (4, 1))
    t_on = kcfg.contact_force_threshold_up
    for ev in data.kin:
        motor_q, motor_dq = np.zeros(20), np.zeros(20)
        force_u = np.zeros(4, dtype=int)
        q_all = _ik_all(kcfg, ev.foot_pos, last_q)
        if np.abs(_fk_all(kcfg, q_all) - ev.foot_pos).max() >= 1e-8:
            raise RuntimeError("leg IK diverged")
        last_q = q_all
        for leg in range(4):
            dq = np.linalg.solve(_leg_jacobian(kcfg, q_all[leg], leg), ev.foot_vel[leg])
            base = ut._MOTOR_BASE[leg]
            motor_q[base:base + 3] = q_all[leg]
            motor_dq[base:base + 3] = dq
            force_u[ut._FORCE_INDEX[leg]] = int(2 * t_on) if ev.contact[leg] else 0
        msgs.append(("/high_state", "unitree_legged_msgs/HighState", ev.time + offset,
                     serialize_high_state(ev.time + offset, ev.acc, ev.gyr, motor_q, motor_dq,
                                          force_u)))
    return sorted(msgs + scan_messages(data, offset), key=lambda m: m[2])


def write_gt_tum(path, data, offset=BAG_TIME_OFFSET_S) -> None:
    """The sim's ground truth in the filter's frame as a TUM file."""
    from legkilo_torch.io.tum import TrajectoryWriter

    rot, pos = data.gt_in_filter_frame()
    with TrajectoryWriter(path) as w:
        for t, r, p in zip(data.gt_times, rot, pos):
            w.write(t + offset, r, p)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_call(torch, fn, iters: int) -> float:
    """Mean ms of fn() over ``iters`` calls, by CUDA events, after a warm-up.
    The stream is first given ~20 ms of spin so the launches queue behind it
    and the events time the device's work rather than the host's enqueue,
    as far as the spin covers it."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_floor_ms(torch) -> float:
    """Device ms a launch of the library's empty kernel (one warp, no
    work), by ``time_call``: the floor under every kernel time."""
    from legkilo_torch.ops import _build

    fn = _build._function("lk_empty_launch", 0, 0)

    def go():
        rc = fn(torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lk_empty_launch: CUDA error {rc}")

    return time_call(torch, go, 200)


def nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def bound(n_bytes: int, n_flops: float):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bucket_targets(torch, bidx, nb):
    """Each row's bucket as the plain version reads bidx (its int64 cast),
    with ``nb`` for a row in no bucket."""
    b = bidx.long()
    return torch.where((b >= 0) & (b < nb), b, torch.full_like(b, nb))


def select_sums_vs_plain(torch, out, s40, nm, r_out, r_s40, r_nm, bidx, nb):
    """The select kernel's per-bucket s40 and match counts against the plain
    version's, with the terms of the rows whose gate flipped (matched on one
    side only) taken out of each side's sums in float64.  Returns (rel err
    of s40, whether the counts agree)."""
    flip = out[0] != r_out[0]
    tgt = bucket_targets(torch, bidx[0][flip], nb)

    def flipped_terms(o):
        x = o[6:46, flip].double()
        s = torch.zeros(nb + 1, 40, 40, dtype=torch.float64, device=o.device).index_add_(
            0, tgt, (x * o[1, flip].double()).T[:, :, None] * x.T[:, None, :])
        n = torch.zeros(nb + 1, dtype=torch.float64, device=o.device).index_add_(
            0, tgt, o[0, flip].double())
        return s[:nb].reshape(nb * 40, 40), n[:nb, None]

    ks, kn = flipped_terms(out)
    ps, pn = flipped_terms(r_out)
    e_s40 = rel_err(s40.double() - ks, r_s40.double() - ps)
    return e_s40, torch.equal(nm.double() - kn, r_nm.double() - pn)


SELECT_TOL = ("matched on >= 99.9% rows; rel 1e-4 rows; sums rel 1e-5 vs float64 of its rows "
              "and rel 1e-4 vs plain (flipped rows' terms out), counts exact; repeat bit-equal")


def select_check(torch, sargs, levels, nb, min_same=0.999):
    """select_call against select_plain on ``sargs`` (SELECT_TOL): a gate
    (rsqrt/exp/sqrt differ in the last ulp) may flip only on a knife edge,
    so matched may differ on at most 1 - ``min_same`` of the rows and the
    rest are compared at rel 1e-4; s40 and the counts are held against
    float64 sums of the kernel's own rows (order of summation only) and
    against the plain version's with the flipped rows' terms taken out of
    both; a second launch on the same inputs must be bit-equal.  Returns
    (kernel outputs, plain outputs, {flips, e_rows, e_sum, e_s40})."""
    from legkilo_torch.ops import match_geom as mg

    got = mg.select_call(*sargs, levels, nb)
    again = mg.select_call(*sargs, levels, nb)
    torch.cuda.synchronize()
    ref = mg.select_plain(*sargs, levels, nb)
    out, s40, nm = got
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"select at NB = {nb}: two launches on the same inputs differ")
    same = out[0] == ref[0][0]
    if float(same.float().mean()) < min_same:
        raise RuntimeError(f"select at NB = {nb}: matched differs on {int((~same).sum())} rows")
    e_rows = rel_err(out[:, same], ref[0][:, same])
    x = out[6:46].double()
    tgt = bucket_targets(torch, sargs[7][0], nb)
    s64 = torch.zeros(nb + 1, 40, 40, dtype=torch.float64, device=out.device).index_add_(
        0, tgt, (x * out[1].double()).T[:, :, None] * x.T[:, None, :])[:nb].reshape(nb * 40, 40)
    e_sum = rel_err(s40, s64)
    nm64 = torch.zeros(nb + 1, dtype=torch.float64, device=out.device).index_add_(
        0, tgt, out[0].double())[:nb]
    if not (e_rows <= 1e-4 and e_sum <= 1e-5 and torch.equal(nm.double(), nm64[:, None].expand(nb, 128))):
        raise RuntimeError(f"select at NB = {nb}: rel errs rows {e_rows:.3g} sums {e_sum:.3g}")
    e_s40, nm_same = select_sums_vs_plain(torch, out, s40, nm, *ref, sargs[7], nb)
    if not (e_s40 <= 1e-4 and nm_same):
        raise RuntimeError(f"select at NB = {nb}: vs plain: s40 rel err {e_s40:.3g}, counts equal {nm_same}")
    return got, ref, dict(flips=int((~same).sum()), e_rows=e_rows, e_sum=e_sum, e_s40=e_s40)


def shuffled_bidx(torch, sargs, rng, empty=None):
    """``sargs`` with the rows' bucket indices permuted at random (every
    bucket's rows scattered over the whole range, padding rows among them)
    and, with ``empty``, that bucket's rows moved to bucket 0."""
    out = list(sargs)
    c = sargs[7].shape[1]
    bidx = sargs[7][:, torch.as_tensor(rng.permutation(c), device=sargs[7].device)].contiguous()
    if empty is not None:
        bidx[bidx == float(empty)] = 0.0
    out[7] = bidx
    return out


# ----------------------------------------------------------------- inputs --


def rotations(rng, n, scale=0.3):
    from legkilo_torch.core.so3 import exp_so3
    import torch

    w = torch.tensor(rng.normal(scale=scale, size=(n, 3)), dtype=torch.float32)
    return exp_so3(w).numpy()


def chain_inputs(torch, dev, rng, use_kin, nb=28, k=1):
    from legkilo_torch.config import EskfConfig
    from legkilo_torch.core import eskf_fused as ef
    from legkilo_torch.core.eskf import make_noise_params

    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    nz = make_noise_params(EskfConfig(), "cpu")
    params = np.concatenate([nz.q_diag.numpy(), nz.imu_meas_r.numpy(), [1.0, 0.1, 0.0, 0.0]])
    a = rng.normal(size=(30, 30)) * 0.01
    cov0 = a @ a.T + 1e-4 * np.eye(30)
    lin0 = rng.normal(scale=0.05, size=27)
    lin0[12:15] = [0.0, 0.0, -9.81]
    lin0[15:18] = [0.0, 0.0, 9.81]
    bt = (np.arange(nb) + 1) * 0.004
    brow = np.stack([bt, np.ones(nb), rng.integers(0, 120, size=nb)], 1)
    etime = np.clip(bt[:, None] - 0.002, 0, None) * np.ones((1, k))
    egate = (rng.random((nb, k)) < 0.3).astype(np.float32)
    eacc = rng.normal(scale=0.05, size=(nb, k, 3))
    eacc[..., 2] += 9.81
    egyr = rng.normal(scale=0.02, size=(nb, k, 3))
    fp = rng.normal(scale=0.2, size=(nb, k, 4, 3))
    fp[..., 2] -= 0.3
    efp = fp.reshape(nb, k, 12)
    efv = rng.normal(scale=0.1, size=(nb, k, 12))
    ect = (rng.random((nb, k, 4)) < 0.6).astype(np.float32)
    if not use_kin:
        efp, efv, ect = np.zeros_like(efp), np.zeros_like(efv), np.zeros_like(ect)
    # s40 from ~120 matched floor/wall points a bucket, as the select kernel forms it.
    c = 120 * nb
    p_i = torch.tensor(rng.uniform(-5, 5, size=(c, 3)), dtype=torch.float32)
    n = torch.tensor(rng.normal(size=(c, 3)), dtype=torch.float32)
    n = n / n.norm(dim=1, keepdim=True)
    ctr = torch.tensor(rng.uniform(-5, 5, size=(c, 3)), dtype=torch.float32)
    r = torch.tensor(rng.uniform(0.01, 0.3, size=c), dtype=torch.float32)
    s40 = ef.point_suffstats_compact(p_i, n, ctr, r, torch.ones(c, dtype=torch.bool),
                                     torch.arange(c) // 120, nb)
    return [f(params), f([0.0, 0.0]), f(rotations(rng, 1, 0.1)[0]), f(lin0), f(cov0), f(brow),
            f(etime), f(egate), f(eacc), f(egyr), f(efp), f(efv), f(ect), s40.to(dev)]


def chain_holes(args):
    """Bucket nb // 3 of ``chain_inputs`` gated off, bucket 2 nb // 3
    empty (no match: its statistics and count zero) and every foot of event
    slot (nb // 2, 0) out of contact (the kin branch's inputs; the IMU
    branch's contacts are zero), in place and without a draw; at NB < 3
    these are all bucket 0."""
    nb = args[5].shape[0]
    args[5][nb // 3, 1] = 0.0
    args[5][2 * nb // 3, 2] = 0.0
    args[13][2 * nb // 3] = 0.0
    args[12][nb // 2, 0] = 0.0
    return args


def chain_points_inputs(torch, dev, rng, use_kin, nb=28, k=1, p=256):
    """The per-point chain's inputs: the state, clocks and events of
    ``chain_inputs``, and per bucket P match rows as ``_batched_match``
    leaves them: points within 5 m, unit normals, plane centres a few cm
    off the point's world position, ~70% matched, unmatched rows zero; one
    bucket without a match and one gated off."""
    base = chain_inputs(torch, dev, rng, use_kin, nb, k)
    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    brow = base[5].cpu().numpy()
    bgate = brow[:, 1].copy()
    bgate[nb // 3] = 0.0
    rot0, pos0 = base[2].cpu().numpy(), base[3].cpu().numpy()[0:3]
    pi = rng.uniform(-5, 5, size=(nb, p, 3))
    n = rng.normal(size=(nb, p, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ctr = pi @ rot0.T + pos0 + rng.normal(scale=0.03, size=(nb, p, 3))
    r = rng.uniform(1e-3, 5e-2, size=(nb, p))
    m = (rng.random((nb, p)) < 0.7).astype(np.float32)
    m[2 * nb // 3] = 0.0
    n, ctr, r = n * m[..., None], ctr * m[..., None], r * m
    nd = np.sum(n.astype(np.float32) * ctr.astype(np.float32), axis=-1)
    return base[0:5] + [f(brow[:, 0]), f(bgate)] + base[6:13] + [f(pi), f(n), f(nd), f(r), f(m)]


def chain_flops(nb, k, use_kin) -> float:
    """Reckoned from the kernel's loops: a predict ~4.5k flops (the two
    passes over rows/columns 0:9 of P), the IMU update ~14k (K P, the 30x30
    downdate), the kin update ~116k (H P H^T, the nested-Schur 18x18
    inverse, the 30x18 gain, the 30x30 downdate), the point update ~17k."""
    ev = 4.5e3 + (116e3 if use_kin else 14e3)
    return nb * (k * ev + 4.5e3 + 17e3)


def chain_points_flops(nb, k, p, use_kin) -> float:
    """As ``chain_flops``, plus ~110 flops a point for its row of the normal
    equations (R^T n, the cross product, the residual, the weight, 21 + 6
    products and sums)."""
    return chain_flops(nb, k, use_kin) + nb * p * 110.0


def keys_inputs(torch, dev, rng, c=3584, levels=3):
    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    par = np.zeros(64)
    par[0:9] = rotations(rng, 1, 0.05)[0].reshape(9)
    par[9:12] = [0.0, 0.0, 0.2]
    par[12:12 + levels] = [0.5 / 2 ** l for l in range(levels)]
    a = rng.normal(size=(3, 3)) * 1e-3
    par[16:25] = (a @ a.T).reshape(9)
    b = rng.normal(size=(3, 3)) * 1e-3
    par[25:34] = (b @ b.T).reshape(9)
    par[34:36] = [0.04, 0.2]
    pts = rng.uniform(-12, 12, size=(3, c))
    rb = rotations(rng, c, 0.3).reshape(c, 9).T
    pb = rng.normal(scale=2.0, size=(3, c))
    return f(par), f(pts), f(rb), f(pb)


def select_inputs(torch, dev, rng, keys_out, nb=28, levels=3):
    """Gathered plane rows around each point's candidate centres: unit
    normals, radius 0.3, a PSD 6x6 plane covariance; found/is_plane flags at
    random; rows in bucket order with padding (bidx = nb) at the end."""
    piw, covs, keys, vc, idx0 = keys_out
    c = piw.shape[1]
    nc = 2 * levels
    plane = np.zeros((nc, 31, c))
    pw = piw[3:6].cpu().numpy()
    vcs = vc.cpu().numpy().reshape(nc, 3, c)
    for m in range(nc):
        nrm = rng.normal(size=(3, c))
        nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
        plane[m, 0:3] = pw - vcs[m] + rng.normal(scale=0.05, size=(3, c))
        plane[m, 3:6] = nrm
        plane[m, 6:9] = [[1e-4], [0.01], [0.02]]
        plane[m, 9] = 0.3
        g = rng.normal(size=(c, 6, 6)) * 1e-3
        pv = g @ np.swapaxes(g, 1, 2)
        iu = np.triu_indices(6)
        plane[m, 10:31] = pv[:, iu[0], iu[1]].T
    flags = np.concatenate([rng.random((nc, c)) < 0.8, rng.random((nc, c)) < 0.7]).astype(np.float32)
    n_valid = c - 200
    mask = (np.arange(c) < n_valid).astype(np.float32)[None]
    bidx = np.minimum(np.arange(c) * nb // n_valid, nb).astype(np.float32)[None]
    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    par = f([3.0, 3.0, 10.0, 0, 0, 0, 0, 0])
    return [par, piw, covs[0:18].contiguous(), vc, f(plane.reshape(nc * 31, c)), f(flags), f(mask), f(bidx)]


def moments_inputs(torch, dev, rng, r=4096, nb=28, n=3584, levels=3):
    """moments_rows_call's inputs as the insert phase hands them over: the
    chain's per-bucket outputs, the match phase's point rows in the keys
    kernel's [component, point] layout (n points in bucket order, the last
    200 in no bucket: bidx = nb), and R gated rows as gated_insert_rows
    leaves them (every valid point at level 0, then the first ones again at
    levels 1, 2, ...; lvl a column of an [R, 7] table; keys of the rows'
    own voxels)."""
    from legkilo_torch.ops import insert_rows as ir

    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    ext_r = rotations(rng, 1, 0.05)[0]
    rots = rotations(rng, nb, 0.3)
    poss = rng.normal(scale=2.0, size=(nb, 3))
    covs = [rng.normal(size=(nb, 3, 3)) * 1e-3 for _ in range(2)]
    rot_covs, pos_covs = (c @ np.swapaxes(c, 1, 2) for c in covs)
    n_valid = n - 200
    bidx = np.minimum(np.arange(n) * nb // n_valid, nb)
    p_i = rng.uniform(-10, 10, size=(n, 3))
    a = rng.normal(size=(n, 3, 3)) * 0.01
    body_cov = a @ np.swapaxes(a, 1, 2)
    lvl = np.minimum(np.arange(r) // n_valid, levels - 1)
    pidx = np.arange(r) % n_valid
    b = np.minimum(bidx, nb - 1)[pidx]
    pw = np.einsum("rij,rj->ri", rots[b], p_i[pidx]) + poss[b]
    sizes = ir.level_sizes(0.5, levels, dev)
    keys = np.floor(pw / sizes.cpu().numpy()[lvl][:, None])
    piw_t = f(np.concatenate([p_i.T, np.zeros((3, n))]))          # the keys kernel's [6, C]
    covs_t = f(np.concatenate([np.zeros((18, n)), body_cov.reshape(n, 9).T]))   # its [27, C]
    rows7 = torch.zeros((r, 7), dtype=torch.int64, device=dev)
    rows7[:, 3] = torch.as_tensor(lvl, device=dev)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
    return (f(ext_r), sizes, f(rots), f(poss), f(rot_covs), f(pos_covs), piw_t[0:3].T,
            covs_t[18:27].T.reshape(n, 3, 3), i64(pidx), i64(bidx),
            torch.as_tensor(keys.astype(np.int32), device=dev), rows7[:, 3])


def moments_bytes(margs) -> int:
    """What moments_rows_call must move for these inputs: each input once,
    the point rows (p_i, its covariance, its bucket) of the points the rows
    name, and the two outputs."""
    pidx = margs[8]
    u = int(pidx.unique().numel())
    r, nb = pidx.shape[0], margs[2].shape[0]
    return (4 * (9 + margs[1].numel() + 30 * nb) + u * (4 * 12 + 8)
            + r * (8 + 12 + 8) + r * 69 * 4)


def fit_inputs(torch, dev, budget=1024, n_scans=30):
    """fit_slots_call's inputs as the insert hands them over: the
    sentinel-extended tables of the map a short five-kernel run left, and
    refit rows naming the voxels with more points than the refit threshold
    (at most 5/8 of the budget, about the share a steady-state scan refits),
    then the sentinel row up to the budget, as the unfilled refit slots
    are."""
    from legkilo_torch.core import voxel_map as vmap
    from legkilo_torch.models import sim
    from legkilo_torch.ops import plane_fit_rows as pfr
    from legkilo_torch.runner import OdometryRunner, bench_config, replay

    data = sim.simulate(sim.SimConfig(duration=(n_scans + 1) * 0.1, scan_points=8000, seed=7))
    runner = OdometryRunner(bench_config(), device=dev)
    for _ in replay(runner, data.scans, data.imu):
        pass
    vm = runner.carry.vm
    idx = torch.nonzero(vm.meta[:, 0] > 5.0)[:, 0][: budget * 5 // 8]
    fs = torch.full((budget,), vm.meta.shape[0], dtype=torch.int64, device=dev)
    fs[: len(idx)] = idx
    tables = [vmap._with_sentinel(t) for t in (vm.meta, vm.mom, vm.moms)]
    par = pfr.fit_par(runner.scfg.map_cfg.planer_threshold, dev)
    return (par, *tables, fs), int(len(idx))


def fit_check(torch, what, got, ref, max_flips):
    """The refit kernel's outputs [B, 35] against its plain version's.
    They do the same un-fused arithmetic in the same order and can part
    only where sqrt, division or cos round apart.  A slot counts as a
    branch flip when is_plane differs or the normal moved by more than
    1e-3 (another eigenvector candidate or fallback); at most ``max_flips``
    may.  On the rest: centre, normal, evals, radius abs 1e-5, plane_var
    1e-4 of the row's largest entry, the meta columns 31:34 equal.  Raises
    otherwise; returns (flips, head err, plane_var rel err, max abs err)."""
    gt, rt = got.T, ref.T
    flip = (gt[34] != rt[34]) | ((gt[3:6] - rt[3:6]).abs().max(dim=0).values > 1e-3)
    n_flip = int(flip.sum())
    keep = ~flip
    e_head = max_abs(gt[0:10, keep], rt[0:10, keep])
    pv_scale = rt[10:31, keep].abs().max(dim=0).values.clamp(min=1e-30)
    e_pv = float(((gt[10:31, keep] - rt[10:31, keep]).abs().max(dim=0).values / pv_scale).max())
    if n_flip > max_flips or not (e_head <= 1e-5 and e_pv <= 1e-4
                                  and torch.equal(gt[31:34], rt[31:34])):
        raise RuntimeError(f"{what}: {n_flip} branch flips, head err {e_head:.3g}, "
                           f"plane_var rel {e_pv:.3g}, meta columns equal "
                           f"{bool(torch.equal(gt[31:34], rt[31:34]))}")
    return n_flip, e_head, e_pv, max_abs(gt[:, keep], rt[:, keep])


def fit_bytes(fargs) -> int:
    """What fit_slots_call must move: par, fs, the n, m1/m2 and moms row (in
    the storage dtype) of each distinct row that fs names once, and the
    [B, 35] output."""
    fs = fargs[4]
    b, u = fs.shape[0], int(fs.unique().numel())
    return 32 + 8 * b + u * (4 + 36 + 60 * fargs[3].element_size()) + 35 * 4 * b


FIT_FLOPS_PER_SLOT = 1600.0  # t 378, w 306, c 68, u 210, t_nn/t_nq 234, eigen ~320, rest ~80


def pose_inputs(torch, dev, rng, nb, k):
    """A scan's event/bucket timeline as the deferred path lays it out: K
    event slots then the bucket time, per bucket; ~40% of the event slots
    and ~90% of the buckets valid; MP = NB (K+1) padded to 128."""
    m = nb * (k + 1)
    mp = (m + 127) // 128 * 128
    bt = (np.arange(nb) + 1) * 0.004
    et = bt[:, None] - 0.004 + 0.004 * (np.arange(k)[None, :] + 0.5) / k
    ev = rng.random((nb, k)) < 0.4
    rows = np.zeros((9, mp), np.float32)
    rows[0, :m] = np.concatenate([et, bt[:, None]], 1).reshape(m)
    rows[1, :m] = np.concatenate([ev, rng.random((nb, 1)) < 0.9], 1).reshape(m)
    rows[2, :m] = np.concatenate([ev, np.zeros((nb, 1), bool)], 1).reshape(m)
    gyr = rng.normal(scale=0.5, size=(nb, k + 1, 3))
    acc = rng.normal(scale=0.5, size=(nb, k + 1, 3)) + [0.0, 0.0, 9.81]
    gyr[:, k], acc[:, k] = 0.0, 0.0
    rows[3:6, :m] = gyr.reshape(m, 3).T
    rows[6:9, :m] = acc.reshape(m, 3).T
    par = np.concatenate([
        rotations(rng, 1, 0.3)[0].reshape(9), rng.normal(size=3), rng.normal(scale=0.5, size=3),
        rng.normal(scale=0.01, size=6), [0.0, 0.0, -9.81], rng.normal(scale=0.3, size=3),
        [0.1, -0.2, 9.7], [-0.001, 1.002]])
    f = lambda x: torch.tensor(np.array(x, np.float32, order="C"), device=dev).contiguous()
    return f(par), f(rows)


def pose_flops(mp) -> float:
    """Per slot: Rodrigues ~60, rot0 @ prefix 45, dv 21, the rest ~10, and per
    doubling step the 3x3 product (45), the two 3-vector sums (6) and the
    clock's max (1)."""
    steps = int(np.ceil(np.log2(mp)))
    return mp * (136.0 + steps * 52.0)


# ----------------------------------------------------------------- phases --


def phase_build():
    from legkilo_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    log(f"[build] {path} in {time.perf_counter() - t0:.1f} s")
    with open(_build.ptxas_log_path()) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("==") or "Used" in line or "Compiling entry" in line or "spill" in line:
                log(f"[ptxas] {line}")


def ptxas_entry(fragment: str) -> dict:
    """Registers, static shared bytes, stack frame and spill bytes that the
    build's ptxas log (-Xptxas -v) reports for the kernel whose mangled name
    holds ``fragment``."""
    import re

    from legkilo_torch.ops import _build

    with open(_build.ptxas_log_path()) as fh:
        lines = fh.read().splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and fragment in line:
            block = []
            for nxt in lines[n + 1:]:
                if "Compiling entry function" in nxt or nxt.startswith("=="):
                    break
                block.append(nxt)
            body = "\n".join(block)

            def total(pat):
                return sum(int(x) for x in re.findall(pat, body))

            return dict(registers=total(r"Used (\d+) registers"), smem=total(r"(\d+) bytes smem"),
                        stack=total(r"(\d+) bytes stack frame"),
                        spills=total(r"(\d+) bytes spill stores") + total(r"(\d+) bytes spill loads"))
    raise RuntimeError(f"the ptxas log has no kernel named like {fragment!r}")


def phase_kernels(torch, dev):
    """Each kernel against its plain version; returns {name: record}."""
    from legkilo_torch.ops import chain_points as cp
    from legkilo_torch.ops import chain_stats as cs
    from legkilo_torch.ops import insert_rows as ir
    from legkilo_torch.ops import match_geom as mg
    from legkilo_torch.ops import plane_fit_rows as pfr
    from legkilo_torch.ops import pose_prop as pp

    rng = np.random.default_rng(7)
    recs = {}

    for name, use_kin in (("chain_stats", False), ("chain_stats_kin", True)):
        args = chain_holes(chain_inputs(torch, dev, rng, use_kin))
        got = cs.chain_call(*args, use_kin=use_kin)
        torch.cuda.synchronize()
        ref = cs.chain_plain(*args, use_kin=use_kin)
        # Poses: rel 1e-4 of their magnitude; covariances: rel 1e-3 (the
        # plain version applies F P F^T as columns-then-rows, the kernel as
        # Q1 + Q1 D^T, reads P H^T as (H P)^T, forms the kin gain from the
        # Schur blocks, and the 18x18 inverse amplifies rounding); match
        # counts and clocks exact.
        tol = [1e-4, 1e-4, 1e-3, 1e-3, 0.0, 1e-4, 1e-4, 1e-3, 0.0]
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        for i, (e, t) in enumerate(zip(errs, tol)):
            if not e <= t:
                raise RuntimeError(f"{name}: output {i} rel err {e:.3g} > {t}")
        nb, k = args[6].shape
        again = cs.chain_call(*args, use_kin=use_kin)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{name}: two launches on the same inputs differ")
        tol_text = "rel 1e-4 poses, 1e-3 covariances; counts and clocks exact; repeat bit-equal"
        # The kernel template's instantiation for the branch (mangled name).
        px = ptxas_entry(f"chain_warp_kernelILb{int(use_kin)}E")
        staged = nb * (3 + (36 if use_kin else 8) * k) * 4
        log(f"[kernel] {name}: one warp, {px['registers']} registers, {px['spills']} B of spills, "
            f"{px['stack']} B stack frame, {px['smem']} B static + {staged} B staged "
            f"shared memory; bucket {nb // 3} gated off, bucket {2 * nb // 3} empty (count "
            f"{int(got[4][2 * nb // 3])}); two launches bit-equal")
        if px["spills"]:
            raise RuntimeError(f"{name}: ptxas spills {px['spills']} B in the warp kernel")
        recs[name] = dict(
            max_abs_err=max(max_abs(a, b) for a, b in zip(got, ref)),
            ms=time_call(torch, lambda: cs.chain_call(*args, use_kin=use_kin), 50),
            plain_ms=time_call(torch, lambda: cs.chain_plain(*args, use_kin=use_kin), 3),
            bytes=nbytes(list(args) + list(got)), flops=chain_flops(nb, k, use_kin),
            tol=tol_text,
        )
        log(f"[kernel] {name}: rel errs {[f'{e:.2e}' for e in errs]}")

    for name, use_kin in (("chain_points", False), ("chain_points_kin", True)):
        args = chain_points_inputs(torch, dev, rng, use_kin)
        got = cp.chain_points_call(*args, use_kin=use_kin)
        torch.cuda.synchronize()
        ref = cp.chain_points_plain(*args, use_kin=use_kin)
        if not all(bool(torch.isfinite(x).all()) for x in got):
            raise RuntimeError(f"{name}: non-finite output")
        # As the other chain: poses rel 1e-4, covariances rel 1e-3 (the plain
        # version forms F P F^T and the normal equations with matrix
        # products, the kernel as Q1 + Q1 D^T and a lane's rows at a stride
        # of 32 added across the warp by a butterfly); match counts and
        # clocks exact.
        tol = [1e-4, 1e-4, 1e-3, 1e-3, 0.0, 1e-4, 1e-4, 1e-3, 0.0]
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        for i, (e, t) in enumerate(zip(errs, tol)):
            if not e <= t:
                raise RuntimeError(f"{name}: output {i} rel err {e:.3g} > {t}")
        again = cp.chain_points_call(*args, use_kin=use_kin)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{name}: two launches on the same inputs differ")
        nb, k = args[7].shape
        p = args[14].shape[1]
        px = ptxas_entry(f"chain_points_warp_kernelILb{int(use_kin)}E")
        log(f"[kernel] {name}: one warp, {px['registers']} registers, {px['spills']} B of spills, "
            f"{px['stack']} B stack frame, {px['smem']} B static + "
            f"{cp.staged_bytes(nb, k, p, use_kin)} B staged shared memory (the ring of point rows "
            f"and the event rows); two launches bit-equal")
        if px["spills"]:
            raise RuntimeError(f"{name}: ptxas spills {px['spills']} B in the warp kernel")
        recs[name] = dict(
            max_abs_err=max(max_abs(a, b) for a, b in zip(got, ref)),
            ms=time_call(torch, lambda: cp.chain_points_call(*args, use_kin=use_kin), 50),
            plain_ms=time_call(torch, lambda: cp.chain_points_plain(*args, use_kin=use_kin), 3),
            bytes=nbytes(list(args) + list(got)), flops=chain_points_flops(nb, k, p, use_kin),
            tol="rel 1e-4 poses, 1e-3 covariances; counts and clocks exact; repeat bit-equal",
        )
        log(f"[kernel] {name}: rel errs {[f'{e:.2e}' for e in errs]}, "
            f"{int(got[4].sum())} matched rows, empty bucket count {int(got[4][2 * nb // 3])}, "
            f"gated-off bucket count {int(got[4][nb // 3])}")

    kargs = keys_inputs(torch, dev, rng)
    got = mg.keys_call(*kargs, 3, 1 << 14)
    again = mg.keys_call(*kargs, 3, 1 << 14)
    torch.cuda.synchronize()
    ref = mg.keys_plain(*kargs, 3, 1 << 14)
    # Keys, centres and probe starts are computed un-fused on both sides:
    # exact.  p_i/p_w rel 1e-6; covariances rel 1e-5 (FMAs in the sandwiches).
    for i in (2, 3, 4):
        if not torch.equal(got[i], ref[i]):
            raise RuntimeError(f"keys: output {i} differs in {(got[i] != ref[i]).sum()} entries")
    e_piw, e_cov = rel_err(got[0], ref[0]), rel_err(got[1], ref[1])
    if not (e_piw <= 1e-6 and e_cov <= 1e-5):
        raise RuntimeError(f"keys: rel errs piw {e_piw:.3g} covs {e_cov:.3g}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError("keys: two launches on the same inputs differ")
    px = ptxas_entry("keys_kernel")
    log(f"[kernel] keys: a block of four warps a 32-row tile, {px['registers']} registers, "
        f"{px['spills']} B of spills, {px['stack']} B stack frame, {px['smem']} B static shared memory; "
        f"two launches bit-equal")
    if px["spills"]:
        raise RuntimeError(f"keys: ptxas spills {px['spills']} B")
    c = kargs[1].shape[1]
    recs["keys"] = dict(
        max_abs_err=max(max_abs(a, b) for a, b in zip(got, ref)),
        ms=time_call(torch, lambda: mg.keys_call(*kargs, 3, 1 << 14), 200),
        plain_ms=time_call(torch, lambda: mg.keys_plain(*kargs, 3, 1 << 14), 20),
        bytes=nbytes(list(kargs) + list(got)), flops=650.0 * c,  # ~650 flops a row
        tol="keys/centres/probe starts exact; rel 1e-6 points, 1e-5 covariances",
    )
    log(f"[kernel] keys: exact keys, rel errs piw {e_piw:.2e} covs {e_cov:.2e}")

    px = ptxas_entry("select_kernel")
    log(f"[kernel] select: one launch a call, {px['registers']} registers, {px['spills']} B of spills, "
        f"{px['stack']} B stack frame, {px['smem']} B static shared memory (its staging is dynamic, "
        f"sized at launch)")
    if px["spills"]:
        raise RuntimeError(f"select: ptxas spills {px['spills']} B")
    srng = np.random.default_rng(17)  # the later kernels' inputs stay as they were
    for name, nb in (("select", 28), ("select_56", 56)):
        sargs = select_inputs(torch, dev, rng if nb == 28 else srng, got, nb=nb)
        (out, s40, nm), (r_out, r_s40, r_nm), e = select_check(torch, sargs, 3, nb)
        # The same rows with their bucket indices shuffled (bucket 1 empty):
        # each bucket block gathers its rows wherever they lie.
        _, _, e_sh = select_check(torch, shuffled_bidx(torch, sargs, srng, empty=1), 3, nb)
        c = sargs[1].shape[1]
        same = out[0] == r_out[0]
        recs[name] = dict(
            max_abs_err=max(max_abs(out[:, same], r_out[:, same]), max_abs(s40, r_s40), max_abs(nm, r_nm)),
            ms=time_call(torch, lambda: mg.select_call(*sargs, 3, nb), 200),
            plain_ms=time_call(torch, lambda: mg.select_plain(*sargs, 3, nb), 10),
            bytes=nbytes(list(sargs) + [out, s40, nm]),
            flops=c * (6 * 200 + 80 + 820 * 3),  # 6 candidates, features, s40 sums
            tol=SELECT_TOL,
        )
        log(f"[kernel] {name}: NB = {nb}, {e['flips']} gate flips, rel errs rows {e['e_rows']:.2e} "
            f"sums {e['e_sum']:.2e} s40-vs-plain {e['e_s40']:.2e}; shuffled bidx, bucket 1 empty: "
            f"{e_sh['flips']} flips, rows {e_sh['e_rows']:.2e} sums {e_sh['e_sum']:.2e} "
            f"s40-vs-plain {e_sh['e_s40']:.2e}; two launches bit-equal")

    px = ptxas_entry("moments_kernel")
    log(f"[kernel] moments: a warp a 32-row tile, rows read by index, {px['registers']} registers, "
        f"{px['spills']} B of spills, {px['stack']} B stack frame, {px['smem']} B static shared memory")
    if px["spills"]:
        raise RuntimeError(f"moments: ptxas spills {px['spills']} B")
    margs = moments_inputs(torch, dev, rng)
    got = ir.moments_rows_call(*margs)
    again = ir.moments_rows_call(*margs)
    torch.cuda.synchronize()
    ref = ir.moments_rows_plain(*margs)
    got69, ref69 = torch.cat(got, dim=1), torch.cat(ref, dim=1)
    e_mom = max(rel_err(got69[:, i], ref69[:, i]) for i in range(69))
    if not e_mom <= 1e-4:  # per moment row, rel to its magnitude (FMAs)
        raise RuntimeError(f"moments: rel err {e_mom:.3g}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError("moments: two launches on the same inputs differ")
    r, nb = margs[8].shape[0], margs[2].shape[0]
    recs["moments"] = dict(
        max_abs_err=max_abs(got69, ref69),
        ms=time_call(torch, lambda: ir.moments_rows_call(*margs), 200),
        plain_ms=time_call(torch, lambda: ir.moments_rows_plain(*margs), 20),
        bytes=moments_bytes(margs), flops=380.0 * r,  # ~380 flops a row
        tol="rel 1e-4 per moment row; repeat bit-equal",
    )
    log(f"[kernel] moments: R = {r}, NB = {nb}, rel err {e_mom:.2e}; two launches bit-equal")

    for frag, tag in (("fit_slots_kernelIf", "f32"), ("fit_slots_kernelI6__half", "f16"),
                      ("fit_slots_kernelI13__nv_bfloat16", "bf16")):
        px = ptxas_entry(frag)
        log(f"[kernel] fit ({tag} moms): an eigen warp and two contraction warps (eight lanes a slot) "
            f"a block of eight slots, {px['registers']} registers, "
            f"{px['spills']} B of spills, {px['stack']} B stack frame, {px['smem']} B static shared memory")
        if px["spills"]:
            raise RuntimeError(f"fit: ptxas spills {px['spills']} B in the {tag} instantiation")
    fargs, n_real = fit_inputs(torch, dev)
    got = pfr.fit_slots_call(*fargs)
    again = pfr.fit_slots_call(*fargs)
    torch.cuda.synchronize()
    ref = pfr.fit_slots_plain(*fargs)
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError("fit: non-finite output")
    if not torch.equal(got, again):
        raise RuntimeError("fit: two launches on the same inputs differ")
    n_flip, e_head, e_pv, err = fit_check(torch, "fit", got, ref, max_flips=2)
    rt = ref.T
    b = fargs[4].shape[0]
    recs["fit"] = dict(
        max_abs_err=err,
        ms=time_call(torch, lambda: pfr.fit_slots_call(*fargs), 200),
        plain_ms=time_call(torch, lambda: pfr.fit_slots_plain(*fargs), 5),
        bytes=fit_bytes(fargs), flops=FIT_FLOPS_PER_SLOT * b,
        tol="<= 2 branch flips in 1024 slots; abs 1e-5 centre/normal/evals/radius; "
            "plane_var 1e-4 of the row's largest entry; repeat bit-equal",
    )
    log(f"[kernel] fit: {n_real} map rows + {b - n_real} sentinel rows, {int(rt[34].sum())} planes, "
        f"{n_flip} branch flips, head err {e_head:.2e}, plane_var rel {e_pv:.2e}, "
        f"bit-equal {bool(torch.equal(got, ref))}; two launches bit-equal")

    for spt in (1, 2):  # MP <= 1,024 (pose at 128, pose_384) and MP 1,025-2,048 (pose_1280)
        px = ptxas_entry(f"pose_kernelILi{spt}E")
        log(f"[kernel] pose: one block, {spt} slot(s) a thread, {px['registers']} registers, "
            f"{px['spills']} B of spills, {px['stack']} B stack frame")
        if px["spills"]:
            raise RuntimeError(f"pose: ptxas spills {px['spills']} B in pose_kernel<{spt}>")
    for name, (nb, k) in (("pose", (28, 1)), ("pose_384", (28, 12)), ("pose_1280", (256, 4))):
        pargs = pose_inputs(torch, dev, rng, nb, k)
        got = pp.pose_call(*pargs)
        torch.cuda.synchronize()
        ref = pp.pose_plain(*pargs)
        mp = pargs[1].shape[1]
        # The same operations in the same order on both sides: bit-equal.
        if not torch.equal(got, ref):
            raise RuntimeError(f"{name}: max abs err {max_abs(got, ref):.3g} at MP = {mp}: "
                               f"not bit-equal to the plain version")
        rec = dict(
            max_abs_err=max_abs(got, ref),
            ms=time_call(torch, lambda: pp.pose_call(*pargs), 200),
            plain_ms=time_call(torch, lambda: pp.pose_plain(*pargs), 5),
            bytes=nbytes(list(pargs) + [got]), flops=pose_flops(mp),
            tol="bit-equal",
        )
        log(f"[kernel] {name}: MP = {mp}, bit-equal")
        recs[name] = rec
    recs["claim"] = claim_record(torch)
    recs["probe_planes"] = probe_planes_record(torch)
    floor_ms = launch_floor_ms(torch)
    log(f"[floor] an empty kernel from the library: {floor_ms:.4f} ms a launch "
        f"(CUDA events, 200 launches queued behind the spin; the floor under every kernel ms above)")
    for name, rec in recs.items():
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"])
        log(f"[kernel] {name}: ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
            f"bound_ms {rec['bound_ms']:.6f} ({rec['bound_by']}) tol: {rec['tol']}")
    return recs


CLAIM_B = 64              # the claim record's fleet (the fleet kernels' B = 64)
CLAIM_CAPACITY_LOG2 = 16  # the fused cells' map: 2^16 slots a level, probe 8, 6 rounds
CLAIM_PROBE, CLAIM_ROUNDS = 8, 6
CLAIM_DURATION_S = 1.0    # the sim the claim fleets step through


def claim_config(capacity_log2=CLAIM_CAPACITY_LOG2, points=False):
    """bench.py's configuration (``points``: on the per-point path) with the
    benchmark cells' claims: probe 8, 6 rounds, 2^capacity_log2 slots a
    level."""
    from legkilo_torch.runner import bench_config, bench_config_points

    cfg = bench_config_points() if points else bench_config()
    cfg.voxel_map.capacity_log2 = capacity_log2
    cfg.voxel_map.probe_length = CLAIM_PROBE
    cfg.voxel_map.insert_rounds = CLAIM_ROUNDS
    return cfg


def fleet_captures(torch, cfg, data, b, where, n_steps=2, use_kin=False):
    """The inputs of a wrapper's calls in a broadcast fleet of ``b``
    replicas of ``data`` on the card (q_diag jittered), each copied before
    its call: ``where`` is (module, name) of the wrapper as its caller
    looks it up.  The first frame (fleet_init's for its first replica; it
    builds each replica's map on its own), then each of ``n_steps`` fleet
    steps, the first call of each.  Returns a list of (tag, args), tags
    "first_frame", "step1", ..."""
    from legkilo_torch.core.filter_fleet import replica
    from legkilo_torch.io.dataset import to_device_packet
    from legkilo_torch.parallel.sweep import broadcast_packets, make_fleet_step, perturb_params

    module, name = where
    caps, real, tag = [], getattr(module, name), ["first_frame"]

    def record(*args):
        if not caps or tag[0] != caps[-1][0]:
            caps.append((tag[0], tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)))
        return real(*args)

    setattr(module, name, record)
    try:
        scfg, carry, params1, seqs = fleet_start(torch, cfg, [data] * b, use_kin=use_kin)
        params = perturb_params(replica(params1, 0), b, scale=FLEET_NOISE, seed=0)
        step = make_fleet_step(scfg)
        for k, p in enumerate(seqs[0][:n_steps], start=1):
            tag[0] = f"step{k}"
            carry, _, _ = step(carry, broadcast_packets(to_device_packet(p, "cuda"), b), params)
        torch.cuda.synchronize()
    finally:
        setattr(module, name, real)
    return caps


def claim_captures(torch, cfg, data, b, n_steps=2):
    """The claim series' inputs (``fleet_captures``: the first frame's
    insert_points, then each step's insert), as (tag, (ptab_x, keys, seg,
    active, capacity, probe, rounds))."""
    from legkilo_torch.core import voxel_map

    return fleet_captures(torch, cfg, data, b, (voxel_map, "claim_call"), n_steps)


def claim_check(torch, cap):
    """The claim kernel and claim_plain on copies of one captured call:
    (bit-equal, counts).  Bit-equal: the table but its sentinel row, the
    slots and the flags ``torch.equal``."""
    from legkilo_torch.ops import claim_slots as cl

    ptab_x, keys, seg, active, c, p, r = cap
    miss = ptab_x.shape[0] - 1
    t_k, t_p = ptab_x.clone(), ptab_x.clone()
    got = cl.claim_call(t_k, keys, seg, active, c, p, r)
    want = cl.claim_plain(t_p, keys, seg, active, c, p, r)
    same = torch.equal(t_k[:miss], t_p[:miss]) and all(torch.equal(a, b) for a, b in zip(got, want))
    new = (t_p[:miss, 3] > 0) & (ptab_x[:miss, 3] <= 0)
    return same, dict(rows=keys.shape[0], active=int(active.sum()), claimed=int(new.sum()),
                      failed=int((active & ~want[1]).sum()))


def claim_sub(torch, cap, b, bb):
    """A captured call of ``b`` replicas cut to its first ``bb``: their
    segments, a sentinel row, their rows (replica-major)."""
    ptab_x, keys, seg, active, c, p, r = cap
    n_slot = (ptab_x.shape[0] - 1) // b * bb
    n_row = keys.shape[0] // b * bb
    tab = torch.cat([ptab_x[:n_slot], ptab_x.new_zeros((1, ptab_x.shape[1]))])
    return tab, keys[:n_row], seg[:n_row], active[:n_row], c, p, r


def claim_bytes(cap) -> int:
    """Bytes a claim call must move at least: the memset of the bid words
    (4 B a slot), every launch's flags (2 B a row), one probe of each
    active row (its key, segment and outputs, 49 B, and 16 B of each
    window slot)."""
    ptab_x, keys, seg, active, c, probe, rounds = cap
    return (4 * ptab_x.shape[0] + 2 * (2 * rounds + 1) * keys.shape[0]
            + int(active.sum()) * (49 + 16 * probe))


def time_claim(torch, fn, cap, iters: int, spin: int) -> float:
    """Median device ms of ``fn`` on a fresh copy of the captured table each
    call (the copy outside the events), every call queued behind a spin of
    ``spin`` cycles."""
    ptab_x, *rest = cap
    tab = ptab_x.clone()
    fn(tab, *rest)
    ms = []
    for _ in range(iters):
        tab.copy_(ptab_x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn(tab, *rest)
        end.record()
        ms.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ms]))


def claim_record(torch):
    """The claim kernel at a fused fleet's shapes: 64 replicas, 2^16 slots
    a level, probe 8, 6 rounds, the first frame's and two steps' calls
    ``torch.equal`` to claim_plain; ptxas lines (no spills); ms of the
    second step's call at B = 1, 8 and 64 beside the bound."""
    from legkilo_torch.ops import claim_slots as cl

    for frag in ("claim_probe_kernel", "claim_award_kernel"):
        px = ptxas_entry(frag)
        log(f"[kernel] claim ({frag}): a thread a row, grid-stride, {px['registers']} registers, "
            f"{px['spills']} B of spills, {px['stack']} B stack frame, {px['smem']} B static shared memory")
        if px["spills"]:
            raise RuntimeError(f"claim: ptxas spills {px['spills']} B in {frag}")
    caps = claim_captures(torch, claim_config(), simulate(CLAIM_DURATION_S, "claim"), CLAIM_B)
    for tag, cap in caps:
        same, n = claim_check(torch, cap)
        log(f"[kernel] claim: B = {CLAIM_B} {tag}: {n['rows']} rows, {n['active']} active, "
            f"{n['claimed']} slots claimed, {n['failed']} failed claims; bit-equal {same}")
        if not same:
            raise RuntimeError(f"claim: the kernel and claim_plain differ on the {tag} call")
    cap = caps[-1][1]
    if not torch.equal(*[cl.claim_call(cap[0].clone(), *cap[1:])[0] for _ in range(2)]):
        raise RuntimeError("claim: two launches on the same inputs differ")
    by_b = {}
    for bb in FLEET_KERNEL_BS:
        sub = claim_sub(torch, cap, CLAIM_B, bb)
        by_b[bb] = (time_claim(torch, cl.claim_call, sub, 20, 4_000_000),
                    bound(claim_bytes(sub), 0.0)[0])
    log("[kernel] claim: ms / bound ms " + ", ".join(
        f"B = {bb}: {ms:.4f} / {bd:.6f}" for bb, (ms, bd) in by_b.items())
        + "; two launches bit-equal")
    return dict(max_abs_err=0.0, ms=by_b[CLAIM_B][0],
                plain_ms=time_claim(torch, cl.claim_plain, cap, 5, 40_000_000),
                bytes=claim_bytes(cap), flops=0.0,
                tol="bit-equal (table but its sentinel row, slots, flags); repeat bit-equal")


PROBE_B = 64               # the probe record's fleet (the fleet kernels' B = 64)
PROBE_CAP = 4096          # the fused cells' match and insert caps
PROBE_FRAGMENTS = (("probe_planes_kernelIf", "f32"), ("probe_planes_kernelI6__half", "f16"),
                   ("probe_planes_kernelI13__nv_bfloat16", "bf16"))


def probe_config():
    """The fused match of ``go1_imu`` (BENCHMARK.json): bench.py's buckets
    (NB 28, P 256) with caps 4,096 and 2^16 slots a level, probe 8, 6
    rounds."""
    cfg = claim_config()
    cfg.tpu.insert_cap = cfg.tpu.match_cap = PROBE_CAP
    return cfg


def probe_captures(torch, b, n_steps=2):
    """The fused match's probe calls (``fleet_captures``) in a fleet of
    ``b`` replicas of the bench sim at ``probe_config()``: one a step, as
    (tag, (ptab, plane, keys_t, idx0_t, capacity, probe, dtype))."""
    from legkilo_torch.core import filter_deferred

    data = simulate(CLAIM_DURATION_S, "probe")
    return fleet_captures(torch, probe_config(), data, b, (filter_deferred, "probe_planes_call"), n_steps)


def probe_check(torch, cap):
    """The probe kernel and probe_planes_plain on one captured call:
    (bit-equal, counts of rows, candidates and own-chain hits)."""
    from legkilo_torch.ops import probe_planes as pr

    got = pr.probe_planes_call(*cap)
    want = pr.probe_planes_plain(*cap)
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    l2, r = cap[3].shape
    return same, dict(rows=r, candidates=l2 * r, hits=int(want[1][:l2].sum()), own_hits=int(want[3].sum()),
                      planes=int(want[4].sum()))


def probe_sub(torch, cap, b, bb):
    """A captured call of ``b`` replicas cut to its first ``bb``: their
    tables' rows and their match rows."""
    ptab, plane, keys_t, idx0_t, c, p, dtype = cap
    n_slot, n_row = ptab.shape[0] // b * bb, keys_t.shape[1] // b * bb
    return (ptab[:n_slot], plane[:n_slot], keys_t[:, :n_row].contiguous(),
            idx0_t[:, :n_row].contiguous(), c, p, dtype)


def probe_bytes(cap) -> int:
    """Bytes a probe call must move at least: the keys and probe starts
    read (32 B a row and level), the outputs written (plane_t 2L x 31
    floats, flags 4L floats, slot, found and is_plane of L a row).  The
    table reads are left out: neighbouring rows share their voxels."""
    l2, r = cap[3].shape
    return r * (4 * (3 * l2 + l2) + 4 * (31 * l2 + 2 * l2) + (l2 // 2) * (8 + 2))


def probe_planes_record(torch):
    """The probe kernel at the fused cells' shapes: a fleet of 64 at 2^16
    slots a level (probe 8, caps 4,096), each step's call ``torch.equal`` to
    probe_planes_plain; ptxas lines of the three storage instantiations (no
    spills); ms of the second step's call at B = 1, 8 and 64 beside the
    bound; two launches bit-equal."""
    from legkilo_torch.ops import probe_planes as pr

    for frag, tag in PROBE_FRAGMENTS:
        px = ptxas_entry(frag)
        log(f"[kernel] probe_planes ({tag} planes): a thread a (candidate, row), a warp's plane rows "
            f"through a shared tile, {px['registers']} registers, {px['spills']} B of spills, "
            f"{px['stack']} B stack frame, {px['smem']} B static shared memory")
        if px["spills"]:
            raise RuntimeError(f"probe_planes: ptxas spills {px['spills']} B in {frag}")
    caps = probe_captures(torch, PROBE_B)
    for tag, cap in caps:
        same, n = probe_check(torch, cap)
        log(f"[kernel] probe_planes: B = {PROBE_B} {tag}: {n['rows']} rows, {n['candidates']} "
            f"candidates, {n['hits']} found ({n['own_hits']} own chain, {n['planes']} planes); "
            f"bit-equal {same}")
        if not same:
            raise RuntimeError(f"probe_planes: the kernel and probe_planes_plain differ on the {tag} call")
    cap = caps[-1][1]
    once, again = pr.probe_planes_call(*cap), pr.probe_planes_call(*cap)
    if not all(torch.equal(a, b) for a, b in zip(once, again)):
        raise RuntimeError("probe_planes: two launches on the same inputs differ")
    by_b = {}
    for bb in FLEET_KERNEL_BS:
        sub = probe_sub(torch, cap, PROBE_B, bb)
        by_b[bb] = (time_call(torch, lambda: pr.probe_planes_call(*sub), 50),
                    bound(probe_bytes(sub), 0.0)[0], probe_bytes(sub))
    log("[kernel] probe_planes: ms / bound ms (bytes) " + ", ".join(
        f"B = {bb}: {ms:.4f} / {bd:.6f} ({nb:,})" for bb, (ms, bd, nb) in by_b.items())
        + "; two launches bit-equal")
    return dict(max_abs_err=0.0, ms=by_b[PROBE_B][0],
                plain_ms=time_call(torch, lambda: pr.probe_planes_plain(*cap), 5),
                bytes=probe_bytes(cap), flops=0.0,
                tol="bit-equal (plane_t, flags, slot, found, is_plane); repeat bit-equal")


def wrappers():
    from legkilo_torch.ops import chain_points as cp, chain_stats as cs, claim_slots as cl
    from legkilo_torch.ops import insert_rows as ir, match_geom as mg, plane_fit_rows as pfr
    from legkilo_torch.ops import pose_prop as pp, probe_planes as pr

    return {"chain_stats": cs.chain_call, "keys": mg.keys_call, "select": mg.select_call,
            "moments": ir.moments_rows_call, "fit": pfr.fit_slots_call, "pose": pp.pose_call,
            "chain_points": cp.chain_points_call, "claim": cl.claim_call,
            "probe_planes": pr.probe_planes_call}


def only_the_claims(counts) -> bool:
    """Whether a run off the switched kernels launched only the claim kernel
    (ALWAYS_KERNELS), and that one."""
    return all(v > 0 if k in ALWAYS_KERNELS else v == 0 for k, v in counts.items())


def reset_counters():
    for fn in wrappers().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in wrappers().items()}


def simulate(duration: float, tag: str):
    from legkilo_torch.models import sim

    t0 = time.perf_counter()
    data = sim.simulate(sim.SimConfig(duration=duration, scan_points=8000, seed=7))
    log(f"[{tag}] sim {duration} s: {len(data.scans)} scans in {time.perf_counter() - t0:.1f} s")
    return data


def path_config(five=True, points=False):
    """bench.py's configuration on the fused path (``five`` off: pose and
    refit in plain torch) or on the per-point path, and the set of wrappers
    whose kernels that path launches."""
    from legkilo_torch.runner import bench_config, bench_config_points

    if points:
        return bench_config_points(), POINTS_KERNELS
    cfg = bench_config()
    cfg.tpu.use_pallas_pose = cfg.tpu.use_pallas_refit = five
    return cfg, FUSED_KERNELS if five else FOUR_KERNELS


def run_workload(torch, data, tag: str, use_kin=False, five=True, chunk=0, latch=True,
                 points=False, edit=None, slides=False, config=None, keep=False, window=None,
                 min_scans=30):
    """One run_offline over ``data`` on the card.  ``five`` off leaves the
    pose and refit kernels out (plain torch); ``points`` takes the per-point
    path; ``config()`` gives a configuration and the wrappers its path
    launches in their place; ``chunk`` > 1 replays in chunks; ``latch`` off
    disables the escalation to iterated matching; ``edit(cfg)`` changes the
    configuration further and returns the wrappers its path leaves out;
    ``slides`` replays scan by scan (as run_offline streams) and counts the
    map slides, each seen as a move of the carry's last slide position, and
    fails on fewer than two; ``keep`` replays scan by scan too and keeps
    the poses and the final carry in the record (``poses``, ``carry``; not
    logged); ``window`` = (tag, n_warm, n_prof) replays scan by scan too
    and traces the card's activity over ``n_prof`` scans after ``n_warm``
    (``profile_window``; those scans are left out of ``ms_per_scan``).
    Fails on an ATE that is not finite or not under the golden bound, on a
    kernel of the path that never launched and on a kernel off the path
    that did."""
    from legkilo_torch.io.tum import ate_rmse
    from legkilo_torch.runner import OdometryRunner, replay, run_offline

    cfg, on_path = config() if config is not None else path_config(five, points)
    cfg.only_imu_use = not use_kin
    if not latch:
        cfg.tpu.escalate_after = 0
    if edit is not None:
        on_path = on_path - edit(cfg)
    events = data.kin if use_kin else data.imu
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_slides = 0
    prof = None
    if slides or keep or window:
        runner = OdometryRunner(cfg, device="cuda")
        last = runner.carry.last_slide_pos
        steps = replay(runner, data.scans, events)
        if window:
            for _ in itertools.islice(steps, window[1]):
                pass
            prof = profile_window(torch, runner, steps, window[2])
        for _ in steps:
            now = runner.carry.last_slide_pos
            n_slides += int(not torch.equal(now, last))
            last = now
        results = runner.results
    else:
        results = run_offline(cfg, data.scans, events, device="cuda", chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    n_timed = len(results)
    if prof is not None:
        wall -= prof.pop("wall_s")
        n_timed -= prof["scans"]
    _, gt = data.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(data.gt_times)}
    pairs = [(r.pos, gt[gtm[round(r.time, 6)]]) for r in results if round(r.time, 6) in gtm]
    ate = ate_rmse(np.stack([p for p, _ in pairs]), np.stack([g for _, g in pairs]), align=False)
    rec = dict(scans=len(results), ate_m=ate, ms_per_scan=wall / n_timed * 1e3,
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=counts)
    if slides:
        rec["slides"] = n_slides
    log(f"[{tag}] {json.dumps(rec)}")
    if prof is not None:
        log_profile(window[0], prof, prof.pop("rows"))
        rec["profile"] = prof
    if keep:
        rec["poses"] = [(r.rot, r.pos) for r in results]
        rec["carry"] = runner.carry
    if len(results) < min_scans:
        raise RuntimeError(f"{tag}: only {len(results)} scans")
    if slides and n_slides < 2:
        raise RuntimeError(f"{tag}: {n_slides} map slides, expected at least 2")
    if not np.isfinite(ate) or ate >= ATE_BOUND_M:
        raise RuntimeError(f"{tag}: ATE {ate:.4f} m >= {ATE_BOUND_M} m")
    on_path = set(on_path) | ALWAYS_KERNELS
    missing = sorted(k for k in on_path if counts[k] <= 0)
    stray = sorted(k for k, v in counts.items() if v > 0 and k not in on_path)
    if missing or stray:
        raise RuntimeError(f"{tag}: kernels of the path never launched: {missing}; "
                           f"kernels off the path launched: {stray}")
    return rec


def cut(data, duration: float):
    """``data`` with its scans cut to the first ``duration`` seconds and its
    event streams to 0.5 s past the last of them: as far as a replay feeds
    events (runner._scans_after_their_events), so a bag written from it
    holds no more."""
    import copy

    out = copy.copy(data)
    out.scans = data.scans[: int(duration * 10)]
    horizon = out.scans[-1].end_time + 0.5
    out.imu = [e for e in data.imu if e.time <= horizon]
    out.kin = [e for e in data.kin if e.time <= horizon]
    return out


def slide_edit(cfg):
    """The map slide (map_sliding_en, a threshold the path crosses several
    times) with the constant-velocity match pose, which takes the pose
    kernel off the path."""
    cfg.voxel_map.map_sliding_en = True
    cfg.voxel_map.sliding_thresh = SLIDE_THRESH_M
    cfg.voxel_map.half_map_size = SLIDE_HALF_MAP
    cfg.tpu.match_pose = "const_vel"
    return {"pose"}


def ref2ms_edit(cfg):
    """bench.py's 2 ms buckets (bench.py:350-366): NB = 56, P = 128."""
    cfg.tpu.bucket_quantum_ms = 2.0
    cfg.tpu.max_buckets = 56
    cfg.tpu.max_points_per_bucket = 128
    return set()


def sim_cli_config(path=None):
    """A configuration as ``python -m legkilo_torch sim`` loads it: the file
    as written (``Config()`` without one), with the sim rig's decimation
    (filter_num 1, blind 0.3)."""
    from legkilo_torch import config as config_mod

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = config_mod.load(os.path.join(root, path)) if path else config_mod.Config()
    cfg.lidar.filter_num = 1
    cfg.lidar.blind = 0.3
    return cfg


def leg_fusion_config():
    """configs/leg_fusion.yaml: the fused path with every kernel switch at
    its default, off (NB 64, P 128, K 4, caps 4,096, 3 x 2^17 slots)."""
    return sim_cli_config("configs/leg_fusion.yaml"), set()


def mixed_config():
    """bench.py's configuration with the match kernels off: the match on
    its torch path feeding the chain, moments, pose and refit kernels."""
    from legkilo_torch.runner import bench_config

    cfg = bench_config()
    cfg.tpu.use_pallas_match = False
    return cfg, MIXED_KERNELS


def seq_config():
    """The default Config(): the sequential pipeline, IMU (NB 64, P 128)."""
    return sim_cli_config(), set()


def seq_kin_config():
    """configs/diter.yaml: the sequential pipeline with leg kinematics."""
    return sim_cli_config("configs/diter.yaml"), set()


def phase_repeat(torch, data):
    """``main``'s configuration streamed twice over the same scans: the
    trajectories and every final map table must be equal bit for bit (the
    map's scatter-adds are summed in row order on the card)."""
    a = run_workload(torch, data, "repeat", keep=True)
    b = run_workload(torch, data, "repeat", keep=True)
    same_traj = all(np.array_equal(ra, rb) and np.array_equal(pa, pb)
                    for (ra, pa), (rb, pb) in zip(a["poses"], b["poses"]))
    same_traj = same_traj and len(a["poses"]) == len(b["poses"])
    tables = {f: torch.equal(getattr(a["carry"].vm, f), getattr(b["carry"].vm, f))
              for f in ("ptab", "meta", "mom", "moms", "plane", "ocnt")}
    log(f"[repeat] trajectories equal {same_traj}; map tables equal {json.dumps(tables)}")
    if not same_traj or not all(tables.values()):
        raise RuntimeError("repeat: two runs of one configuration differ")


# runner.bench_config() as the flat YAML keys of legkilo_torch/config.py, for
# ``run --config_file``; the bag phases check that the file loads back equal.
BENCH_YAML_KEYS = {
    "filter_num": 1, "blind": 0.3, "voxel_grid_resolution": 0.3,
    "tpu_map_capacity_log2": 14, "tpu_map_insert_rounds": 1, "tpu_map_insert_row_cap": 4096,
    "tpu_map_refit_budget": 1024, "tpu_map_probe_length": 4,
    "tpu_bucket_quantum_ms": 4.0, "tpu_max_buckets": 28, "tpu_max_points_per_bucket": 256,
    "tpu_max_imu_per_bucket": 1, "tpu_insert_cap": 3584, "tpu_match_cap": 3584,
    "tpu_pipeline": "deferred", "tpu_use_pallas": True, "tpu_use_pallas_match": True,
    "tpu_use_pallas_insert": True, "tpu_use_pallas_pose": True, "tpu_use_pallas_refit": True,
}


def bag_config_file(path: str, use_kin: bool) -> None:
    """Write bench.py's configuration with ``redundancy`` off (the sim
    repeats no sample) as a YAML file, and check it loads back equal."""
    from legkilo_torch import config as config_mod
    from legkilo_torch.runner import bench_config

    keys = dict(BENCH_YAML_KEYS, only_imu_use=not use_kin, redundancy=False)
    with open(path, "w") as f:
        f.writelines(f"{k}: {json.dumps(v)}\n" for k, v in keys.items())
    want = bench_config()
    want.only_imu_use, want.redundancy = not use_kin, False
    if config_mod.load(path) != want:
        raise RuntimeError(f"{path} does not load back as bench_config()")


def cli_json(cli, argv):
    """``cli.main(argv)`` in this process: its return code must be 0; the
    JSON object of the last line it prints."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"legkilo_torch {argv[0]}: exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_bag(torch, data, tag: str, use_kin: bool, bound: float, kernels):
    """``python -m legkilo_torch run`` in this process on the card, on
    ``data`` written as a ROS1 bag (Imu, or with ``use_kin`` HighState
    from the feet by IK, and PointCloud2 with intensity; stamps + 1000 s),
    with bench.py's configuration from a YAML file, the trajectory, the
    PCD export and the plane export on; then ``eval`` against the sim's
    ground truth as TUM.  Fails on an ATE (nearest time within 10 ms, no
    alignment, tests/test_bag_e2e.py:58-66) not under ``bound``, on a
    kernel of ``kernels`` launched fewer times than there are scans
    (PointCloud2 messages; with K = 1 each brings an event-only packet
    too, which runs the whole step), on fewer poses associated with the
    ground truth than scans, on a kernel off the path launched, on a PLY
    of 100 vertices or fewer and on a PCD file that does not read back."""
    import glob
    import shutil

    from legkilo_torch import cli
    from legkilo_torch.config import KinematicsConfig
    from legkilo_torch.io.pcd import read_pcd
    from legkilo_torch.io.tum import associate, ate_rmse, read_tum

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "bag_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    bag, cfg, gt = (os.path.join(root, f"{tag}{e}") for e in (".bag", ".yaml", "_gt.txt"))
    traj, ply, pcd_dir = (os.path.join(root, f"{tag}{e}") for e in (".txt", ".ply", "_pcd"))
    t0 = time.perf_counter()
    write_bag(bag, kin_bag_messages(data, KinematicsConfig()) if use_kin else imu_bag_messages(data))
    bag_config_file(cfg, use_kin)
    write_gt_tum(gt, data)
    t_write = time.perf_counter() - t0
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = cli_json(cli, ["run", "--config_file", cfg, "--bag", bag, "--traj_out", traj,
                         "--save_pcd", pcd_dir, "--export_planes", ply])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    ev = cli_json(cli, ["eval", "--est", traj, "--gt", gt, "--max_dt", "0.01"])
    t, p, _ = read_tum(traj)
    _, gt_pos = data.gt_in_filter_frame()
    ia, ib = associate(t, data.gt_times + BAG_TIME_OFFSET_S, max_dt=0.01)
    ate = ate_rmse(p[ia], gt_pos[ib], align=False)
    with open(ply) as f:
        n_vert = int(next(l for l in f if l.startswith("element vertex")).split()[-1])
    pcds = sorted(glob.glob(os.path.join(pcd_dir, "*", "*.pcd")))
    clouds = [read_pcd(f) for f in pcds]
    n_scans = len(data.scans)
    out = dict(scans=len(data.scans), results=rec["scans"], messages=rec["messages"],
               bag_mb=os.path.getsize(bag) / 2 ** 20, write_s=t_write, wall_s=wall,
               ms_per_scan=wall / len(data.scans) * 1e3, run_ms_per_result=rec["ms_per_scan"],
               decode_ms=rec["decode_ms"], step_ms=rec["step_ms"], packetizer=rec["packetizer"],
               match_ratio=rec["match_ratio"], ate_m=ate, pairs=int(len(ia)), eval=ev,
               ply_vertices=n_vert, pcd_files=len(pcds),
               pcd_points=int(sum(len(c) for c in clouds)),
               pcd_columns=sorted({c.shape[1] for c in clouds}), launches=counts)
    log(f"[{tag}] {json.dumps(out)}")
    log(f"[{tag}] host {out['ms_per_scan']:.3f} ms/scan over {len(data.scans)} scans "
        f"({rec['scans']} results); Timer: decode {rec['decode_ms']} ms, step {rec['step_ms']} ms; "
        f"packetizer {rec['packetizer']}")
    shutil.rmtree(root, ignore_errors=True)
    if not np.isfinite(ate) or ate >= bound or ev["ate_rmse_unaligned_m"] >= bound:
        raise RuntimeError(f"{tag}: ATE {ate:.4f} m (eval {ev}) >= {bound} m")
    if len(ia) < n_scans:
        raise RuntimeError(f"{tag}: {len(ia)} poses associated with the ground truth")
    kernels = set(kernels) | ALWAYS_KERNELS
    missing = sorted(k for k in kernels if counts[k] < n_scans)
    stray = sorted(k for k, v in counts.items() if v > 0 and k not in kernels)
    if missing or stray:
        raise RuntimeError(f"{tag}: kernels launched fewer than {n_scans} times: {missing}; "
                           f"kernels off the path launched: {stray}")
    if n_vert <= 100:
        raise RuntimeError(f"{tag}: the plane PLY has {n_vert} vertices")
    if not clouds or not all(len(c) and np.isfinite(c).all() for c in clouds):
        raise RuntimeError(f"{tag}: the PCD export did not read back")
    return out


def packetizer_of(cfg, scan) -> str:
    """The packetizer ``cfg`` takes (native/libscanprep.so or numpy), as a
    PacketBuilder records it on one scan."""
    from legkilo_torch.io.dataset import PacketBuilder

    b = PacketBuilder(cfg)
    b.build_packet(scan, [])
    return b.packetizer


def device_rows(prof):
    """(device us, name, calls) for each operation the card ran (kernels and
    copies, so nothing counts twice) in a finished torch.profiler trace.
    Reads the profiler's raw events: building its Python event objects
    (``key_averages``) takes minutes for the ~10^5 launches a scan of the
    paths off the kernels, the raw events about a second."""
    by = {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        us, n = by.get(e.name(), (0.0, 0))
        by[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted(((us, key, n) for key, (us, n) in by.items()), reverse=True)


def log_launch_diff(tag, a, b, la, lb):
    """Log each device operation whose launches differ between the
    per-operation counts ``a`` (labelled ``la``) and ``b`` (``lb``)."""
    for key in sorted(set(a) | set(b)):
        if a.get(key, 0) != b.get(key, 0):
            log(f"[{tag}] launches {la} -> {lb}: {a.get(key, 0):.2f} -> {b.get(key, 0):.2f}  {key[:100]}")


def profile_window(torch, runner, steps, n_prof: int, host_ops=False):
    """Trace ``n_prof`` scans of the replay ``steps`` through ``runner`` with
    torch.profiler (the card's activity, and the host's with ``host_ops``),
    after flushing what came before.  Returns the window's scans, host wall
    (``wall_s`` in s, ``wall_ms_per_scan``), device busy ms and launches a
    scan, and the device ``rows``."""
    from torch.profiler import ProfilerActivity, profile

    runner.flush()
    torch.cuda.synchronize()
    n0 = len(runner.results)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in itertools.islice(steps, n_prof):
            pass
        runner.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    n = len(runner.results) - n0
    dev_ms = sum(r[0] for r in rows) / 1e3
    return dict(scans=n, wall_s=wall, wall_ms_per_scan=wall / n * 1e3,
                device_ms_per_scan=dev_ms / n, launches_per_scan=sum(r[2] for r in rows) / n,
                rows=rows)


def log_profile(tag: str, rec: dict, rows) -> None:
    n = rec["scans"]
    log(f"[{tag}] {n} scans: host wall {rec['wall_ms_per_scan']:.3f} ms/scan, device busy "
        f"{rec['device_ms_per_scan']:.3f} ms/scan "
        f"({100 * rec['device_ms_per_scan'] / rec['wall_ms_per_scan']:.1f}% of wall), "
        f"{rec['launches_per_scan']:.0f} device launches/scan")
    if not rows:
        log(f"[{tag}] device time: not measured (the profiler saw no CUDA activity)")
    for dev_us, key, count in rows[:12]:
        log(f"[{tag}]   {dev_us / n / 1e3:8.4f} ms/scan {count / n:6.1f} calls/scan  {key[:90]}")


def phase_profile(torch, tag: str, five=True, points=False, n_warm=10, n_prof=20):
    """torch.profiler over ``n_prof`` scans after ``n_warm`` warm-up scans,
    fed by run_offline's own replay loop: the device's busy share of the
    host wall clock, kernel launches a scan, and device time a scan by
    operator (ours and PyTorch's).  ``five`` off profiles the configuration
    without the pose and refit kernels, ``points`` the per-point path.
    (The paths off the kernels take their windows inside their own runs:
    ``run_workload(window=...)``.)"""
    from legkilo_torch.models import sim
    from legkilo_torch.runner import OdometryRunner, replay

    t_phase = time.perf_counter()
    data = sim.simulate(sim.SimConfig(duration=(n_warm + n_prof + 1) * 0.1, scan_points=8000, seed=7))
    cfg, _ = path_config(five, points)
    runner = OdometryRunner(cfg, device="cuda")
    steps = replay(runner, data.scans, data.imu)
    for _ in itertools.islice(steps, n_warm):
        pass
    rec = profile_window(torch, runner, steps, n_prof, host_ops=True)
    rec.pop("wall_s")
    log_profile(tag, rec, rec.pop("rows"))
    log(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")
    return rec


# ------------------------------------------------------------------ fleet --
#
# The fleet (legkilo_torch/parallel/sweep.py): on the five-kernel
# configuration one fleet step launches each of the six kernels once a match
# pass for all B replicas.

FLEET_B = 64                 # the fleet phase's replicas
FLEET_KERNEL_BS = (1, 8, 64)  # the kernels' fleet timings
FLEET_CHUNK = 8
FLEET_NOISE = 0.1            # sweep's default --noise_scale
FLEET_DURATION_S = 8.0       # main's workload, cut
FLEET_EQUAL_DURATION_S = 4.0
FLEET_EQUAL_B = 4
FLEET_SCALE_BS = (1, 8, 64, 256)
FLEET_SCALE_SCANS = 16
FLEET_BAG_DURATION_S = 4.0
FLEET_SUFFIX = "_fleet64"    # the kernels' entries at B = FLEET_B in the kernels line


def _stack_args(torch, singles, how):
    """One fleet argument list from B single ones: ``how[i]`` is "stack"
    (a new leading axis), "cat0" or "cat1" (side by side), or a function of
    (the B tensors) for the rest."""
    out = []
    for i, mode in enumerate(how):
        xs = [s[i] for s in singles]
        if mode == "stack":
            out.append(torch.stack(xs).contiguous())
        elif mode in ("cat0", "cat1"):
            out.append(torch.cat(xs, dim=int(mode[-1])).contiguous())
        else:
            out.append(mode(xs))
    return out


def _fit_tables_random(torch, dev, rng, m=600, budget=128):
    """fit_slots_call's inputs from the moments of m random planar patches
    (eight points each, a random orientation and offset each) and the
    sentinel row, 5/8 of the budget naming distinct slots at random: a
    replica's own tables, drawn from ``rng``."""
    from legkilo_torch.core import voxel_map as vmap
    from legkilo_torch.core.plane_fit import point_moments
    from legkilo_torch.ops import plane_fit_rows as pfr

    n = 8
    rot, _ = np.linalg.qr(rng.normal(size=(m, 3, 3)))
    local = rng.normal(scale=[0.3, 0.2, 0.01], size=(m, n, 3))
    pts_np = np.einsum("mij,mnj->mni", rot, local) + rng.uniform(-0.2, 0.2, size=(m, 1, 3))
    pts = torch.tensor(pts_np, dtype=torch.float32)
    var = torch.eye(3).expand(m, n, 3, 3) * 1e-4
    mom, moms = vmap._pack_moments(point_moments(pts.reshape(-1, 3), var.reshape(-1, 3, 3)))
    meta = torch.zeros((m + 1, 4))
    meta[:m, 0] = float(n)
    mom_x = torch.cat([mom.reshape(m, n, 9).sum(1), torch.zeros(1, 9)])
    moms_x = torch.cat([moms.reshape(m, n, 60).sum(1), torch.zeros(1, 60)])
    fs = torch.full((budget,), m, dtype=torch.int64)
    fs[: budget * 5 // 8] = torch.as_tensor(rng.choice(m, budget * 5 // 8, replace=False))
    return [pfr.fit_par(0.01, dev), meta.to(dev), mom_x.to(dev), moms_x.to(dev), fs.to(dev)]


def _fleet_kernel_cases(torch, dev, rng, b, small=False):
    """For each kernel with a replica axis (the six of the fused path, and
    the per-point chain's two branches as ``chain_points`` and
    ``chain_points_kin``): (fleet args, the B single-replica args,
    call(args), the B single outputs as the fleet's, bytes and flops of one
    replica).  Every replica draws its own inputs (fit: its own tables of
    2,048 random planar patches, 1,024 refit slots; the per-point chain:
    NB 28, P 256, the ``points`` shapes).  ``small``: the CPU tests' sizes
    (NB = 8, 256 match rows, 512 insert rows, maps of 3 x 2^11 slots,
    tables of 600 patches, 128 refit slots, P 128)."""
    from legkilo_torch.ops import chain_points as cp
    from legkilo_torch.ops import chain_stats as cs
    from legkilo_torch.ops import insert_rows as ir
    from legkilo_torch.ops import match_geom as mg
    from legkilo_torch.ops import plane_fit_rows as pfr
    from legkilo_torch.ops import pose_prop as pp

    L, C = 3, 1 << (11 if small else 14)
    nbs = 8 if small else 28
    cases = {}

    singles = [pose_inputs(torch, dev, rng, nbs, 1) for _ in range(b)]
    cases["pose"] = (_stack_args(torch, singles, ["stack", "stack"]), singles,
                     lambda a: pp.pose_call(*a), lambda outs: torch.stack(outs),
                     nbytes(list(singles[0])) + 12 * singles[0][1].shape[1] * 4,
                     pose_flops(singles[0][1].shape[1]))

    singles = [chain_holes(chain_inputs(torch, dev, rng, False, nb=nbs)) for _ in range(b)]
    nb, k = singles[0][6].shape
    cases["chain_stats"] = (
        _stack_args(torch, singles, ["stack"] * 14), singles,
        lambda a: cs.chain_call(*a, use_kin=False),
        lambda outs: tuple(torch.stack(xs) for xs in zip(*outs)),
        nbytes(list(singles[0])) + 4 * (nb * (9 + 3 + 9 + 9 + 1) + 9 + 27 + 900 + 2),
        chain_flops(nb, k, False))

    singles = [list(keys_inputs(torch, dev, rng, c=256 if small else 3584)) for _ in range(b)]
    c = singles[0][1].shape[1]

    def keys_fleet_of(outs):
        cat = [torch.cat(xs, dim=1) for xs in zip(*outs)]
        cat[4] = torch.cat([o[4] + r * L * C for r, o in enumerate(outs)], dim=1)
        return tuple(cat)

    cases["keys"] = (_stack_args(torch, singles, ["stack", "cat1", "cat1", "cat1"]), singles,
                     lambda a: mg.keys_call(*a, L, C), keys_fleet_of,
                     nbytes(singles[0]) + c * 4 * (6 + 27 + 6 * L + 6 * L + 2 * L), 650.0 * c)

    keys_outs = [mg.keys_call(*s, L, C) for s in singles]
    singles = [select_inputs(torch, dev, rng, ko, nb=nbs) for ko in keys_outs]

    def fleet_bidx(xs):
        out = []
        for r, x in enumerate(xs):
            out.append(torch.where(x < nbs, x + r * nbs, torch.full_like(x, b * nbs)))
        return torch.cat(out, dim=1).contiguous()

    def select_fleet_of(outs):
        o, s40, nm = zip(*outs)
        return torch.cat(o, dim=1), torch.cat(s40), torch.cat(nm)

    cases["select"] = (
        _stack_args(torch, singles, ["stack"] + ["cat1"] * 6 + [fleet_bidx]), singles,
        lambda a: mg.select_call(*a, L, (a[0].shape[0] if a[0].dim() == 2 else 1) * nbs),
        select_fleet_of,
        nbytes(singles[0]) + 4 * (46 * c + nbs * 1600 + nbs * 128),
        c * (6 * 200 + 80 + 820 * 3))

    singles = [list(moments_inputs(torch, dev, rng, r=512, nb=nbs, n=256) if small
                    else moments_inputs(torch, dev, rng)) for _ in range(b)]
    n, rr, nbm = singles[0][6].shape[0], singles[0][8].shape[0], singles[0][2].shape[0]

    def shifted(step, clamp=None):
        def f(xs):
            return torch.cat([(x if clamp is None else torch.clamp(x, max=clamp)) + r * step
                              for r, x in enumerate(xs)]).contiguous()
        return f

    how = ["stack", lambda xs: xs[0], "cat0", "cat0", "cat0", "cat0", "cat0", "cat0",
           shifted(n), shifted(nbm, nbm - 1), "cat0", "cat0"]
    cases["moments"] = (_stack_args(torch, singles, how), singles,
                        lambda a: ir.moments_rows_call(*a),
                        lambda outs: tuple(torch.cat(xs) for xs in zip(*outs)),
                        moments_bytes(singles[0]), 380.0 * rr)

    singles = [_fit_tables_random(torch, dev, rng, *((600, 128) if small else (2048, 1024)))
               for _ in range(b)]
    m, budget = singles[0][1].shape[0] - 1, singles[0][4].shape[0]

    def flat_table(xs):  # the replicas' own tables side by side, then one sentinel row
        return torch.cat([x[:m] for x in xs] + [xs[0][m:]]).contiguous()

    def fleet_fs(xs):
        return torch.cat([torch.where(x < m, x + r * m, b * m) for r, x in enumerate(xs)])

    cases["fit"] = (
        _stack_args(torch, singles, [lambda xs: xs[0], flat_table, flat_table, flat_table,
                                     fleet_fs]), singles,
        lambda a: pfr.fit_slots_call(*a), lambda outs: torch.cat(outs),
        fit_bytes(singles[0]), FIT_FLOPS_PER_SLOT * budget)

    for name, use_kin in (("chain_points", False), ("chain_points_kin", True)):
        singles = [chain_points_inputs(torch, dev, rng, use_kin, nb=nbs, p=128 if small else 256)
                   for _ in range(b)]
        nb, k = singles[0][7].shape
        p = singles[0][14].shape[1]
        cases[name] = (
            _stack_args(torch, singles, ["stack"] * 19), singles,
            lambda a, use_kin=use_kin: cp.chain_points_call(*a, use_kin=use_kin),
            lambda outs: tuple(torch.stack(xs) for xs in zip(*outs)),
            nbytes(list(singles[0])) + 4 * (nb * (9 + 3 + 9 + 9 + 1) + 9 + 27 + 900 + 2),
            chain_points_flops(nb, k, p, use_kin))
    return cases


def _fleet_vs_plain(torch, name, got, ref, b):
    """The fleet launch against the plain version of the same fleet, at
    the tolerances the single launches are held to (phase_kernels); returns
    the max abs error."""
    if name == "pose":
        if not torch.equal(got, ref):
            raise RuntimeError(f"pose (B = {b}): not bit-equal to the plain version")
        return max_abs(got, ref)
    if name in ("chain_stats", "chain_points", "chain_points_kin"):
        tol = [1e-4, 1e-4, 1e-3, 1e-3, 0.0, 1e-4, 1e-4, 1e-3, 0.0]
        for i, (x, y, t) in enumerate(zip(got, ref, tol)):
            e = max(rel_err(x[r], y[r]) for r in range(b))
            if not e <= t:
                raise RuntimeError(f"{name} (B = {b}): output {i} rel err {e:.3g} > {t}")
        return max(max_abs(x, y) for x, y in zip(got, ref))
    if name == "keys":
        if not all(torch.equal(got[i], ref[i]) for i in (2, 3, 4)):
            raise RuntimeError(f"keys (B = {b}): keys, centres or probe starts differ")
        if not (rel_err(got[0], ref[0]) <= 1e-6 and rel_err(got[1], ref[1]) <= 1e-5):
            raise RuntimeError(f"keys (B = {b}): rel errs over the tolerances")
        return max(max_abs(x, y) for x, y in zip(got, ref))
    if name == "moments":
        g69, r69 = torch.cat(got, dim=1), torch.cat(ref, dim=1)
        e = max(rel_err(g69[:, i], r69[:, i]) for i in range(69))
        if not e <= 1e-4:
            raise RuntimeError(f"moments (B = {b}): rel err {e:.3g}")
        return max_abs(g69, r69)
    if name == "fit":  # at most 2 flips in 1,024 slots a replica, as a single launch
        return fit_check(torch, f"fit (B = {b})", got, ref, max_flips=2 * b)[3]
    raise KeyError(name)


def phase_fleet_kernels(torch, dev):
    """The kernels with a replica axis (the fused path's six and the
    per-point chain's two branches) at B = 64 distinct replicas: one launch
    must be ``torch.equal`` to 64 launches at B = 1 and hold to its plain
    version at the single launch's tolerances (select by
    ``select_check``); each is timed at B = 1, 8 and 64 beside its bound
    (B times one replica's bytes or flops).  Returns {name: record} for the
    kernels line (the B = 64 launch)."""
    from legkilo_torch.ops import match_geom as mg
    from legkilo_torch.ops import plane_fit_rows as pfr

    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    cases = _fleet_kernel_cases(torch, dev, rng, max(FLEET_KERNEL_BS))
    recs = {}
    for name, (fargs, singles, call, fleet_of, b1, f1) in cases.items():
        bmax = len(singles)
        got = call(fargs)
        want = fleet_of([call(s) for s in singles])
        torch.cuda.synchronize()
        outs = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(x, y) for x, y in zip(outs, wants)):
            raise RuntimeError(f"{name}: the B = {bmax} launch differs from {bmax} launches at B = 1")
        # The plain version of a fleet: one call, timed.
        if name == "select":
            (out, s40, nm), (r_out, r_s40, r_nm), _ = select_check(torch, fargs, 3, bmax * 28)
            same = out[0] == r_out[0]  # rows whose gate did not flip, as phase_kernels
            err = max(max_abs(out[:, same], r_out[:, same]), max_abs(s40, r_s40), max_abs(nm, r_nm))
            _, plain_ms = timed_once(torch, lambda: mg.select_plain(*fargs, 3, bmax * 28))
        else:
            ref, plain_ms = timed_once(torch, lambda: call_plain(
                name, fargs, {"fit": pfr.fit_slots_plain}.get(name)))
            err = _fleet_vs_plain(torch, name, got, ref, bmax)
        times = {}
        for bb in FLEET_KERNEL_BS:
            sub = cases_subset(torch, name, fargs, singles, bb)
            times[bb] = time_call(torch, lambda: call(sub), 50 if bb < 64 else 20)
        bounds = {bb: bound(bb * b1, bb * f1) for bb in FLEET_KERNEL_BS}
        log(f"[fleet_kernels] {name}: B = {bmax} launch torch.equal to {bmax} launches at B = 1; "
            f"vs plain within the single launch's tolerances; " + ", ".join(
                f"B = {bb}: {times[bb]:.4f} ms (bound {bounds[bb][0]:.6f} ms, {bounds[bb][1]})"
                for bb in FLEET_KERNEL_BS))
        recs[name + FLEET_SUFFIX] = dict(
            max_abs_err=err, ms=times[bmax], plain_ms=plain_ms,
            bound_ms=bounds[bmax][0], bound_by=bounds[bmax][1],
            ms_by_b={str(k): v for k, v in times.items()},
            bound_ms_by_b={str(k): v[0] for k, v in bounds.items()})
    log(f"[fleet_kernels] the phase took {time.perf_counter() - t_phase:.1f} s")
    return recs


def timed_once(torch, fn):
    """(fn(), its ms by CUDA events around one call after a synchronise)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def call_plain(name, fargs, plain_fn=None):
    from legkilo_torch.ops import chain_points as cp
    from legkilo_torch.ops import chain_stats as cs
    from legkilo_torch.ops import insert_rows as ir
    from legkilo_torch.ops import match_geom as mg
    from legkilo_torch.ops import pose_prop as pp

    if name == "pose":
        return pp.pose_plain(*fargs)
    if name == "chain_stats":
        return cs.chain_plain(*fargs, use_kin=False)
    if name in ("chain_points", "chain_points_kin"):
        return cp.chain_points_plain(*fargs, use_kin=name == "chain_points_kin")
    if name == "keys":
        return mg.keys_plain(*fargs, 3, 1 << 14)
    if name == "moments":
        return ir.moments_rows_plain(*fargs)
    return plain_fn(*fargs)


def cases_subset(torch, name, fargs, singles, bb):
    """The fleet arguments of the first ``bb`` replicas of a case."""
    bmax = len(singles)
    if bb == bmax:
        return fargs
    if name in ("pose", "chain_stats", "chain_points", "chain_points_kin"):
        return [a[:bb] for a in fargs]
    if name == "keys":
        c = fargs[1].shape[1] // bmax
        return [fargs[0][:bb]] + [a[:, : bb * c].contiguous() for a in fargs[1:]]
    if name == "select":
        c = fargs[1].shape[1] // bmax
        bidx = fargs[7][:, : bb * c]
        bidx = torch.where(bidx >= bmax * 28, torch.full_like(bidx, bb * 28), bidx)
        return [fargs[0][:bb]] + [a[:, : bb * c].contiguous() for a in fargs[1:7]] + [bidx]
    if name == "moments":
        nbm = fargs[2].shape[0] // bmax
        n = fargs[6].shape[0] // bmax
        rr = fargs[8].shape[0] // bmax
        return [fargs[0][:bb], fargs[1]] + [a[: bb * nbm] for a in fargs[2:6]] + \
            [fargs[6][: bb * n], fargs[7][: bb * n], fargs[8][: bb * rr], fargs[9][: bb * n],
             fargs[10][: bb * rr], fargs[11][: bb * rr]]
    if name == "fit":
        budget = fargs[4].shape[0] // bmax
        return fargs[:4] + [fargs[4][: bb * budget]]
    raise KeyError(name)


def fleet_config(latch=True):
    """bench.py's configuration (all five kernel switches: the batched
    fleet route), as sweep --pallas --pipeline deferred runs it."""
    from legkilo_torch.runner import bench_config

    cfg = bench_config()
    if not latch:
        cfg.tpu.escalate_after = 0
    return cfg


def fleet_start(torch, cfg, datas, use_kin=False):
    """Each replica's first-frame initialisation (fleet_init) from its
    data's first packet, as ``sweep --distinct`` does (``use_kin``: with the
    data's kinematic events); returns (scfg, carry, params, each replica's
    host packets after the first)."""
    from legkilo_torch.cli import _packets_from_streams
    from legkilo_torch.io.dataset import decimate_blind
    from legkilo_torch.parallel.sweep import fleet_init
    from legkilo_torch.runner import make_params, make_static_config

    scfg = make_static_config(cfg, use_kin=use_kin)
    seqs, clouds, accs, gyrs, offs = [], [], [], [], []
    for d in datas:
        pk = _packets_from_streams(cfg, d.scans, d.kin if use_kin else d.imu, use_kin=use_kin)
        m = pk[0].imu_mask
        accs.append(pk[0].imu_acc[m].mean(axis=0))
        gyrs.append(pk[0].imu_gyr[m].mean(axis=0))
        offs.append(pk[0].end_offset)
        pts, _, _ = decimate_blind(d.scans[0].points, d.scans[0].time_offset,
                                   cfg.lidar.filter_num, cfg.lidar.blind)
        clouds.append(pts)
        seqs.append(pk[1:])
    carry, params = fleet_init(scfg, make_params(cfg, torch.device("cuda")), clouds,
                               np.stack(accs), np.stack(gyrs), np.asarray(offs),
                               float(cfg.gravity), device="cuda")
    return scfg, carry, params, seqs


def fleet_replay(torch, scfg, carry, params, steps, chunk):
    """Step the fleet through ``steps`` ([B, ...] packets), ``chunk`` scans
    a call (1: per scan); returns (carry, pos [T, B, 3], rot [T, B, 3, 3],
    last stats, fleet steps)."""
    from legkilo_torch.parallel.sweep import (
        make_fleet_chunk_step, make_fleet_step, stack_fleet_chunks,
    )

    pos, rot = [], []
    stats = None
    if chunk > 1:
        step = make_fleet_chunk_step(scfg)
        for dev in stack_fleet_chunks(steps, chunk):
            carry, outs, stats = step(carry, dev, params)
            pos.append(outs.pos.transpose(0, 1))
            rot.append(outs.rot.transpose(0, 1))
    else:
        step = make_fleet_step(scfg)
        for dev in steps:
            carry, out, stats = step(carry, dev, params)
            pos.append(out.pos[None])
            rot.append(out.rot[None])
    pos, rot = torch.cat(pos), torch.cat(rot)
    return carry, pos.cpu().numpy(), rot.cpu().numpy(), stats, int(pos.shape[0])


def distinct_sims(n, duration):
    """``sweep --distinct n``'s worlds: varied trajectories, seeds 100 + r."""
    from legkilo_torch.models import sim

    return [sim.simulate(sim.SimConfig(duration=duration, seed=100 + r),
                         traj=sim.Trajectory(speed=0.6 + 0.12 * (r % 4), radius=2.0 + 0.4 * (r % 3),
                                             bob_freq=1.5 + 0.25 * (r % 4)))
            for r in range(n)]


def phase_fleet_equal(torch, duration=FLEET_EQUAL_DURATION_S):
    """Four distinct sims (``--distinct``-style worlds, 4 s) through the
    fleet, per scan and chunked by 8: each replica's trajectory must be
    equal bit for bit to its own single ``run_offline`` (the fleet has no
    escalation latch, so the single runs run without one)."""
    from legkilo_torch.io.dataset import to_device_packet
    from legkilo_torch.parallel.sweep import stack_packets
    from legkilo_torch.runner import run_offline

    t_phase = time.perf_counter()
    cfg = fleet_config(latch=False)
    datas = distinct_sims(FLEET_EQUAL_B, duration)
    singles = [run_offline(cfg, d.scans, d.imu, device="cuda")[1:] for d in datas]
    scfg, carry0, params, seqs = fleet_start(torch, cfg, datas)
    steps = stack_packets([[to_device_packet(p, "cuda") for p in s] for s in seqs])
    reset_counters()
    rec = {}
    for chunk in (1, FLEET_CHUNK):
        _, pos, rot, _, t = fleet_replay(torch, scfg, carry0, params, steps, chunk)
        same = [bool(np.array_equal(pos[:, r], np.stack([x.pos for x in singles[r][:t]]))
                     and np.array_equal(rot[:, r], np.stack([x.rot for x in singles[r][:t]])))
                for r in range(FLEET_EQUAL_B)]
        dev = max(float(np.abs(pos[:, r] - np.stack([x.pos for x in singles[r][:t]])).max())
                  for r in range(FLEET_EQUAL_B))
        rec[f"chunk{chunk}"] = dict(scans=t, equal=same, max_abs_pos_m=dev)
        if not all(same):
            raise RuntimeError(f"fleet_equal (chunk {chunk}): replicas {same} not equal to their "
                               f"single runs (max |dpos| {dev:.3g} m)")
    counts = read_counters()
    log(f"[fleet_equal] {json.dumps(rec)}; launches {json.dumps(counts)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    if any(counts[k] <= 0 for k in FUSED_KERNELS) or counts["chain_points"]:
        raise RuntimeError(f"fleet_equal: kernel counters {counts}")


def fleet_profile(torch, scfg, carry, params, chunks_dev):
    """torch.profiler (the card's activity) over the chunked calls
    ``chunks_dev``: device ms and device launches a fleet step."""
    from torch.profiler import ProfilerActivity, profile

    from legkilo_torch.parallel.sweep import make_fleet_chunk_step

    step = make_fleet_chunk_step(scfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for dev in chunks_dev:
            carry, _, _ = step(carry, dev, params)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    n = sum(int(d.points.shape[1]) for d in chunks_dev)
    return dict(device_ms_per_step=sum(r[0] for r in rows) / 1e3 / n,
                launches_per_step=sum(r[2] for r in rows) / n), rows


def fleet_broadcast_run(torch, data, b, n_scans, tag, check_ate=True, profile_chunks=2,
                        by_kernel=False):
    """``sweep --pallas``'s broadcast fleet on ``data``: the filter
    initialised once from the first packet and copied to ``b`` replicas,
    q_diag jittered by FLEET_NOISE, the packets broadcast, chunked by
    FLEET_CHUNK over ``n_scans`` fleet steps.  Checks each kernel launched
    exactly once a fleet step (one match pass: bench.py's), every replica's
    ATE under the bound (``check_ate``), and prints replica-scans/s, device
    ms and launches a fleet step (a profiler window of ``profile_chunks``
    calls), and peak memory a replica; ``by_kernel`` adds the window's
    launches a fleet step of each device operation (``calls_per_step``)."""
    from legkilo_torch.core.filter_fleet import replica, tree_map
    from legkilo_torch.io.dataset import to_device_packet
    from legkilo_torch.io.tum import ate_rmse
    from legkilo_torch.parallel.sweep import broadcast_packets, perturb_params, stack_fleet_chunks

    cfg = fleet_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    scfg, one, params1, seqs = fleet_start(torch, cfg, [data])
    carry0 = tree_map(lambda x: x.expand((b,) + tuple(x.shape[1:])).clone(), one)
    params = perturb_params(replica(params1, 0), b, scale=FLEET_NOISE, seed=0)
    host = seqs[0][:n_scans]
    steps = [broadcast_packets(to_device_packet(p, "cuda"), b) for p in host]
    chunks = stack_fleet_chunks(steps, FLEET_CHUNK)
    del steps
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from legkilo_torch.parallel.sweep import make_fleet_chunk_step

    step = make_fleet_chunk_step(scfg)
    carry, pos = carry0, []
    for dev in chunks:
        carry, outs, stats = step(carry, dev, params)
        pos.append(outs.pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    pos = torch.cat(pos, dim=1).cpu().numpy()        # [B, T, 3]
    t = pos.shape[1]
    peak = torch.cuda.max_memory_allocated() - mem0
    prof, rows = fleet_profile(torch, scfg, carry0, params, chunks[:profile_chunks])
    rec = dict(replicas=b, scans=t, chunk=FLEET_CHUNK, wall_s=wall,
               replica_scans_per_s=b * t / wall, ms_per_fleet_step=wall / t * 1e3,
               peak_mb_per_replica=peak / b / 2 ** 20, launches=counts, **prof,
               final_spread_m=float(stats.pos_spread))
    if check_ate:
        _, gt = data.gt_in_filter_frame()
        gtm = {round(x, 6): i for i, x in enumerate(data.gt_times)}
        sel = [i for i, p in enumerate(host[:t]) if round(p.end_time, 6) in gtm]
        idx = [gtm[round(host[i].end_time, 6)] for i in sel]
        ates = [ate_rmse(pos[r, sel], gt[idx], align=False) for r in range(b)]
        rec.update(ate_max_m=max(ates), ate_mean_m=float(np.mean(ates)))
    log(f"[{tag}] {json.dumps(rec)}")
    log(f"[{tag}] B = {b}: {rec['replica_scans_per_s']:.1f} replica-scans/s, "
        f"{rec['ms_per_fleet_step']:.3f} ms a fleet step (host wall), device "
        f"{rec['device_ms_per_step']:.3f} ms and {rec['launches_per_step']:.1f} launches a fleet "
        f"step (profiler), peak {rec['peak_mb_per_replica']:.2f} MB a replica")
    for dev_us, key, count in rows[:6]:
        log(f"[{tag}]   {dev_us / (profile_chunks * FLEET_CHUNK) / 1e3:8.4f} ms/step "
            f"{count / (profile_chunks * FLEET_CHUNK):6.1f} calls/step  {key[:80]}")
    if by_kernel:
        rec["calls_per_step"] = {key: count / (profile_chunks * FLEET_CHUNK) for _, key, count in rows}
    want = {k: t for k in FUSED_KERNELS}
    got = {k: counts[k] for k in FUSED_KERNELS}
    if got != want or counts["chain_points"]:
        raise RuntimeError(f"{tag}: launches {counts}, expected one a kernel a fleet step ({want})")
    if not np.isfinite(pos).all():
        raise RuntimeError(f"{tag}: non-finite poses")
    if check_ate and not rec["ate_max_m"] < ATE_BOUND_M:
        raise RuntimeError(f"{tag}: a replica's ATE {rec['ate_max_m']:.4f} m >= {ATE_BOUND_M} m")
    return rec


def phase_fleet(torch, data):
    t_phase = time.perf_counter()
    rec = fleet_broadcast_run(torch, cut(data, FLEET_DURATION_S + 0.1), FLEET_B,
                              int(FLEET_DURATION_S * 10), "fleet")
    log(f"[fleet] the phase took {time.perf_counter() - t_phase:.1f} s")
    return rec


def phase_fleet_scale(torch, data):
    """B = 1, 8, 64, 256 for FLEET_SCALE_SCANS scans each, as ``fleet``;
    fails when the device launches a fleet step at B = 64 are not within
    10 % of those at B = 1, and logs each device operation whose launches a
    step differ between the two."""
    t_phase = time.perf_counter()
    recs = {b: fleet_broadcast_run(torch, data, b, FLEET_SCALE_SCANS, f"fleet_scale{b}",
                                   check_ate=False, profile_chunks=1, by_kernel=True)
            for b in FLEET_SCALE_BS}
    l1, l64 = recs[1]["launches_per_step"], recs[64]["launches_per_step"]
    calls = {b: r.pop("calls_per_step") for b, r in recs.items()}
    log_launch_diff("fleet_scale", calls[1], calls[64], "B = 1", "B = 64")
    log(f"[fleet_scale] device launches a fleet step: " + ", ".join(
        f"B = {b}: {r['launches_per_step']:.1f}" for b, r in recs.items())
        + f"; replica-scans/s: " + ", ".join(
        f"B = {b}: {r['replica_scans_per_s']:.1f}" for b, r in recs.items())
        + f"; {time.perf_counter() - t_phase:.1f} s")
    if not abs(l64 - l1) <= 0.1 * l1:
        raise RuntimeError(f"fleet_scale: {l64:.1f} launches a step at B = 64 against {l1:.1f} at B = 1")
    return recs


def phase_fleet_bags(torch, data):
    """``python -m legkilo_torch sweep --bags DIR --pallas --pipeline
    deferred --traj_out OUT`` in this process over two 4 s bags (main's
    workload and a second sim, seed 8) written by the bag phase's writer:
    one TUM file a bag, every replica's ATE under the bound, each kernel
    launched once a fleet step."""
    import shutil

    from legkilo_torch import cli
    from legkilo_torch.io.tum import associate, ate_rmse, read_tum
    from legkilo_torch.models import sim

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "fleet_bags")
    shutil.rmtree(root, ignore_errors=True)
    bags, out_dir = os.path.join(root, "bags"), os.path.join(root, "traj")
    os.makedirs(bags)
    datas = [cut(data, FLEET_BAG_DURATION_S),
             sim.simulate(sim.SimConfig(duration=FLEET_BAG_DURATION_S, scan_points=8000, seed=8))]
    for i, d in enumerate(datas):
        write_bag(os.path.join(bags, f"bag{i}.bag"), imu_bag_messages(d))
    cfg = os.path.join(root, "fleet.yaml")
    bag_config_file(cfg, use_kin=False)
    reset_counters()
    rec = cli_json(cli, ["sweep", "--bags", bags, "--pallas", "--pipeline", "deferred",
                         "--traj_out", out_dir, "--config_file", cfg])
    counts = read_counters()
    ates = {}
    for i, d in enumerate(datas):
        t, p, _ = read_tum(os.path.join(out_dir, f"bag{i}.bag.tum"))
        _, gt = d.gt_in_filter_frame()
        ia, ib = associate(t, d.gt_times + BAG_TIME_OFFSET_S, max_dt=0.01)
        ates[f"bag{i}"] = dict(poses=len(t), pairs=int(len(ia)),
                               ate_m=ate_rmse(p[ia], gt[ib], align=False))
    log(f"[fleet_bags] {json.dumps(rec)}; {json.dumps(ates)}; launches {json.dumps(counts)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    if rec["replicas"] != 2 or any(a["poses"] != rec["scans"] for a in ates.values()):
        raise RuntimeError(f"fleet_bags: {rec}, {ates}")
    if not all(a["ate_m"] < ATE_BOUND_M and a["pairs"] >= 10 for a in ates.values()):
        raise RuntimeError(f"fleet_bags: ATE {ates}")
    # One launch a kernel a fleet step; fit also once a replica for its
    # first-frame map (fleet_init).
    want = {k: rec["scans"] + (rec["replicas"] if k == "fit" else 0) for k in FUSED_KERNELS}
    if any(counts[k] != want[k] for k in FUSED_KERNELS) or counts["chain_points"]:
        raise RuntimeError(f"fleet_bags: launches {counts}, expected {want}")
    return rec


# ---------------------------------------------------------- fleet routes --
#
# The fleet on the configurations off the five kernels: the sequential
# pipeline, the fused path with every switch off, the per-point path.  Each
# is one batched step for all B replicas (core/filter_fleet.py), so its
# launches a fleet step do not grow with B.

ROUTE_B = 8                  # fleet_seq, fleet_points
ROUTE_LEG_FUSION_B = 4
ROUTE_LAUNCH_BS = (1, 8)     # launches a fleet step, each one profiled step
ROUTE_COMPARE_REPLICAS = 2   # replicas held against their single runs
ROUTE_SLOW_SCANS = 2         # the slow routes' fleet steps (and compared scans)
ROUTE_POINTS_SCANS = 16
ROUTE_POINTS_COMPARE = 3
ROUTE_POINTS_EXTRA = 3       # const-vel pose and return_cloud
ROUTE_POINTS_KIN_B = 4
# Replicas against their single runs on the card.  A batched cuBLAS product
# of small matrices rounds apart from the same product at another batch
# count (tools/batch_invariance_probe.py), and the plain phases are made of
# such products: a fleet's replica and its single run drift apart by
# rounding, and now and then a point within that spread of a gate or a
# voxel boundary matches or lands apart.  Measured by these phases on an
# NVIDIA H100 80GB HBM3 at 700 W: pos 2.4e-7 / 4.1e-6 / 1.1e-5 m after 2
# scans of fleet_seq, 2 of fleet_leg_fusion and 3 of the per-point
# const-vel run; imu_w up to 3.2e-4 and covariance entries 1.4e-4 (the
# largest 0.24) after one flipped match in ~1,700; a world cloud 7.3e-5 m.
# The bounds below are about ten times those spreads.  The CPU tests
# (tests/test_torch_fleet_routes.py) hold the same routes bit for bit or
# at pos 1e-5 / covariance 1e-6.
ROUTE_POS_ATOL = 1e-4        # pos, rot
ROUTE_CLOUD_ATOL = 1e-3      # world clouds (m; points up to ~20 m out)
ROUTE_LIN_ATOL = 3e-3        # the state's other blocks
ROUTE_COV_ATOL = 1e-5        # covariance: ATOL + RTOL x its largest entry
ROUTE_COV_RTOL = 5e-3
ROUTE_SLOT_FRAC = 1e-3       # occupied map slots whose key, occupancy or count may differ
ROUTE_MATCH_FRAC = 1e-3      # matched points a scan
LIN_BLOCKS = ("pos", "vel", "ba", "bw", "grav", "imu_a", "imu_w", "bv", "contact")


def points_fleet_config():
    """bench.py's configuration on the per-point path (chain_impl "jax",
    pose and refit kernels on)."""
    return path_config(points=True)


ROUTES = {  # phase: (configuration, leg kinematics)
    "fleet_seq": (seq_config, False),
    "fleet_leg_fusion": (leg_fusion_config, True),
    "fleet_points": (points_fleet_config, False),
}


def route_fleet(torch, cfg, data, b, use_kin):
    """The filter initialised from ``data``'s first packet (``fleet_init``),
    copied to ``b`` replicas, q_diag jittered by FLEET_NOISE: (scfg, carry,
    params, the [b, ...] packets after the first, on the card)."""
    from legkilo_torch.core.filter_fleet import replica, tree_map
    from legkilo_torch.io.dataset import to_device_packet
    from legkilo_torch.parallel.sweep import broadcast_packets, perturb_params

    scfg, one, params1, seqs = fleet_start(torch, cfg, [data], use_kin=use_kin)
    carry = tree_map(lambda x: x.expand((b,) + tuple(x.shape[1:])).clone(), one)
    params = perturb_params(replica(params1, 0), b, scale=FLEET_NOISE, seed=0)
    steps = [broadcast_packets(to_device_packet(p, "cuda"), b) for p in seqs[0]]
    return scfg, carry, params, steps


def profiled_step(torch, scfg, carry, packet, params):
    """One fleet step under torch.profiler (the card's activity): (carry,
    out, device launches, device ms, {operation: launches})."""
    from torch.profiler import ProfilerActivity, profile

    from legkilo_torch.parallel.sweep import make_fleet_step

    step = make_fleet_step(scfg, with_stats=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        carry, out, _ = step(carry, packet, params)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return carry, out, sum(r[2] for r in rows), sum(r[0] for r in rows) / 1e3, {k: n for _, k, n in rows}


def route_launches(torch, phase, data=None):
    """Device launches of one fleet step of the route ``phase`` at each B
    of ROUTE_LAUNCH_BS (the first step after the first-frame map, on
    ``data``, 0.4 s of the bench sim by default): {B: launches}."""
    from legkilo_torch.core.filter_fleet import tree_map

    config, use_kin = ROUTES[phase]
    cfg, _ = config()
    cfg.only_imu_use = not use_kin
    data = data if data is not None else simulate(0.4, phase)
    scfg, carry, params, steps = route_fleet(torch, cfg, data, max(ROUTE_LAUNCH_BS), use_kin)
    out = {}
    for bb in ROUTE_LAUNCH_BS:
        sub = [tree_map(lambda x: x[:bb].contiguous(), t) for t in (carry, steps[0], params)]
        out[bb] = profiled_step(torch, scfg, *sub)[2]
    return out


def route_compare(torch, scfg, carry0, params, steps, outs, carry_at, n_rep, n_scans):
    """Replicas 0 ... n_rep - 1 of a fleet against their own single runs over
    ``n_scans`` scans (the ROUTE_* tolerances above): n_points,
    n_cap_dropped, map_overflow and the clocks equal; n_matched within
    ROUTE_MATCH_FRAC; the maps' keys, occupancy and slot counts equal but
    for ROUTE_SLOT_FRAC of the occupied slots; pos and rot within
    ROUTE_POS_ATOL, clouds within ROUTE_CLOUD_ATOL, the state's other
    blocks within ROUTE_LIN_ATOL, the covariance within ROUTE_COV_ATOL +
    ROUTE_COV_RTOL x its largest entry.  ``carry_at`` is the fleet's carry
    after ``n_scans`` steps.  Logs every field's largest difference;
    returns (max |dpos| m, whether every tensor was bit-equal)."""
    from legkilo_torch.core.filter import process_scan_any
    from legkilo_torch.core.filter_fleet import replica

    def leaves(tree, prefix=""):
        if tree is None:
            return []
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return [kv for f, x in zip(tree._fields, tree) for kv in leaves(x, prefix + f + ".")]
        return [(prefix[:-1], tree)]

    bit_equal, errs, bad = True, {}, []

    def note(key, value):
        errs[key] = max(errs.get(key, 0), value)

    for r in range(n_rep):
        c = replica(carry0, r)
        pairs = []
        for k in range(n_scans):
            c, o = process_scan_any(c, replica(steps[k], r), replica(params, r), scfg)
            pairs.append((o, replica(outs[k], r)))
        pairs.append((c, replica(carry_at, r)))
        for single, fleet in pairs:
            for (name, y), (_, x) in zip(leaves(single), leaves(fleet)):
                bit_equal &= bool(torch.equal(x, y))
                if name in ("vm.ptab", "vm.meta"):
                    occupied = int((y[..., 3] > 0).sum()) if name == "vm.ptab" else None
                    nd = int(((x[..., 0:4] != y[..., 0:4]).any(-1) if name == "vm.ptab"
                              else x[..., 0] != y[..., 0]).sum())
                    note(f"{name}_slots_differing", nd)
                    if occupied is not None:
                        errs["occupied_slots"] = occupied
                    ok = nd <= ROUTE_SLOT_FRAC * errs["occupied_slots"]
                elif name in ("vm.mom", "vm.moms", "vm.plane"):
                    ok = True
                elif name == "n_matched":
                    d = int((x.long() - y.long()).abs().max())
                    note(name, d)
                    ok = d <= ROUTE_MATCH_FRAC * int(y.max())
                elif not x.is_floating_point() or name.endswith("_t"):
                    ok = torch.equal(x, y)
                elif name == "state.lin":
                    ok = True
                    for i, blk in enumerate(LIN_BLOCKS):
                        e = float((x - y)[..., 3 * i:3 * i + 3].abs().max())
                        note(f"lin.{blk}", e)
                        ok &= e <= (ROUTE_POS_ATOL if blk == "pos" else ROUTE_LIN_ATOL)
                elif name == "cov":
                    e, scale = float((x - y).abs().max()), float(y.abs().max())
                    note(name, e)
                    note("cov_largest_entry", scale)
                    ok = e <= ROUTE_COV_ATOL + ROUTE_COV_RTOL * scale
                else:
                    e = float((x - y).abs().max())
                    note(name, e)
                    ok = e <= (ROUTE_CLOUD_ATOL if name == "cloud_world" else ROUTE_POS_ATOL)
                if not ok:
                    bad.append(name)
    log(f"[route_compare] {n_rep} replicas x {n_scans} scans against their single runs, largest "
        f"differences: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    if bad:
        raise RuntimeError(f"{sorted(set(bad))} differ from the single runs beyond the tolerances")
    return errs.get("pos", 0.0), bit_equal


def run_route(torch, tag, cfg, data, use_kin, b, n_steps, n_compare, on_path):
    """One route's fleet on the card: launches a fleet step at B = 1 and 8
    (one profiled step each; 8 within 10 % of 1), the fleet of ``b`` over
    ``n_steps`` steps (its first step profiled: device ms; the rest timed:
    host ms a fleet step, replica-scans/s; peak MB a replica), the kernel
    counters of those steps, and ROUTE_COMPARE_REPLICAS replicas against
    their own single runs over ``n_compare`` scans."""
    from legkilo_torch.core.filter_fleet import tree_map
    from legkilo_torch.parallel.sweep import make_fleet_step

    t_phase = time.perf_counter()
    cfg.only_imu_use = not use_kin
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    scfg, carry0, params, steps = route_fleet(torch, cfg, data, max(b, *ROUTE_LAUNCH_BS), use_kin)
    steps = steps[:n_steps]
    if len(steps) < max(n_steps, n_compare, 2):
        raise RuntimeError(f"{tag}: {len(steps)} packets")
    launches, dev_ms, by_op = {}, {}, {}
    for bb in ROUTE_LAUNCH_BS:
        sub = [tree_map(lambda x: x[:bb].contiguous(), t) for t in (carry0, steps[0], params)]
        _, _, launches[bb], dev_ms[bb], by_op[bb] = profiled_step(torch, scfg, *sub)
    carry0, params = (tree_map(lambda x: x[:b].contiguous(), t) for t in (carry0, params))
    steps = [tree_map(lambda x: x[:b].contiguous(), s) for s in steps]
    reset_counters()
    carry, out, _, device_ms, _ = profiled_step(torch, scfg, carry0, steps[0], params)
    outs, carry_at = [out], tree_map(torch.clone, carry)  # kept: the next step consumes carry
    step = make_fleet_step(scfg, with_stats=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, dev in enumerate(steps[1:], start=1):
        carry, out, _ = step(carry, dev, params)
        outs.append(out)
        if k < n_compare:
            carry_at = tree_map(torch.clone, carry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated() - mem0
    n_timed = len(steps) - 1
    pos = torch.stack([o.pos for o in outs]).cpu().numpy()
    worst, bit_equal = route_compare(torch, scfg, carry0, params, steps, outs, carry_at,
                                     ROUTE_COMPARE_REPLICAS, n_compare)
    rec = dict(replicas=b, steps=len(steps),
               launches_per_step={str(bb): n for bb, n in launches.items()},
               device_ms_per_step={str(bb): ms for bb, ms in dev_ms.items()},
               device_ms_fleet_step=device_ms,
               ms_per_fleet_step=wall / n_timed * 1e3, replica_scans_per_s=b * n_timed / wall,
               peak_mb_per_replica=peak / b / 2 ** 20, launches=counts,
               compared=f"{ROUTE_COMPARE_REPLICAS} replicas x {n_compare} scans",
               max_abs_pos_vs_single_m=worst, bit_equal_to_singles=bit_equal,
               mean_matched=float(torch.stack([o.n_matched for o in outs]).float().mean()))
    log(f"[{tag}] {json.dumps(rec)}")
    log(f"[{tag}] B = {b}: {rec['replica_scans_per_s']:.2f} replica-scans/s, "
        f"{rec['ms_per_fleet_step']:.3f} ms a fleet step (host wall, {n_timed} steps), device "
        f"{device_ms:.3f} ms a fleet step (profiler), peak {rec['peak_mb_per_replica']:.2f} MB a "
        f"replica; device launches a fleet step " + ", ".join(
            f"B = {bb}: {n}" for bb, n in launches.items())
        + f"; replicas vs single runs: max |dpos| {worst:.3g} m, bit-equal {bit_equal}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    l1, l8 = launches[1], launches[8]
    if not abs(l8 - l1) <= 0.1 * l1:
        log_launch_diff(tag, by_op[1], by_op[8], "B = 1", "B = 8")
        raise RuntimeError(f"{tag}: {l8} launches a fleet step at B = 8 against {l1} at B = 1")
    if not np.isfinite(pos).all():
        raise RuntimeError(f"{tag}: non-finite poses")
    on_path = set(on_path) | ALWAYS_KERNELS
    missing = sorted(k for k in on_path if counts[k] <= 0)
    stray = sorted(k for k, v in counts.items() if v > 0 and k not in on_path)
    if missing or stray:
        raise RuntimeError(f"{tag}: kernels of the path never launched: {missing}; "
                           f"kernels off the path launched: {stray}")
    return rec


def phase_fleet_seq(torch, data):
    """The JAX ``sweep`` command's defaults: ``python -m legkilo_torch sweep
    --replicas 8 --duration 1`` in this process (``Config()``, the
    sequential pipeline), then the same configuration's fleet of 8 on the
    bench sim (``run_route``); no switched kernel launches, only the claim
    kernel."""
    from legkilo_torch import cli

    t_phase = time.perf_counter()
    reset_counters()
    cli_rec = cli_json(cli, ["sweep", "--replicas", str(ROUTE_B), "--duration", "1"])
    counts = read_counters()
    log(f"[fleet_seq] sweep --replicas {ROUTE_B} --duration 1: {json.dumps(cli_rec)}; launches "
        f"{json.dumps(counts)}; {time.perf_counter() - t_phase:.1f} s")
    if cli_rec["replicas"] != ROUTE_B or not np.isfinite(cli_rec["final_spread_m"]) or not (
            only_the_claims(counts)):
        raise RuntimeError(f"fleet_seq: sweep gave {cli_rec}, launches {counts}")
    cfg, on_path = seq_config()
    rec = run_route(torch, "fleet_seq", cfg, cut(data, 0.1 * (ROUTE_SLOW_SCANS + 2)), False,
                    ROUTE_B, ROUTE_SLOW_SCANS, ROUTE_SLOW_SCANS, on_path)
    rec["sweep"] = cli_rec
    return rec


def phase_fleet_leg_fusion(torch, data):
    """configs/leg_fusion.yaml (the fused path with every kernel switch off,
    leg kinematics) as a fleet of 4 (``run_route``); no switched kernel
    launches, only the claim kernel."""
    cfg, on_path = leg_fusion_config()
    return run_route(torch, "fleet_leg_fusion", cfg, cut(data, 0.1 * (ROUTE_SLOW_SCANS + 2)),
                     True, ROUTE_LEG_FUSION_B, ROUTE_SLOW_SCANS, ROUTE_SLOW_SCANS, on_path)


def phase_fleet_points(torch, data):
    """bench.py's configuration on the per-point path, pose and refit
    kernels on, as a fleet of 8 over 16 scans (``run_route``: the per-point
    chain kernel once a fleet step, one match pass); then 3 steps of it with
    the constant-velocity match pose and ``return_cloud`` (the cloud
    [B, NB, P, 3] finite; one replica against its single run), and 4 steps
    of it with leg kinematics at B = 4 (the chain's kin branch with its
    replica axis).  Returns the two per-point records, whose counters give
    ``chain_points_fleet64`` and ``chain_points_kin_fleet64`` their
    launches."""
    from legkilo_torch.parallel.sweep import make_fleet_step

    t_phase = time.perf_counter()
    cfg, on_path = points_fleet_config()
    short = cut(data, 0.1 * (ROUTE_POINTS_SCANS + 2))
    rec = run_route(torch, "fleet_points", cfg, short, False, ROUTE_B, ROUTE_POINTS_SCANS,
                    ROUTE_POINTS_COMPARE, on_path)
    if rec["launches"]["chain_points"] != ROUTE_POINTS_SCANS:
        raise RuntimeError(f"fleet_points: {rec['launches']['chain_points']} per-point chain "
                           f"launches in {ROUTE_POINTS_SCANS} fleet steps (one a match pass)")

    cfg, _ = points_fleet_config()
    cfg.tpu.match_pose = "const_vel"
    scfg, carry0, params, steps = route_fleet(torch, cfg, short, ROUTE_B, False)
    scfg = scfg._replace(return_cloud=True)
    steps = steps[:ROUTE_POINTS_EXTRA]
    reset_counters()
    step = make_fleet_step(scfg, with_stats=False)
    carry, outs = carry0, []
    for dev in steps:
        carry, out, _ = step(carry, dev, params)
        outs.append(out)
    counts = read_counters()
    cloud = outs[-1].cloud_world
    worst, bit_equal = route_compare(torch, scfg, carry0, params, steps, outs, carry, 1,
                                     ROUTE_POINTS_EXTRA)
    log(f"[fleet_points] const_vel + return_cloud, B = {ROUTE_B}, {len(steps)} steps: cloud "
        f"{list(cloud.shape)}, launches {json.dumps(counts)}; replica 0 vs its single run: max "
        f"|dpos| {worst:.3g} m, bit-equal {bit_equal}")
    if (counts["chain_points"] != len(steps) or counts["pose"] or tuple(cloud.shape[:2]) !=
            (ROUTE_B, steps[0].points.shape[1]) or not bool(torch.isfinite(cloud).all())):
        raise RuntimeError(f"fleet_points: const_vel/return_cloud launches {counts}, cloud "
                           f"{tuple(cloud.shape)}")

    cfg, on_path = points_fleet_config()
    kin_rec = run_route(torch, "fleet_points_kin", cfg, cut(data, 0.6), True, ROUTE_POINTS_KIN_B,
                        4, 2, on_path)
    log(f"[fleet_points] the phase took {time.perf_counter() - t_phase:.1f} s")
    return rec, kin_rec


MESH_DISTINCT = ["--distinct", "4", "--duration", "4", "--chunk", "8"]
MESH_BROADCAST = ["--replicas", "8", "--duration", "2"]
MESH_RANKS = 2
MESH_TIMEOUT_S = 600
SCALE_DURATION_S = 1.0
CLUTTER_BOUNDS = dict(rms_m=0.05, final_m=0.06, match_rate=0.6, nonplanar_l0=12, parents=5)


def rank_main(argv) -> int:
    """One rank of the mesh phase, run as ``python3 -c "import chip_smoke;
    chip_smoke.rank_main(...)"`` from the checkout: ``cli.main(argv)`` with
    the launch counters set to 0 before and printed after."""
    from legkilo_torch import cli

    reset_counters()
    rc = cli.main(argv)
    log("[counters] " + json.dumps(read_counters()))
    return rc


def run_ranks(argv, n, env_edit=None):
    """``legkilo_torch`` ARGV on ``n`` ranks (subprocesses of this script's
    ``rank_main``, joined at a free localhost port); every rank must exit 0
    within MESH_TIMEOUT_S, or all are killed and the phase fails.  Returns
    (the report rank 0 prints, each rank's counters, each rank's backend
    log line)."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    env.update(env_edit or {})
    code = "import sys, chip_smoke; sys.exit(chip_smoke.rank_main(sys.argv[1:]))"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code] + argv + ["--coordinator", coord, "--num_processes", str(n),
                                               "--process_id", str(i)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=MESH_TIMEOUT_S)
            if p.returncode != 0:
                raise RuntimeError(f"rank {i} of {argv}: exit code {p.returncode}\n{err[-3000:]}")
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = [json.loads(l) for out, _ in outs for l in out.splitlines() if l.startswith("{")]
    if len(reports) != 1:
        raise RuntimeError(f"{argv}: {len(reports)} reports, expected rank 0's alone")
    counters = [json.loads(l[len("[counters] "):]) for out, _ in outs for l in out.splitlines()
                if l.startswith("[counters] ")]
    backends = [l.split("] ", 1)[-1] for _, err in outs for l in err.splitlines() if "backend" in l]
    return reports[0], counters, backends


def _same_files(a, b, names):
    import filecmp

    return all(filecmp.cmp(os.path.join(a, x), os.path.join(b, x), shallow=False) for x in names)


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x.files)


def mesh_distinct_case(torch, tag, root, cfg, env_edit=None):
    """``sweep --pallas --pipeline deferred --distinct 4 --duration 4
    --chunk 8 --config_file CFG`` (bench.py's configuration: the batched
    five-kernel route) with --traj_out/--save_ckpt in this process and on
    MESH_RANKS ranks: TUM files byte for byte, checkpoints leaf for leaf,
    mean_matched and the ATEs equal; each rank's six kernels launched once
    a fleet step (fit also once a replica of its own for the first-frame
    map), chain_points never."""
    from legkilo_torch import cli

    common = ["sweep", "--pallas", "--pipeline", "deferred", "--config_file", cfg] + MESH_DISTINCT
    d = {k: os.path.join(root, f"{tag}_{k}") for k in ("d1", "d2", "c1", "c2")}
    reset_counters()
    t0 = time.perf_counter()
    one = cli_json(cli, common + ["--traj_out", d["d1"], "--save_ckpt", d["c1"]])
    t_one = time.perf_counter() - t0
    c_one = read_counters()
    t0 = time.perf_counter()
    two, counters, backends = run_ranks(common + ["--traj_out", d["d2"], "--save_ckpt", d["c2"]],
                                        MESH_RANKS, env_edit)
    t_two = time.perf_counter() - t0
    names = [f"sim{r}.tum" for r in range(one["replicas"])]
    b = one["replicas"] // MESH_RANKS
    want_rank = {k: two["scans"] + (b if k == "fit" else 0) for k in FUSED_KERNELS}
    want_one = {k: one["scans"] + (one["replicas"] if k == "fit" else 0) for k in FUSED_KERNELS}
    rec = dict(one=one, ranks=two, counters_one=c_one, counters_ranks=counters,
               tum_equal=_same_files(d["d1"], d["d2"], names),
               ckpt_equal=_same_npz(d["c1"] + ".npz", d["c2"] + ".npz"),
               wall_one_s=t_one, wall_ranks_s=t_two)
    for line in backends:
        log(f"[{tag}] {line}")
    log(f"[{tag}] {json.dumps(rec)}")
    if not (rec["tum_equal"] and rec["ckpt_equal"]):
        raise RuntimeError(f"{tag}: TUM equal {rec['tum_equal']}, checkpoint equal {rec['ckpt_equal']}")
    if two["devices"] != MESH_RANKS or any(two[k] != one[k] for k in (
            "replicas", "scans", "mean_matched", "ate_per_replica_m")):
        raise RuntimeError(f"{tag}: {MESH_RANKS} ranks {two} against one process {one}")
    for c in counters:
        if {k: c[k] for k in FUSED_KERNELS} != want_rank or c["chain_points"]:
            raise RuntimeError(f"{tag}: a rank's launches {c}, expected {want_rank}")
    if {k: c_one[k] for k in FUSED_KERNELS} != want_one or c_one["chain_points"]:
        raise RuntimeError(f"{tag}: one process's launches {c_one}, expected {want_one}")
    return rec, backends


def mesh_broadcast_case(torch, tag, cfg, env_edit=None):
    """``sweep --pallas --pipeline deferred --replicas 8 --duration 2
    --config_file CFG`` in this process and on MESH_RANKS ranks: the same
    final_spread_m; each rank's six kernels launched once a fleet step."""
    from legkilo_torch import cli

    common = ["sweep", "--pallas", "--pipeline", "deferred", "--config_file", cfg] + MESH_BROADCAST
    one = cli_json(cli, common)
    two, counters, _ = run_ranks(common, MESH_RANKS, env_edit)
    log(f"[{tag}] one process {json.dumps(one)}; {MESH_RANKS} ranks {json.dumps(two)}; "
        f"rank counters {json.dumps(counters)}")
    if (two["processes"], two["devices"], two["replicas"]) != (MESH_RANKS, MESH_RANKS,
                                                              one["replicas"]):
        raise RuntimeError(f"{tag}: report {two}")
    if two["final_spread_m"] != one["final_spread_m"] or not np.isfinite(two["final_spread_m"]):
        raise RuntimeError(f"{tag}: final_spread_m {two['final_spread_m']} on {MESH_RANKS} ranks, "
                           f"{one['final_spread_m']} in one process")
    steps = 3 + two["scans"]  # the warm-up steps and the timed ones
    for c in counters:
        if any(c[k] != steps for k in FUSED_KERNELS) or c["chain_points"]:
            raise RuntimeError(f"{tag}: a rank's launches {c}, expected {steps} each")
    return one, two


def phase_mesh(torch):
    """The fleet across ranks (legkilo_torch/parallel/: one process a card,
    torch.distributed): MESH_RANKS ranks share the one card (gloo, by
    multihost.backend_for) against one process, in ``--distinct`` and in
    broadcast mode.  With two cards or more, the same over NCCL with a rank
    a card and ``scale`` over 1 ... n cards; on one card a line says those
    did not run."""
    import shutil

    from legkilo_torch.parallel import multihost

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cards = torch.cuda.device_count()
    # Both ranks on this process's card: the first visible one.
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    share = {"CUDA_VISIBLE_DEVICES": first}
    backend = multihost.backend_for("cuda", MESH_RANKS, 1)
    log(f"[mesh] {MESH_RANKS} ranks sharing one card: backend {backend} "
        f"(multihost.backend_for: more ranks than cards on the host)")
    if backend != "gloo":
        raise RuntimeError(f"mesh: backend {backend} for two ranks on one card")
    cfg = os.path.join(root, "bench.yaml")
    bag_config_file(cfg, use_kin=False)
    rec, backends = mesh_distinct_case(torch, "mesh", root, cfg, share)
    if len(backends) != MESH_RANKS or not all("backend gloo" in l for l in backends):
        raise RuntimeError(f"mesh: the ranks logged {backends}")
    one, two = mesh_broadcast_case(torch, "mesh_broadcast", cfg, share)
    out = dict(distinct=rec, broadcast_one=one, broadcast_ranks=two)
    if cards >= 2:
        nccl, backends = mesh_distinct_case(torch, "mesh_nccl", root, cfg)
        if not all("backend nccl" in l for l in backends):
            raise RuntimeError(f"mesh_nccl: the ranks logged {backends}")
        mesh_broadcast_case(torch, "mesh_nccl_broadcast", cfg)
        counts = ",".join(str(n) for n in range(1, cards + 1))
        scale, _, _ = run_ranks(["scale", "--devices", counts, "--duration",
                                 str(SCALE_DURATION_S)], cards)
        log(f"[mesh_scale] {json.dumps(scale)}")
        out.update(nccl=nccl, scale=scale)
    else:
        log("[mesh] NCCL with a rank a card and scale across cards not run: this machine has "
            f"{cards} card")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[mesh] replica-scans/s --distinct 4: one process {rec['one']['replica_scans_per_s']}, "
        f"{MESH_RANKS} ranks on the card {rec['ranks']['replica_scans_per_s']}; broadcast B = 8: "
        f"one process {one['replica_scans_per_s']}, {MESH_RANKS} ranks "
        f"{two['replica_scans_per_s']}; {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_scale(torch):
    """``scale --devices 1 --duration 1.0`` in this process: the sequential
    pipeline of a default StaticConfig (no switched kernel launches, only the
    claim kernel), one record of efficiency 1.0."""
    from legkilo_torch import cli

    t_phase = time.perf_counter()
    reset_counters()
    recs = cli_json(cli, ["scale", "--devices", "1", "--duration", str(SCALE_DURATION_S)])
    counts = read_counters()
    log(f"[scale] {json.dumps(recs)}; launches {json.dumps(counts)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    if len(recs) != 1 or recs[0]["devices"] != 1 or recs[0]["efficiency"] != 1.0:
        raise RuntimeError(f"scale: {recs}")
    if not recs[0]["replica_scans_per_s"] > 0 or not only_the_claims(counts):
        raise RuntimeError(f"scale: {recs}, launches {counts}")
    return recs


def clutter_data():
    """tests/test_cluttered_world.py's data: 4 s, 2,000 points a scan, seed
    3, its trajectory, on cluttered_world(seed=7)."""
    from legkilo_torch.models import sim

    traj = sim.Trajectory(speed=0.8, z0=1.0, roll_amp=0.05, pitch_amp=0.03, bob=0.03)
    return sim.simulate(sim.SimConfig(duration=4.0, scan_points=2000, seed=3),
                        world=sim.cluttered_world(seed=7), traj=traj)


def phase_clutter(torch):
    """bench.py's five-kernel configuration streamed over the cluttered
    world (rubble steps and crossing discs: L0 voxels that refuse a plane
    fit, the non-planar branches of select and fit), held to the JAX test's
    bounds (RMS and final position error, mean match rate after 5 scans,
    non-planar L0 voxels, planar L1 children inside them); every fused
    kernel launched, chain_points never."""
    from legkilo_torch.runner import OdometryRunner, bench_config, replay

    t_phase = time.perf_counter()
    data = clutter_data()
    t_sim = time.perf_counter() - t_phase
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = OdometryRunner(bench_config(), device="cuda")
    for _ in replay(runner, data.scans, data.imu):
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    _, gt = data.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(data.gt_times)}
    errs = np.array([np.linalg.norm(r.pos - gt[gtm[round(r.time, 6)]])
                     for r in runner.results if round(r.time, 6) in gtm])
    vm, c = runner.carry.vm, runner.scfg.map_cfg.capacity
    meta, ptab = vm.meta.cpu().numpy(), vm.ptab.cpu().numpy()
    nonplane0 = (meta[:c, 2] > 0) & ~(ptab[:c, 4] > 0)
    plane1 = (meta[c:2 * c, 2] > 0) & (ptab[c:2 * c, 4] > 0)
    parents = {tuple(k) for k in ptab[:c][nonplane0, 0:3]} & {
        tuple(k) for k in np.floor_divide(ptab[c:2 * c][plane1, 0:3], 2)}
    rec = dict(scans=len(runner.results), rms_m=float(np.sqrt((errs ** 2).mean())),
               final_m=float(errs[-1]), match_rate=float(np.mean(
                   [r.n_matched / max(r.n_points, 1) for r in runner.results[5:]])),
               nonplanar_l0=int(nonplane0.sum()), parents=len(parents),
               ms_per_scan=wall / len(runner.results) * 1e3, sim_s=t_sim, launches=counts)
    log(f"[clutter] {json.dumps(rec)}; bounds {json.dumps(CLUTTER_BOUNDS)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    b = CLUTTER_BOUNDS
    if not (rec["rms_m"] < b["rms_m"] and rec["final_m"] < b["final_m"]
            and rec["match_rate"] > b["match_rate"] and rec["nonplanar_l0"] >= b["nonplanar_l0"]
            and rec["parents"] >= b["parents"]):
        raise RuntimeError(f"clutter: {rec} outside {b}")
    if any(counts[k] <= 0 for k in FUSED_KERNELS) or counts["chain_points"]:
        raise RuntimeError(f"clutter: launches {counts}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,main,chunk,stream1,four,profile,kin,points,points_kin,"
                            "slide,points_chunk,ref2ms,repeat,leg_fusion,mixed,seq,seq_kin,"
                            "bag,bag_kin,fleet_equal,fleet,fleet_scale,fleet_bags,fleet_seq,"
                            "fleet_leg_fusion,fleet_points,mesh,scale,clutter")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        import legkilo_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the legkilo_torch package is not here ({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t_start = time.perf_counter()
    phase_build()
    recs = phase_kernels(torch, dev) if "kernels" in phases else {}
    fleet_recs = phase_fleet_kernels(torch, dev) if "kernels" in phases else {}
    main_rec = kin_rec = points_rec = points_kin_rec = ref2ms_rec = fleet_rec = None
    points_fleet_rec = points_kin_fleet_rec = None
    if phases & {"main", "chunk", "stream1", "four", "points", "slide", "points_chunk", "ref2ms",
                  "repeat", "leg_fusion", "mixed", "seq", "seq_kin", "bag", "fleet", "fleet_scale",
                  "fleet_bags", "fleet_seq", "fleet_leg_fusion", "fleet_points"}:
        data = simulate(MAIN_DURATION_S, "main")
        if "main" in phases:
            main_rec = run_workload(torch, data, "main")
        if "chunk" in phases:
            run_workload(torch, data, "chunk", chunk=CHUNK)
            log(f"[chunk] run_offline(chunk={CHUNK}) stages every packet on the host first; "
                f"its ms/scan includes that staging")
        if "stream1" in phases:
            run_workload(torch, data, "stream1", latch=False)
        if "points" in phases:
            points_rec = run_workload(torch, data, "points", points=True)
        if "four" in phases:
            run_workload(torch, cut(data, FOUR_DURATION_S), "four", five=False)
        extra = cut(data, EXTRA_DURATION_S)
        if "slide" in phases:
            run_workload(torch, extra, "slide", edit=slide_edit, slides=True)
        if "points_chunk" in phases:
            run_workload(torch, extra, "points_chunk", points=True, chunk=CHUNK)
        if "ref2ms" in phases:
            ref2ms_rec = run_workload(torch, extra, "ref2ms", chunk=CHUNK, edit=ref2ms_edit)
            cfg, _ = path_config()
            ref2ms_edit(cfg)
            log(f"[ref2ms] packetizer: {packetizer_of(cfg, extra.scans[0])}")
        if "repeat" in phases:
            phase_repeat(torch, cut(data, REPEAT_DURATION_S))
        if "leg_fusion" in phases:
            run_workload(torch, cut(data, SLOW_DURATION_S), "leg_fusion", use_kin=True,
                         min_scans=SLOW_SCANS,
                         config=leg_fusion_config,
                         window=("profile_leg_fusion", SLOW_WARM, SLOW_PROF))
        if "mixed" in phases:
            run_workload(torch, cut(data, MIXED_DURATION_S), "mixed", config=mixed_config)
        if "seq" in phases:
            run_workload(torch, cut(data, SLOW_DURATION_S), "seq", config=seq_config,
                         min_scans=SLOW_SCANS,
                         window=("profile_seq", SLOW_WARM, SLOW_PROF))
        if "seq_kin" in phases:
            run_workload(torch, cut(data, SLOW_DURATION_S), "seq_kin", use_kin=True,
                         min_scans=SLOW_SCANS,
                         config=seq_kin_config)
        if "bag" in phases:
            phase_bag(torch, cut(data, BAG_DURATION_S), "bag", use_kin=False, bound=ATE_BOUND_M,
                      kernels=FUSED_KERNELS)
        if "fleet" in phases:
            fleet_rec = phase_fleet(torch, data)
        if "fleet_scale" in phases:
            phase_fleet_scale(torch, data)
        if "fleet_bags" in phases:
            phase_fleet_bags(torch, data)
        if "fleet_seq" in phases:
            phase_fleet_seq(torch, data)
        if "fleet_leg_fusion" in phases:
            phase_fleet_leg_fusion(torch, data)
        if "fleet_points" in phases:
            points_fleet_rec, points_kin_fleet_rec = phase_fleet_points(torch, data)
    if "fleet_equal" in phases:
        phase_fleet_equal(torch)
    if "mesh" in phases:
        phase_mesh(torch)
    if "scale" in phases:
        phase_scale(torch)
    if "clutter" in phases:
        phase_clutter(torch)
    if "profile" in phases:
        p4 = phase_profile(torch, "profile4", five=False)
        p5 = phase_profile(torch, "profile5")
        log(f"[profile] device launches/scan {p4['launches_per_scan']:.0f} -> "
            f"{p5['launches_per_scan']:.0f}, device busy ms/scan {p4['device_ms_per_scan']:.3f} -> "
            f"{p5['device_ms_per_scan']:.3f} (four -> five kernels)")
        if "points" in phases:
            pp_ = phase_profile(torch, "profile_points", points=True)
            log(f"[profile] per-point path: {pp_['launches_per_scan']:.0f} device launches/scan, "
                f"device busy {pp_['device_ms_per_scan']:.3f} ms/scan, host wall "
                f"{pp_['wall_ms_per_scan']:.3f} ms/scan")
    if phases & {"kin", "points_kin", "bag_kin"}:
        kin_data = simulate(KIN_DURATION_S, "kin")
        if "kin" in phases:
            kin_rec = run_workload(torch, kin_data, "kin", use_kin=True)
        if "points_kin" in phases:
            points_kin_rec = run_workload(torch, kin_data, "points_kin", use_kin=True, points=True)
        if "bag_kin" in phases:
            phase_bag(torch, kin_data, "bag_kin", use_kin=True, bound=KIN_BAG_ATE_BOUND_M,
                      kernels=FUSED_KERNELS)
    log(f"[done] phases {sorted(phases)} in {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, rec in recs.items():
        if name in ("pose_384", "pose_1280"):  # off the main path's shape: held above, not listed
            continue
        # The run whose counters give the kernel's launches: each chain on
        # its own path's run, select at NB = 56 on the 2 ms bucket run, the
        # rest on the main path's.
        run, counter = {
            "select_56": (ref2ms_rec, "select"),
            "chain_stats_kin": (kin_rec, "chain_stats"),
            "chain_points": (points_rec, "chain_points"),
            "chain_points_kin": (points_kin_rec, "chain_points"),
        }.get(name, (main_rec, name))
        launches = run["launches"][counter] if run else 0
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
        })
    for name, rec in fleet_recs.items():
        base = name[: -len(FLEET_SUFFIX)]
        # The fused path's kernels count in "fleet", the per-point chain's
        # branches in the per-point fleets of "fleet_points".
        run, counter = {
            "chain_points": (points_fleet_rec, "chain_points"),
            "chain_points_kin": (points_kin_fleet_rec, "chain_points"),
        }.get(base, (fleet_rec, base))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[base], "replaces": REPLACES[base],
            "launches": run["launches"][counter] if run else 0,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        })
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
