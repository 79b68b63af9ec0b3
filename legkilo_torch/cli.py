"""Command line: ``python -m legkilo_torch run|eval|sim``.

``run`` replays a ROS1 bag through the port, as ``python -m legkilo_tpu
run`` does: PointCloud2 scans decoded by ``lidar_type``, Imu messages (or,
with ``only_imu_use: false``, unitree HighState messages through the leg
kinematics), exact repeats of acc.z/gyr.z dropped when ``redundancy`` is
on, a TUM trajectory (``--traj_out``), the registered clouds as PCD files
(``--save_pcd DIR``), the plane map as a PLY mesh (``--export_planes``), and
``--save_ckpt`` / ``--resume`` checkpoints.  It prints one JSON line:

    {"scans": N, "messages": M, "wall_s": t, "ms_per_scan": t,
     "match_ratio": r, "decode_ms": t, "step_ms": t, "packetizer": "native"}

(``decode_ms`` and ``step_ms`` are the Timer averages of the scan decode and
of the step's dispatch; ``packetizer`` is the one that built the last scan
packet).  ``eval`` scores a TUM trajectory against another one and prints
the JAX command's JSON keys (pairs, ATE aligned and not, RPE).

``sim`` runs the synthetic world end to end through the port and prints one
JSON line, as ``python -m legkilo_tpu sim`` does:

    {"scans": N, "ate_rmse_m": x, "wall_s": t, "ms_per_scan": t}

It takes the JAX command's configuration: ``--config_file`` as written (or
the default ``Config()``, the sequential pipeline, without one), with
``filter_num`` 1 and ``blind`` 0.3 for the sim's rig; ``--pipeline`` picks
the sequential or the deferred pipeline and ``--pallas`` turns all five
kernel switches on.  Every configuration the JAX package runs runs here:
either pipeline, each kernel switch on or off (a phase whose switch is off
takes its plain torch path, as JAX takes its XLA path), either
``tpu_chain_impl``.  The runner refuses only an unknown ``tpu_chain_impl``
or ``tpu_match_pose`` and a ``tpu_dtype`` other than float32 (bench.py's
workload is ``runner.bench_config()``, for Python callers).  ``--chunk K``
replays K staged scans a call; ``--save_ckpt`` snapshots at the end and
``--resume`` with ``--skip_scans N`` continues such a run from scan N.

``run`` and ``sim`` take ``--device``: ``cuda`` (the default) raises when no
card is present; ``cpu`` runs the plain PyTorch versions of the kernels.
Every command logs to stderr and to a file under ``logs/`` at
``--log_level`` (WARNING by default).
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np

log = logging.getLogger("legkilo_torch")


def cmd_run(args: argparse.Namespace) -> int:
    from . import config as config_mod
    from .io import rosbag as bag_mod
    from .io.dataset import ImuEvent
    from .io.tum import TrajectoryWriter
    from .models import lidar as lidar_mod
    from .models.unitree import HighState, Kinematics
    from .runner import OdometryRunner
    from .utils.profiling import ScanStats
    from .utils.timing import Timer, sync

    cfg = config_mod.load(args.config_file)
    runner = OdometryRunner(cfg, return_cloud=bool(args.save_pcd), device=args.device)
    if args.resume:
        step = runner.load_checkpoint(args.resume)
        log.info("Resumed from %s at step %d", args.resume, step)
    kin = Kinematics(cfg.kinematics)
    writer = TrajectoryWriter(args.traj_out) if args.traj_out else None
    pcd = None
    if args.save_pcd:
        from .io.pcd import PcdSaver

        pcd = PcdSaver(
            directory=args.save_pcd,
            frames_per_file=cfg.pcd_frames_per_file,
            leaf_size=cfg.pcd_voxel_leaf_size,
        )
    stats = ScanStats()

    def handle(r):
        stats.update(r.n_raw, r.n_points, r.n_matched)
        if r.n_points:
            log.info(
                "scan t=%.3f pos=(%.3f %.3f %.3f) matched %d/%d (%.0f%%)",
                r.time, *r.pos, r.n_matched, r.n_points,
                100.0 * r.n_matched / max(r.n_points, 1),
            )
        if writer:
            writer.write(r.time, r.rot, r.pos)
        if pcd is not None and r.cloud_world is not None:
            pcd.save(r.cloud_world, intensity=r.intensity)

    Timer.reset()
    n_msgs = 0
    last_acc_z = last_gyr_z = None  # redundancy rejection state
    t0 = time.perf_counter()
    with bag_mod.BagReader(args.bag) as reader:
        topics = [cfg.lidar_topic, cfg.imu_topic, cfg.kinematic_topic]
        for msg in reader.messages(topics):
            n_msgs += 1
            if msg.topic == cfg.lidar_topic:
                with Timer.measure("Lidar Processing"):
                    scan = lidar_mod.decode(bag_mod.parse_pointcloud2(msg.raw), cfg.lidar)
                results = runner.add_scan(scan)
            elif msg.topic == cfg.imu_topic and cfg.only_imu_use:
                imu = bag_mod.parse_imu(msg.raw)
                # 500 Hz publish / 50 Hz effective: drop exact-duplicate
                # samples (redundancy, ros_interface.cc:198-204).
                if cfg.redundancy and (
                    imu.linear_acceleration[2] == last_acc_z
                    and imu.angular_velocity[2] == last_gyr_z
                ):
                    continue
                last_acc_z = imu.linear_acceleration[2]
                last_gyr_z = imu.angular_velocity[2]
                results = runner.add_imu(
                    ImuEvent(time=imu.stamp, acc=imu.linear_acceleration,
                             gyr=imu.angular_velocity)
                )
            elif msg.topic == cfg.kinematic_topic and not cfg.only_imu_use:
                hs = bag_mod.parse_high_state(msg.raw)
                if cfg.redundancy and (
                    hs.accelerometer[2] == last_acc_z
                    and hs.gyroscope[2] == last_gyr_z
                ):
                    continue
                last_acc_z = hs.accelerometer[2]
                last_gyr_z = hs.gyroscope[2]
                results = runner.add_kin_imu(
                    kin.processing(HighState(
                        stamp=hs.stamp, accelerometer=hs.accelerometer,
                        gyroscope=hs.gyroscope, motor_q=hs.motor_q,
                        motor_dq=hs.motor_dq, foot_force=hs.foot_force,
                    ))
                )
            else:
                continue
            for r in results:
                handle(r)
    for r in runner.flush():
        handle(r)
    if writer:
        writer.close()
    if pcd is not None:
        pcd.close()
    if args.save_ckpt:
        path = runner.save_checkpoint(args.save_ckpt)
        log.info("Saved checkpoint to %s", path)
    if args.export_planes:
        from .io.plane_export import export_plane_map

        n_planes = export_plane_map(
            runner.carry.vm, runner.scfg.map_cfg, args.export_planes
        )
        log.info("Exported %d planes to %s", n_planes, args.export_planes)
    sync(runner.carry)
    wall = time.perf_counter() - t0
    n_scans = len(runner.results)
    log.info("Replayed %d messages, %d scans in %.1fs", n_msgs, n_scans, wall)
    Timer.log_all_average_time()
    print(json.dumps({
        "scans": n_scans, "messages": n_msgs, "wall_s": round(wall, 3),
        "ms_per_scan": round(wall / max(n_scans, 1) * 1e3, 3),
        "match_ratio": stats.report()["match_ratio"],
        "decode_ms": round(Timer.average_ms("Lidar Processing"), 3),
        "step_ms": round(Timer.average_ms("State predict/update & Map update"), 3),
        "packetizer": runner.builder.packetizer,
    }))
    return 0


def cmd_sim(args: argparse.Namespace) -> int:
    import torch

    from . import config as config_mod
    from .io.tum import TrajectoryWriter, ate_rmse
    from .models import sim as sim_mod
    from .runner import run_offline

    cfg = config_mod.load(args.config_file) if args.config_file else config_mod.Config()
    cfg.lidar.filter_num = 1
    cfg.lidar.blind = 0.3
    if args.pipeline:
        cfg.tpu.pipeline = args.pipeline
    if args.pallas:
        cfg.tpu.use_pallas = cfg.tpu.use_pallas_match = cfg.tpu.use_pallas_insert = True
        cfg.tpu.use_pallas_pose = cfg.tpu.use_pallas_refit = True
    data = sim_mod.simulate(sim_mod.SimConfig(duration=args.duration, scan_points=args.scan_points))
    events = data.imu if cfg.only_imu_use else data.kin
    scans = data.scans
    if args.resume and args.skip_scans:
        # Continue a checkpointed run: drop the scans already processed and
        # the events the checkpoint consumed (those buffered in between come
        # back from the checkpoint; earlier ones would trip the packetizer's
        # time-regression reset).
        scans = scans[args.skip_scans:]
        with np.load(args.resume) as d:
            let = float(d["x_last_event_time"])
        events = [e for e in events if e.time > let]
    t0 = time.perf_counter()
    results = run_offline(cfg, scans, events, device=args.device, resume=args.resume,
                          save_ckpt=args.save_ckpt, chunk=args.chunk)
    if args.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    est_t = np.array([r.time for r in results])
    est_p = np.stack([r.pos for r in results])
    _, gt_pos_f = data.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(data.gt_times)}
    sel = [i for i, t in enumerate(est_t) if round(t, 6) in gtm]
    idx = [gtm[round(est_t[i], 6)] for i in sel]
    err = ate_rmse(est_p[sel], gt_pos_f[idx], align=False)
    if args.traj_out:
        with TrajectoryWriter(args.traj_out) as w:
            for r in results:
                w.write(r.time, r.rot, r.pos)
    print(json.dumps({
        "scans": len(results), "ate_rmse_m": round(err, 4),
        "wall_s": round(wall, 2), "ms_per_scan": round(wall / max(len(results), 1) * 1e3, 2),
    }))
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    """Offline trajectory evaluation (the evo/ATE workflow the reference
    delegates to external tools; SURVEY.md §4.2)."""
    from .io.tum import associate, ate_rmse, read_tum, rpe

    t_est, p_est, q_est = read_tum(args.est)
    t_gt, p_gt, q_gt = read_tum(args.gt)
    ia, ib = associate(t_est, t_gt, max_dt=args.max_dt)
    if len(ia) < 2:
        print(json.dumps({"error": "fewer than 2 associated poses"}))
        return 1
    rpe_t, rpe_r = rpe(
        p_est[ia], p_gt[ib], q_est[ia], q_gt[ib], delta=args.rpe_delta
    )
    out = {
        "pairs": int(len(ia)),
        "ate_rmse_m": round(ate_rmse(p_est[ia], p_gt[ib], align=not args.no_align), 4),
        "ate_rmse_unaligned_m": round(ate_rmse(p_est[ia], p_gt[ib], align=False), 4),
        "rpe_trans_rmse_m": round(rpe_t, 4),
        "rpe_rot_rmse_deg": round(float(np.degrees(rpe_r)), 4),
    }
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    from .utils.logging import setup as setup_logging

    parser = argparse.ArgumentParser(prog="legkilo_torch")
    parser.add_argument("--log_level", default="WARNING")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="replay a rosbag")
    p.add_argument("--config_file", required=True)
    p.add_argument("--bag", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--traj_out", default=None)
    p.add_argument("--save_pcd", default=None, help="PCD output directory")
    p.add_argument("--export_planes", default=None,
                   help="write the voxel plane map as a colored PLY mesh")
    p.add_argument("--save_ckpt", default=None,
                   help="write a filter checkpoint (.npz) at stream end")
    p.add_argument("--resume", default=None, help="restore a checkpoint before replay")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sim", help="synthetic world end to end; prints ATE")
    p.add_argument("--config_file", default=None)
    p.add_argument("--duration", type=float, default=3.0)
    p.add_argument("--scan_points", type=int, default=3000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--traj_out", default=None)
    p.add_argument("--pipeline", default=None, choices=["sequential", "deferred"])
    p.add_argument("--pallas", action="store_true",
                   help="turn all five kernel switches on (chain, match, insert, pose, refit)")
    p.add_argument("--chunk", type=int, default=0, help="replay this many scans a call (> 1)")
    p.add_argument("--resume", default=None, help="checkpoint (.npz) to continue from")
    p.add_argument("--save_ckpt", default=None, help="write a checkpoint at the end")
    p.add_argument("--skip_scans", type=int, default=0,
                   help="with --resume: scans the checkpointed run already processed")
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("eval", help="ATE between two TUM trajectories")
    p.add_argument("--est", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--max_dt", type=float, default=0.02)
    p.add_argument("--no_align", action="store_true")
    p.add_argument("--rpe_delta", type=int, default=1,
                   help="frame delta for the relative pose error")
    p.set_defaults(fn=cmd_eval)

    args = parser.parse_args(argv)
    setup_logging(log_dir="logs", level=getattr(logging, args.log_level.upper(), logging.WARNING))
    return args.fn(args)
