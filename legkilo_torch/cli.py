"""Command line: ``python -m legkilo_torch run|eval|sim|sweep|scale``.

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

``sweep`` is the fleet, as ``python -m legkilo_tpu sweep``: B filter
replicas on one card (parallel/sweep.py), running the configuration as
written: with ``only_imu_use: false`` a kinematic fleet (IMU and leg
kinematics fused; the sim's kin events, or a bag's HighState messages
through the leg kinematics, as ``run`` reads them), where the JAX command
runs IMU only.  Without ``--distinct`` or
``--bags`` it replays one sim (``--duration``) through ``--replicas`` B
replicas from the empty filter, ``q_diag`` jittered by ``--noise_scale``,
and prints {"replicas", "devices", "processes", "scans", "wall_s",
"replica_scans_per_s", "final_spread_m"} (after 3 warm-up steps);
``--distinct N`` replays N different synthetic worlds and ``--bags DIR`` one
replica a ``.bag``, each replica initialised from its own first packet and
stepped through its own packets, and prints {"replicas", "devices",
"scans", "wall_s", "replica_scans_per_s", "mean_matched", "chunk"} with
``ate_per_replica_m`` (sims), ``resumed_at`` and ``checkpoint`` where they
apply; ``--traj_out DIR`` writes a TUM file a replica, ``--save_ckpt`` /
``--resume`` / ``--max_steps`` split a long sweep (the fleet checkpoint is
the JAX CLI's npz).  ``--chunk K`` advances the fleet K scans a call (in
every mode here; the JAX command reads it with ``--distinct``/``--bags``
only).  ``--pallas`` turns on all five kernel switches, in every mode (the
JAX command reads it without ``--distinct``/``--bags`` only), and sets a
``tpu_map_insert_row_cap`` of 0 to 4,096 (``runner.bench_config``'s): the
fused path inserts on its kernel only under a row cap.  On every
configuration (either pipeline, any kernel switches, the per-point chain)
a fleet step is one batched step for all B replicas, as the JAX command's
``vmap``: it launches what one filter's step launches, whatever B is
(with ``--pallas``, each kernel once a match pass).

``sweep`` and ``scale`` take the JAX command's multi-process flags,
``--coordinator HOST:PORT --num_processes N --process_id I``: one process a
card (parallel/multihost.py), each rank stepping its own B/N replicas and
the fleet statistics reduced over all of them; without ``--coordinator``
the process group comes from ``torchrun``'s environment.  Rank 0 prints
the report; broadcast mode reports ``processes`` (the world size) and
``devices`` (the mesh size).  With ``--distinct``/``--bags`` every rank
loads every stream and steps its own shard, ``--traj_out`` files are
written by the rank that holds the replica, ``mean_matched`` and
``ate_per_replica_m`` cover the whole fleet, ``--save_ckpt`` writes (on
rank 0) the whole fleet in rank order and ``--resume`` gives each rank its
rows; a run across ranks equals the one-process run.  (The JAX command
converts sharded outputs with ``np.asarray``, which JAX refuses across
processes, so this mode is held against the port's one process.)

``scale`` measures weak-scaling efficiency (parallel/scaling.py) as the JAX
command does: the sequential pipeline of a default ``StaticConfig`` on a
sim of ``--duration``, ``--replicas_per_device`` replicas a rank on meshes
of the first n ranks for each n of ``--devices``, and prints the records
(devices, replicas, wall_s, replica_scans_per_s, efficiency) as one JSON
list.

``run``, ``sim``, ``sweep`` and ``scale`` take ``--device``: ``cuda`` (the
default) raises when no card is present; ``cpu`` runs the plain PyTorch
versions of the kernels (and the gloo backend across ranks).
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

# ``sweep --pallas``'s insert row cap where the configuration sets none
# (runner.bench_config's).
SWEEP_ROW_CAP = 4096


def _load_config(path):
    from . import config as config_mod

    return config_mod.load(path) if path else config_mod.Config()


def _maybe_multihost(args) -> bool:
    """Bring the process group up from the flags (before any CUDA call);
    True in a run of more than one process."""
    from .parallel import multihost

    if args.coordinator or args.num_processes:
        multihost.initialize(coordinator_address=args.coordinator,
                             num_processes=args.num_processes,
                             process_id=args.process_id, device=args.device)
    return multihost.process_count() > 1


def _add_multihost_args(p) -> None:
    p.add_argument("--coordinator", default=None,
                   help="process group address host:port (rank 0 listens there)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


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

    from .io.tum import TrajectoryWriter, ate_rmse
    from .models import sim as sim_mod
    from .runner import run_offline

    cfg = _load_config(args.config_file)
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


def _packets_from_streams(cfg, scans, events, use_kin: bool):
    """scans + events -> ordered HostPackets (run_offline's feed loop).

    The fleet consumes these packets through a batched step with no
    per-replica host intervention, so the streaming path's tpu_gap_reset_s
    soft reset cannot be applied there: fleet replay is gap-unsafe (a sensor
    hole longer than the gap is mean-propagated), and such a gap is reported
    here instead of diverging silently."""
    from .io.dataset import PacketBuilder
    from .runner import _scans_after_their_events

    builder = PacketBuilder(cfg)
    packets = []
    add_event = builder.add_kin_imu if use_kin else builder.add_imu
    for scan in _scans_after_their_events(add_event, scans, events):
        builder.add_scan(scan)
        while builder.ready():
            packets.append(builder.pop())
    gap = float(cfg.tpu.gap_reset_s)
    if gap > 0.0:
        for p in packets:
            if p.rebase > gap:
                log.warning(
                    "staged packet has a %.1f s sensor gap (> tpu_gap_reset_s=%.1f); fleet "
                    "replay cannot soft-reset per replica — this stream's trajectory will "
                    "differ from streaming replay (use `run` for gap recovery)", p.rebase, gap,
                )
    return packets


def _load_bag_streams(cfg, path: str):
    """One .bag -> (scans, events): Imu messages, or with ``only_imu_use:
    false`` unitree HighState messages through the leg kinematics, as
    ``run`` reads them; exact repeats of acc.z/gyr.z dropped when
    ``redundancy`` is on (ros_interface.cc:198-204)."""
    from .io import rosbag as bag_mod
    from .io.dataset import ImuEvent
    from .models import lidar as lidar_mod
    from .models.unitree import HighState, Kinematics

    kin = None if cfg.only_imu_use else Kinematics(cfg.kinematics)
    event_topic = cfg.imu_topic if kin is None else cfg.kinematic_topic
    scans, events = [], []
    last_acc_z = last_gyr_z = None
    with bag_mod.BagReader(path) as reader:
        for msg in reader.messages([cfg.lidar_topic, event_topic]):
            if msg.topic == cfg.lidar_topic:
                scans.append(lidar_mod.decode(bag_mod.parse_pointcloud2(msg.raw), cfg.lidar))
                continue
            if kin is None:
                imu = bag_mod.parse_imu(msg.raw)
                acc, gyr = imu.linear_acceleration, imu.angular_velocity
            else:
                hs = bag_mod.parse_high_state(msg.raw)
                acc, gyr = hs.accelerometer, hs.gyroscope
            if cfg.redundancy and acc[2] == last_acc_z and gyr[2] == last_gyr_z:
                continue
            last_acc_z, last_gyr_z = acc[2], gyr[2]
            if kin is None:
                events.append(ImuEvent(time=imu.stamp, acc=acc, gyr=gyr))
            else:
                events.append(kin.processing(HighState(
                    stamp=hs.stamp, accelerometer=acc, gyroscope=gyr, motor_q=hs.motor_q,
                    motor_dq=hs.motor_dq, foot_force=hs.foot_force)))
    return scans, events


def _save_fleet_ckpt(path, carry, bparams, n_done: int, mesh=None) -> str:
    """Fleet checkpoint: the batched carry (every replica's state,
    covariance, clocks and map), the per-replica FilterParams as extras
    ``bp_000`` ... and the fleet step cursor, in the single filter's npz
    container (the JAX CLI's format).  Across ranks every rank gathers the
    whole fleet in rank order and rank 0 writes it: the file one process
    writes for the same fleet.  Returns the path (None on other ranks)."""
    from .convert import carry_from_leaves, carry_leaves, params_leaves
    from .io import checkpoint as ckpt
    from .parallel.mesh import gather_rows
    from .parallel.multihost import process_index

    leaves = carry_leaves(carry) + params_leaves(bparams)
    if mesh is not None:
        leaves = gather_rows(mesh, leaves)
    if process_index() != 0:
        return None
    extras = {f"bp_{i:03d}": leaf.cpu().numpy() for i, leaf in enumerate(leaves[12:])}
    return ckpt.save(path, carry_from_leaves(leaves[:12]), step=int(n_done), extras=extras)


def _load_fleet_ckpt(path, carry_like, bparams_like, mesh=None):
    """(carry, bparams, n_done) saved by ``_save_fleet_ckpt``: this rank's
    rows of the whole fleet, checked against templates of this rank's
    shard; another replica count or config raises ValueError."""
    from .convert import carry_from_leaves, carry_leaves, params_from_numpy, params_leaves
    from .convert import load_jax_checkpoint
    from .parallel.mesh import LocalMesh, shard_rows

    mesh = mesh or LocalMesh()
    carry, step, extras = load_jax_checkpoint(path, carry_like.cov.device)
    n = mesh.size()
    rows = shard_rows(mesh, n * int(carry_like.cov.shape[0]))
    got = carry_leaves(carry) + [extras[f"bp_{i:03d}"] for i in range(len(params_leaves(bparams_like)))]
    likes = carry_leaves(carry_like) + params_leaves(bparams_like)
    for i, (x, like) in enumerate(zip(got, likes)):
        want = (n * like.shape[0],) + tuple(like.shape[1:])
        if tuple(x.shape) != want:
            raise ValueError(f"fleet checkpoint leaf {i} shape {tuple(x.shape)} != {want} "
                             "(replica count / config mismatch?)")
    mine = [x[rows] for x in got]
    carry = carry_from_leaves([x.to(like.dtype) for x, like in zip(mine[:12], likes)])
    return carry, params_from_numpy(mine[12:], carry_like.cov.device), int(step or 0)


def _sweep_distinct(args, cfg, device, mesh) -> int:
    """Distinct-replay fleet: every replica advances through its own stream
    each step.  ``--distinct N`` generates N different synthetic worlds
    (varied trajectory and noise seed); ``--bags`` replays real .bag files.
    Every rank loads every stream and steps its own shard of the replicas
    (module doc)."""
    import glob
    import os

    import torch

    from .io.dataset import decimate_blind, to_device_packet
    from .io.tum import TrajectoryWriter, ate_rmse
    from .models import sim as sim_mod
    from .parallel.mesh import gather_rows, shard_rows
    from .parallel.multihost import process_index
    from .parallel.sweep import (
        fleet_init, make_fleet_chunk_step, make_fleet_step, stack_fleet_chunks, stack_packets,
    )
    from .runner import make_params, make_static_config
    from .utils.timing import sync

    datas = None
    if args.bags:
        paths = sorted(glob.glob(os.path.join(args.bags, "*.bag")))
        if not paths:
            print(json.dumps({"error": f"no .bag files in {args.bags}"}))
            return 1
        streams = [_load_bag_streams(cfg, p) for p in paths]
        names = [os.path.basename(p) for p in paths]
    else:
        datas = []
        for r in range(args.distinct):
            traj = sim_mod.Trajectory(speed=0.6 + 0.12 * (r % 4), radius=2.0 + 0.4 * (r % 3),
                                      bob_freq=1.5 + 0.25 * (r % 4))
            datas.append(sim_mod.simulate(sim_mod.SimConfig(duration=args.duration, seed=100 + r),
                                          traj=traj))
        streams = [(d.scans, d.imu if cfg.only_imu_use else d.kin) for d in datas]
        names = [f"sim{r}" for r in range(len(datas))]

    big_b = len(streams)
    if big_b % mesh.size():
        print(json.dumps({"error": f"{big_b} replicas not divisible by {mesh.size()} devices"}))
        return 1
    mine = shard_rows(mesh, big_b)  # this rank's replicas
    scfg = make_static_config(cfg)
    params = make_params(cfg, device)  # g_over_acc_norm set a replica by fleet_init
    pkt_seqs, first_clouds, mean_accs, mean_gyrs, end_offsets = [], [], [], [], []
    for scans, events in streams:
        # The first packet's event slots hold the stream's own events (the
        # kin events' force and rate on a kinematic configuration).
        pkts = _packets_from_streams(cfg, scans, events, use_kin=scfg.use_kin)
        first = pkts[0]
        m = first.imu_mask
        mean_accs.append(first.imu_acc[m].mean(axis=0))
        mean_gyrs.append(first.imu_gyr[m].mean(axis=0))
        end_offsets.append(first.end_offset)
        pts, _, _ = decimate_blind(scans[0].points, scans[0].time_offset,
                                   cfg.lidar.filter_num, cfg.lidar.blind)
        first_clouds.append(pts)
        pkt_seqs.append(pkts)

    # fleet_init is one initialisation a replica, stacked: this rank's rows
    # of the whole fleet's.
    carry, bparams = fleet_init(scfg, params, first_clouds[mine], np.stack(mean_accs[mine]),
                                np.stack(mean_gyrs[mine]), np.asarray(end_offsets[mine]),
                                float(cfg.gravity), device=device)
    n_done = 0
    if args.resume:
        carry, bparams, n_done = _load_fleet_ckpt(args.resume, carry, bparams, mesh)
        log.info("Resumed fleet from %s at step %d", args.resume, n_done)

    t_min = min(len(seq) for seq in pkt_seqs) - 1  # the whole fleet's steps
    steps = stack_packets([[to_device_packet(p, device) for p in seq[1:1 + t_min]]
                           for seq in pkt_seqs[mine]])
    max_steps = max(0, int(args.max_steps or 0))
    hi = min(len(steps), n_done + max_steps) if max_steps else len(steps)
    steps = steps[n_done:hi]
    if not steps:
        print(json.dumps({"error": f"no steps left to replay (resumed at {n_done})"}))
        return 1
    chunk = min(max(1, int(args.chunk or 1)), len(steps))

    est, est_rot = [], []  # a step's [b, 3], [b, 3, 3]
    stats = None
    if chunk > 1:
        step = make_fleet_chunk_step(scfg, mesh=mesh)
        chunks = stack_fleet_chunks(steps, chunk)
        t0 = time.perf_counter()
        for dev in chunks:
            carry, outs, stats = step(carry, dev, bparams)
            pos, rot = outs.pos.cpu().numpy(), outs.rot.cpu().numpy()  # [b, K, ...]
            for k in range(pos.shape[1]):
                est.append(pos[:, k])
                est_rot.append(rot[:, k])
        n_steps = len(chunks) * chunk
    else:
        step = make_fleet_step(scfg, mesh=mesh)
        t0 = time.perf_counter()
        for dev in steps:
            carry, out, stats = step(carry, dev, bparams)
            est.append(out.pos.cpu().numpy())
            est_rot.append(out.rot.cpu().numpy())
        n_steps = len(steps)
    sync(carry)
    wall = time.perf_counter() - t0
    times = [[p.end_time for p in seq[1 + n_done : 1 + n_done + n_steps]] for seq in pkt_seqs]
    est = np.stack(est)          # [T, b, 3]
    est_rot = np.stack(est_rot)  # [T, b, 3, 3]
    ids = range(big_b)[mine]     # this rank's replicas' indices in the fleet

    report = {
        "replicas": big_b, "devices": mesh.size(), "scans": n_steps, "wall_s": round(wall, 2),
        "replica_scans_per_s": round(big_b * n_steps / max(wall, 1e-9), 1),
        "mean_matched": round(float(stats.mean_matched), 1), "chunk": chunk,
    }
    if n_done:
        report["resumed_at"] = n_done
    if args.save_ckpt:
        report["checkpoint"] = _save_fleet_ckpt(args.save_ckpt, carry, bparams, n_done + n_steps,
                                                mesh)
    if datas is not None:
        ates = np.zeros(len(ids))
        for j, r in enumerate(ids):
            _, gt_pos_f = datas[r].gt_in_filter_frame()
            gtm = {round(t, 6): i for i, t in enumerate(datas[r].gt_times)}
            sel = [i for i, t in enumerate(times[r]) if round(t, 6) in gtm]
            idx = [gtm[round(times[r][i], 6)] for i in sel]
            ates[j] = ate_rmse(est[sel, j], gt_pos_f[idx], align=False)
        (ates,) = gather_rows(mesh, [torch.from_numpy(ates).to(device)])
        report["ate_per_replica_m"] = dict(zip(names, (round(float(a), 4) for a in ates)))
    if args.traj_out:
        os.makedirs(args.traj_out, exist_ok=True)
        for j, r in enumerate(ids):
            with TrajectoryWriter(os.path.join(args.traj_out, f"{names[r]}.tum")) as w:
                for t in range(n_steps):
                    w.write(times[r][t], est_rot[t, j], est[t, j])
    if process_index() == 0:
        print(json.dumps(report))
    return 0


def cmd_sweep(args: argparse.Namespace) -> int:
    multihost_run = _maybe_multihost(args)

    from . import resolve_device
    from .io.dataset import PacketBuilder, to_device_packet
    from .models import sim as sim_mod
    from .parallel.mesh import make_mesh, shard_batch
    from .parallel.multihost import hierarchical_mesh, process_count, process_index
    from .parallel.sweep import (
        batched_carry, broadcast_packets, make_fleet_chunk_step, make_fleet_step, perturb_params,
        stack_fleet_chunks,
    )
    from .runner import make_params, make_static_config
    from .utils.timing import sync

    device = resolve_device(args.device)
    # Across processes the (dcn, ici) mesh: replicas split over hosts first,
    # then over a host's ranks (one a card).
    mesh = hierarchical_mesh(device.type) if multihost_run else make_mesh(device_type=device.type)
    cfg = _load_config(args.config_file)
    cfg.lidar.filter_num = 1
    cfg.lidar.blind = 0.3
    if args.pipeline:
        cfg.tpu.pipeline = args.pipeline
    if args.pallas:
        cfg.tpu.use_pallas = cfg.tpu.use_pallas_match = cfg.tpu.use_pallas_insert = True
        cfg.tpu.use_pallas_pose = cfg.tpu.use_pallas_refit = True
        if not cfg.voxel_map.insert_row_cap:
            # The fused path inserts on the moments kernel only under a row
            # cap: bench_config's where the file sets none.
            cfg.voxel_map.insert_row_cap = SWEEP_ROW_CAP
    if args.distinct or args.bags:
        return _sweep_distinct(args, cfg, device, mesh)

    data = sim_mod.simulate(sim_mod.SimConfig(duration=args.duration))
    scfg = make_static_config(cfg)
    events = data.kin if scfg.use_kin else data.imu
    builder = PacketBuilder(cfg)
    add_event = builder.add_kin_imu if scfg.use_kin else builder.add_imu
    for ev in events:
        add_event(ev)
    packets = []
    for scan in data.scans:
        builder.add_scan(scan)
        while builder.ready():
            packets.append(builder.pop())

    params = make_params(cfg, device, float(cfg.gravity / np.linalg.norm(data.mean_acc)))
    big_b = args.replicas or mesh.size()
    carry = shard_batch(batched_carry(scfg, big_b, device), mesh)
    bparams = shard_batch(perturb_params(params, big_b, scale=args.noise_scale), mesh)
    b = big_b // mesh.size()
    # Every packet staged on the card first: the step rate is the card's.
    # A broadcast packet's shard is the packet broadcast to this rank's b.
    devs = [broadcast_packets(to_device_packet(p, device), b) for p in packets]
    chunk = max(1, int(args.chunk or 1))
    step = make_fleet_step(scfg, mesh=mesh)
    # Warm-up on the first packets (kernel build, map bootstrap); the rate
    # is the steady state's.
    stats = None
    n_warm = min(3, len(devs) - 1)
    for dev in devs[:n_warm]:
        carry, _, stats = step(carry, dev, bparams)
    sync(carry)
    timed = devs[n_warm:]
    t0 = time.perf_counter()
    if chunk > 1:
        step = make_fleet_chunk_step(scfg, mesh=mesh)
        timed = stack_fleet_chunks(timed, chunk)
        n_timed = len(timed) * chunk
    else:
        n_timed = len(timed)
    for dev in timed:
        carry, _, stats = step(carry, dev, bparams)
    sync(carry)
    wall = time.perf_counter() - t0
    report = {
        "replicas": big_b, "devices": mesh.size(), "processes": process_count(),
        "scans": n_timed, "wall_s": round(wall, 2),
        "replica_scans_per_s": round(big_b * n_timed / max(wall, 1e-9), 1),
        "final_spread_m": float(stats.pos_spread),
    }
    if chunk > 1:
        report["chunk"] = chunk
    if process_index() == 0:
        print(json.dumps(report))
    return 0


def cmd_scale(args: argparse.Namespace) -> int:
    """Weak-scaling efficiency across ranks (one a card), as the JAX
    command measures it across devices: the sequential pipeline of a
    default ``StaticConfig``, off every kernel."""
    _maybe_multihost(args)

    from . import resolve_device
    from .core.filter import StaticConfig
    from .core.voxel_map import map_config_from
    from .io.dataset import PacketBuilder, to_device_packet
    from .models import sim as sim_mod
    from .parallel.multihost import process_count, process_index
    from .parallel.scaling import measure_scaling
    from .runner import make_params

    device = resolve_device(args.device)
    cfg = _load_config(args.config_file)
    cfg.only_imu_use = True
    cfg.lidar.filter_num = 1
    cfg.lidar.blind = 0.3
    cfg.voxel_map.capacity_log2 = min(cfg.voxel_map.capacity_log2, 14)
    data = sim_mod.simulate(sim_mod.SimConfig(duration=args.duration))
    builder = PacketBuilder(cfg)
    for ev in data.imu:
        builder.add_imu(ev)
    packets = []
    for scan in data.scans:
        builder.add_scan(scan)
        while builder.ready():
            packets.append(to_device_packet(builder.pop(), device))

    scfg = StaticConfig(map_cfg=map_config_from(cfg.voxel_map), use_kin=False,
                        dept_err=cfg.voxel_map.dept_err, beam_err=cfg.voxel_map.beam_err)
    params = make_params(cfg, device, float(cfg.gravity / np.linalg.norm(data.mean_acc)))
    if args.devices:
        counts = [int(x) for x in args.devices.split(",")]
    else:
        n = process_count()
        counts = sorted({1, max(n // 2, 1), n})
    res = measure_scaling(scfg, params, packets, counts,
                          replicas_per_device=args.replicas_per_device)
    if process_index() == 0:
        print(json.dumps(res))
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

    p = sub.add_parser("sweep", help="Monte-Carlo fleet replay (B replicas, sharded over ranks)")
    p.add_argument("--config_file", default=None)
    p.add_argument("--duration", type=float, default=3.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--replicas", type=int, default=None,
                   help="B (default: one a rank)")
    p.add_argument("--noise_scale", type=float, default=0.1,
                   help="log-normal jitter of each replica's q_diag (broadcast mode)")
    p.add_argument("--pipeline", default=None, choices=["sequential", "deferred"])
    p.add_argument("--pallas", action="store_true",
                   help="turn all five kernel switches on (chain, match, insert, pose, refit); "
                        f"a tpu_map_insert_row_cap of 0 becomes {SWEEP_ROW_CAP}, which the "
                        "insert's kernel needs")
    p.add_argument("--distinct", type=int, default=0,
                   help="fleet over N distinct synthetic worlds; reports per-replica ATE")
    p.add_argument("--bags", default=None,
                   help="directory of .bag files: one replica a bag")
    p.add_argument("--traj_out", default=None,
                   help="with --distinct/--bags: directory for per-replica TUM trajectories")
    p.add_argument("--chunk", type=int, default=0,
                   help="advance the fleet N scans a call (offline throughput mode)")
    p.add_argument("--save_ckpt", default=None,
                   help="with --distinct/--bags: write a fleet checkpoint (.npz) at the end")
    p.add_argument("--resume", default=None,
                   help="with --distinct/--bags: restore a fleet checkpoint and continue")
    p.add_argument("--max_steps", type=int, default=0,
                   help="with --distinct/--bags: stop after N fleet steps")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("scale", help="weak-scaling efficiency across ranks (one a card)")
    p.add_argument("--config_file", default=None)
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--devices", default=None, help="comma list of rank counts, e.g. 1,2,4")
    p.add_argument("--replicas_per_device", type=int, default=1)
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_scale)

    args = parser.parse_args(argv)
    setup_logging(log_dir="logs", level=getattr(logging, args.log_level.upper(), logging.WARNING))
    try:
        return args.fn(args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
