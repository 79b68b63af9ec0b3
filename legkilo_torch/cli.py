"""Command line: ``python -m legkilo_torch sim``.

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
``--device cuda`` (the default) raises when no card is present;
``--device cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="legkilo_torch")
    parser.add_argument("--log_level", default="WARNING")
    sub = parser.add_subparsers(dest="cmd", required=True)
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
    args = parser.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.WARNING))
    return args.fn(args)
