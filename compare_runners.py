#!/usr/bin/env python3
"""The port's runner against the JAX package's, scan by scan, on the CPU.

    JAX_PLATFORMS=cpu python3 compare_runners.py [--five | --points | --pose-routes] [--out FILE]

Both runners replay the bench.py workload (24 s sim, 8000 points a scan,
seed 7, the knobs of runner.bench_config) through ``run_offline``: the JAX
package with its chain, match and insert kernels in interpret mode, the port
on the CPU with their plain versions.  ``--five`` turns the pose and refit
kernels on as well in both (bench.py's own set of five switches);
``--points`` runs both on the per-point path instead (``chain_impl="jax"``
with the pose and refit kernels on: the JAX package's lax.scan chain, the
port's plain version of the per-point chain kernel).  Both build
packets with the numpy path (``tpu_use_native`` off), so they start from the
same bytes.

It prints one JSON object: per runner the scans, the ATE, the scan at which
the auto-escalation to iterated matching fired (the runner's own rule on its
own match rates: below ``tpu_escalate_ratio`` for ``tpu_escalate_after``
scans) and how many escalation warnings the runner logged; then the largest
and mean difference of the per-scan match rate (n_matched / n_points) over the
scans before either escalated.  ``--out`` writes the per-scan rates as JSON.

``--pose-routes`` compares the port with itself instead: the five-switch
configuration with the match poses from the pose kernel's route (doubling
scans) and from the plain cumsum/cummax route, printing how many matches a
scan differ between the two before either escalates.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time

import numpy as np

DURATION_S = 24.0  # bench.py's workload, uncut


class _Count(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.n = 0

    def emit(self, record):
        self.n += "auto-escalating" in record.getMessage()


def first_escalation(results, cfg):
    """Index into ``results`` of the scan whose match rate tripped the
    escalation latch, replaying the runner's rule (None if it never did)."""
    n_done, streak = 0, 0
    for i, r in enumerate(results[1:], start=1):  # results[0] is the first frame
        n_done += 1
        if r.n_points <= 100 or n_done <= 3:
            continue
        streak = streak + 1 if r.n_matched / r.n_points < cfg.tpu.escalate_ratio else 0
        if streak >= cfg.tpu.escalate_after:
            return i
    return None


def run(runner_mod, cfg, data, logger, **kw):
    from legkilo_torch.io.tum import ate_rmse

    count = _Count()
    logging.getLogger(logger).addHandler(count)
    t0 = time.perf_counter()
    res = runner_mod.run_offline(cfg, data.scans, data.imu, **kw)
    wall = time.perf_counter() - t0
    _, gt = data.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(data.gt_times)}
    pairs = [(r.pos, gt[gtm[round(r.time, 6)]]) for r in res if round(r.time, 6) in gtm]
    ate = ate_rmse(np.stack([p for p, _ in pairs]), np.stack([g for _, g in pairs]), align=False)
    rates = [r.n_matched / r.n_points if r.n_points else None for r in res]
    return res, rates, dict(scans=len(res), ate_m=float(ate), escalated_at_scan=first_escalation(res, cfg),
                            escalation_warnings=count.n, wall_s=wall)


def pose_routes(out_path) -> int:
    from legkilo_torch import runner as t_runner
    from legkilo_torch.models import sim

    data = sim.simulate(sim.SimConfig(duration=DURATION_S, scan_points=8000, seed=7))
    recs, res = {}, {}
    for name, on in (("doubling_scans", True), ("cumsum", False)):
        cfg = t_runner.bench_config()
        cfg.tpu.use_native = False
        cfg.tpu.use_pallas_pose = on
        res[name], _, recs[name] = run(t_runner, cfg, data, "legkilo_torch.runner", device="cpu")
    ends = [r["escalated_at_scan"] for r in recs.values() if r["escalated_at_scan"] is not None]
    stop = min(ends) + 1 if ends else len(res["cumsum"])
    diffs = [abs(a.n_matched - b.n_matched)
             for a, b in zip(res["doubling_scans"][1:stop], res["cumsum"][1:stop])]
    summary = {"duration_s": DURATION_S, "pose_route": recs,
               "match_diff_before_escalation": {"scans": len(diffs), "max": max(diffs),
                                                "mean": float(np.mean(diffs))}}
    if out_path:
        with open(out_path, "w") as fh:
            json.dump({"summary": summary, "diffs": diffs}, fh)
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--five", action="store_true",
                    help="all five kernel switches (pose and refit too) in both runners")
    ap.add_argument("--points", action="store_true",
                    help="the per-point path (chain_impl=jax, pose and refit kernels on) in both runners")
    ap.add_argument("--pose-routes", action="store_true",
                    help="the port only: pose kernel route vs plain route, matches a scan")
    args = ap.parse_args(argv)
    if args.pose_routes:
        return pose_routes(args.out)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from legkilo_tpu import config as j_config
    from legkilo_tpu import runner as j_runner

    from legkilo_torch import runner as t_runner
    from legkilo_torch.models import sim

    tcfg = t_runner.bench_config_points() if args.points else t_runner.bench_config()
    tcfg.tpu.use_native = False
    tcfg.tpu.use_pallas_pose = tcfg.tpu.use_pallas_refit = args.five or args.points
    jcfg = j_config.Config()
    for section in ("lidar", "voxel_map", "tpu", "eskf"):
        for f in dataclasses.fields(getattr(tcfg, section)):
            setattr(getattr(jcfg, section), f.name, getattr(getattr(tcfg, section), f.name))
    jcfg.only_imu_use = tcfg.only_imu_use

    data = sim.simulate(sim.SimConfig(duration=DURATION_S, scan_points=8000, seed=7))
    _, jrates, jrec = run(j_runner, jcfg, data, "legkilo_tpu.runner")
    _, trates, trec = run(t_runner, tcfg, data, "legkilo_torch.runner", device="cpu")

    ends = [x for x in (jrec["escalated_at_scan"], trec["escalated_at_scan"]) if x is not None]
    stop = min(ends) + 1 if ends else min(len(jrates), len(trates))
    diffs = [abs(a - b) for a, b in zip(jrates[:stop], trates[:stop]) if a is not None and b is not None]
    summary = {
        "duration_s": DURATION_S, "chain_impl": tcfg.tpu.chain_impl,
        "kernel_switches": 5 if args.five or args.points else 3, "jax": jrec, "torch": trec,
        "rate_diff_before_escalation": {"scans": len(diffs), "max": max(diffs), "mean": float(np.mean(diffs))},
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"summary": summary, "jax_rates": jrates, "torch_rates": trates}, fh)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
