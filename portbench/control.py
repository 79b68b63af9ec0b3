"""Readings for the limits of ``correct``: the fleet against the reference
on many seeds (the lower readings), and the control against the reference
(the upper readings), in one process.

The control is the reference put in the fleet's place and computed one
precision below the configuration's: the configuration states float32 with
TF32 off, so the control runs the reference in float32 with every matrix
product on TF32 inputs (reference/arith.py).  For each sampled call it
starts where the check starts, from the fleet's state and map before the
call, and its state, map, poses and match counts stand where the fleet's
would; its start is its own first frame.

    python portbench/control.py --workload go1_imu.mc256 --seeds 1,2,3 --seconds 3

prints one JSON line a seed: ``{"seed", "sound": {...}, "control": {...}}``.
Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def readings(root: str, cell_name: str, seed: int, seconds: float, device: str,
             overrides=None, dump: str = "") -> dict:
    """One seed's numbers for the fleet (sound) and for the control, and the
    fleet's by sampled replica (``detail``); with ``dump`` a directory, the
    carries before and after the sampled call of the largest position gap
    go there as ``<cell>.<seed>.npz``."""
    import torch

    from . import check, harness, manifest
    from .fleet import Fleet, draw_samples

    _, settings, traffic, data = harness.inputs(manifest.Manifest(root), cell_name, seed,
                                                overrides)
    fleet = Fleet(settings, traffic, data, seed, device)
    samples = draw_samples(seed, fleet.calls_per_trial, int(traffic["checked_calls"]), fleet.batch)
    fleet.warm_up()
    window = fleet.run_window(seconds, samples)
    del fleet
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    samples = [s._replace(trial=window.trial_of[(s.tag, s.call)]) for s in samples]
    ref = check.Reference(settings, traffic, data)
    ctl = check.Reference(settings, traffic, data, control=True)
    wants = check.follow(ref, seed, window, samples)
    seen = [(s, i, check.seen_program(ref, window, s, i), w) for s, i, w in wants]
    sound = check.numbers((g, w) for _, _, g, w in seen)
    control = check.numbers(
        (ctl.run(seed, s, i, window.snapshots[(s.tag, s.call, "before")][i]), w)
        for s, i, w in wants)
    detail = [[s.tag, s.call, s.replicas[i], s.trial, check.numbers([(g, w)])]
              for s, i, g, w in seen]
    if dump:
        worst = max(range(len(seen)), key=lambda j: detail[j][4]["pos_gap_m"])
        s, i = seen[worst][0], seen[worst][1]
        import numpy as np

        np.savez_compressed(os.path.join(dump, f"{cell_name}.{seed}.npz"), **{
            f"{when}.{k}": v for when in ("before", "after")
            for k, v in window.snapshots[(s.tag, s.call, when)][i].items()},
            sample=np.asarray([s.tag, s.call, s.replicas[i], s.trial]))
    return {"seed": seed, "sound": sound, "control": control, "detail": detail,
            "calls": window.calls, "non_finite": window.non_finite}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--dump", default="", help="a directory for the worst sample's carries")
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["LEGKILO_TORCH_BUILD_DIR"] = os.path.join(root, "build", "kernels")
    import torch

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = readings(root, args.workload, seed, args.seconds, "cuda", dump=args.dump)
        rec["s"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from portbench import control as _c

    sys.exit(_c.main())
