"""One run of one cell: set-up, the measured window, the readings, the
check against the plain reference, and the result line.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` prints, as the last line of its standard output, one JSON
object: ``correct``, ``attempted`` (replica-scans dispatched in the
window), ``failed`` (those with a non-finite pose), ``metrics`` (the
cell's end-to-end metrics untraced, its per-layer metrics traced),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit.  The same numbers
are the last lines of its standard error.  It exits 2, and prints no
result, without a card (or with fewer cards than the cell asks for) or
without ``legkilo_torch``; 3 when a module of JAX or of the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional

from . import check, manifest
from . import sim as simmod
from .fleet import Fleet, Window, draw_samples

FORBIDDEN = ("jax", "jaxlib", "flax", "legkilo_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (whole names: legkilo_torch is not legkilo_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run(NamedTuple):
    """A run's record, as the metric readers see it."""

    batch: int
    window: Window
    setup_s: float
    peak_bytes: Optional[int]
    mem0_bytes: int
    trace: object  # portbench.trace.Trace, or None untraced
    shapes: dict
    kernels: tuple  # compiled patterns of the port's own kernels

    @property
    def steps(self) -> int:
        return self.window.calls * self.window.scans_per_call

    def is_port_kernel(self, name: str) -> bool:
        return any(p.search(name) for p in self.kernels)


def _kernel_patterns(root: str) -> tuple:
    with open(os.path.join(root, "portbench", "kernels.json")) as f:
        names = json.load(f)["kernels"]
    return tuple(re.compile(rf"\b{re.escape(n)}\b") for n in names)


def shapes_of(settings: dict, batch: int) -> dict:
    return dict(B=batch, nb=int(settings["tpu_max_buckets"]),
                p=int(settings["tpu_max_points_per_bucket"]),
                k=int(settings["tpu_max_imu_per_bucket"]), levels=int(settings["max_layer"]) + 1,
                match_cap=int(settings["tpu_match_cap"]), use_kin=not settings["only_imu_use"])


def inputs(man: manifest.Manifest, cell_name: str, seed: int, overrides: Optional[dict] = None):
    """(cell, settings, traffic, sim data) of a cell and a seed; ``overrides``
    (tests: ``replicas``, ``sequence_s``, ``scan_points``) shrink it."""
    cell = man.cell(cell_name)
    cfg_doc = man.config(cell["config"])
    traffic = dict(man.traffic(cell["traffic"]))
    sensor = dict(cfg_doc["sensor"])
    for k, v in (overrides or {}).items():
        (sensor if k == "scan_points" else traffic)[k] = v
    data = simmod.simulate(simmod.SimConfig(
        duration=float(traffic["sequence_s"]), scan_points=int(sensor["scan_points"]),
        n_rings=int(sensor["n_rings"]), imu_rate=float(sensor["imu_rate_hz"]),
        seed=int(seed) % (1 << 63)))
    return cell, cfg_doc["settings"], traffic, data


def map_fill(settings: dict, window) -> dict:
    """The sampled replica's map after the first trial's last call: voxels
    by level against the slots a level has, and the map's overflow counts
    (insert rows past the row cap, refits past the budget, failed claims)."""
    import numpy as np

    last = max(c for tag, c, _ in window.snapshots if tag == 0)
    snap = window.snapshots[(0, last, "after")][0]
    cap = 1 << int(settings["tpu_map_capacity_log2"])
    levels = int(settings["max_layer"]) + 1
    return {"voxels_by_level": np.bincount(snap["slot"] // cap, minlength=levels).tolist(),
            "slots_a_level": cap, "ocnt": [int(v) for v in snap["ocnt"]]}


def run_cell(root: str, cell_name: str, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, overrides: Optional[dict] = None,
             fault: Optional[Callable] = None, marks: Optional[list] = None) -> dict:
    """Set up, measure and check one cell; returns the result object (with
    ``checks``).  ``overrides`` shrink it (``inputs``); ``fault`` (tests)
    is handed the fleet before the warm-up, to break it; ``marks`` are
    (name, perf_counter) pairs of set-up already done, for the split of
    ``setup_s``."""
    import torch

    marks = list(marks or []) + [("imports", time.perf_counter())]
    man = manifest.Manifest(root)
    cell, settings, traffic, data = inputs(man, cell_name, seed, overrides)
    limits = check.load_limits(root, cell_name)
    marks.append(("sim", time.perf_counter()))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    fleet = Fleet(settings, traffic, data, seed, device)
    if fault is not None:
        fault(fleet)
    samples = draw_samples(seed, fleet.calls_per_trial, int(traffic["checked_calls"]), fleet.batch)
    marks.append(("packets", time.perf_counter()))
    fleet.warm_up()
    marks.append(("warm_up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    split, prev = {}, t_start
    for name, t in marks:
        split[name] = t - prev
        prev = t

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            window = fleet.run_window(seconds, samples)
    else:
        window = fleet.run_window(seconds, samples)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    batch = fleet.batch
    del fleet
    if cuda:
        torch.cuda.empty_cache()

    tr = None
    if prof is not None:
        from . import trace

        tr = trace.read(prof, window)
        del prof
    samples = [s._replace(trial=window.trial_of[(s.tag, s.call)]) for s in samples]
    nums = check.compare(settings, traffic, data, seed, window, samples)
    correct, rows = check.verdict(nums, limits, window)
    run = Run(batch=batch, window=window, setup_s=setup_s,
              peak_bytes=peak, mem0_bytes=mem0, trace=tr, shapes=shapes_of(settings, batch),
              kernels=_kernel_patterns(root))
    metrics: Dict[str, dict] = {}
    for m in man.metrics(cell_name, traced):
        value = man.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak or 0)}
    result = {"correct": bool(correct), "attempted": int(window.replica_scans),
              "failed": int(window.non_finite), "metrics": metrics, "device": dev}
    result["window"] = {"seconds": window.seconds, "calls": window.calls,
                        "trials": window.trials, "samples": [list(s) for s in samples],
                        "setup_split_s": split, "map_end_of_trial": map_fill(settings, window)}
    if tr is not None:
        from . import trace

        dev["busy_s"] = trace.busy_s(tr)
        dev["window_s"] = trace.window_s(tr)
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(root: str, t_start: float, argv=None) -> int:
    args = parse_args(argv)
    try:
        chips = int(manifest.Manifest(root).cell(args.workload)["chips"])
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    marks = [("torch_import", time.perf_counter())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import legkilo_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: legkilo_torch is not importable: {e}", file=sys.stderr)
        return 2
    marks.append(("cuda_driver", time.perf_counter()))
    # The kernels' build cache stays inside the checkout, at a fixed path.
    build = os.path.join(root, "build", "kernels")
    os.environ["LEGKILO_TORCH_BUILD_DIR"] = build
    libs = lambda: {f for f in (os.listdir(build) if os.path.isdir(build) else ())
                    if f.endswith(".so")}
    before = libs()
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start, marks=marks)
    # A run that built the kernel library (a checkout's first) says so: its
    # set-up holds the build.
    result["window"]["kernels_built"] = bool(libs() - before)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    w = result["window"]
    print(f"portbench: {args.workload} seed {args.seed}: {w['calls']} calls in {w['trials']} "
          f"trials, {w['seconds']:.3f} s; metrics {json.dumps(result['metrics'])}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
