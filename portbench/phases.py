"""The port's phases in a traced window: device time, launches, launch waits
and idle gaps of each ``lk.*`` span of legkilo_torch's fleet step
(legkilo_torch/utils/timing.py; the spans and counters are listed in
PERF.md §3).

    python3 -m portbench.phases --workload go1_imu.mc256 --seed 7 --seconds 30 [--spans 0]

runs a cell's set-up and measured window as ``portbench/run.py --trace 1``
runs them (the same fleet, warm-up, window and profiler, CUDA activity
alone), with the port's spans recorded around the window (``--spans 0``
leaves them off, to measure what they cost), and prints one JSON line: the
cell's per-layer metrics read by their readers (portbench/metrics/), the
phase metrics below, ``phases``, ``counters`` and ``pb_step``.  It runs no
check.

Attribution.  Beside the card's kernels, copies and sets, the profiler
records the host's CUDA API calls (the runtime's ``cuda*``, the lower
level ``cu*``), each with the correlation id of the device operation it
launched.  An operation belongs to the innermost span open at its
launch's call, not to the span open while it ran: the card runs behind
the host.  One launched outside every recorded span belongs to the
benchmark's span then open (``pb.*``), or to "host: other"; one whose
call the profiler lost, to "unattributed".  An idle gap of the card is
named by the span open at its middle, and a launch wait (the host inside
a CUDA API call: the call itself, the time it blocks while the card's
launch queue is full, and the stream synchronisation of a copy from
pageable memory, which waits for all the work queued before it) by the
span that made the call; ``pb_step`` splits the fleet step's waits by
call.  The spans are stamped on the unix clock the profiler converts its
events to, so nothing is shifted or fitted.  ``phases`` holds, a fleet
step, each span's host self ms (what its children leave), device ms,
launches, launch-wait ms and idle ms, by the innermost span; the metrics
take a span with the spans inside it.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace

OTHER = "host: other"
LOST = "unattributed"
# metric -> the span whose operations (its own and its children's) it sums
DEVICE_MS = {"match_device_ms_per_step": "lk.match", "insert_device_ms_per_step": "lk.insert",
             "claim_device_ms_per_step": "lk.insert.claim",
             "table_copy_device_ms_per_step": "lk.insert.tables"}


def events_of(prof) -> list:
    """The raw events of a finished torch.profiler profile."""
    return list(prof.profiler.kineto_results.events())


def split_events(events) -> Tuple[list, list]:
    """(device operations, host runtime calls), each (name, start ns, end ns,
    correlation id) sorted by start; the operations are those that
    ``trace.read`` keeps."""
    ops, calls = [], []
    for e in events:
        s = trace._start_ns(e)
        row = (e.name(), s, s + trace._dur_ns(e), int(e.correlation_id()))
        if "CUDA" in str(e.device_type()):
            kind = trace._kind(e)
            if kind is None or kind in trace.DEVICE_KINDS:
                ops.append(row)
        elif row[0].startswith("cu"):  # the CUDA API's cuda* and lower-level cu* calls
            calls.append(row)
    ops.sort(key=lambda x: x[1])
    calls.sort(key=lambda x: x[1])
    return ops, calls


def innermost(spans: Sequence[tuple], times: Sequence[int]) -> List[int]:
    """For each time, the index of the innermost span (name, start, end, ...)
    open at it, or -1; ``spans`` nest and are in the order they began."""
    order = sorted(range(len(times)), key=lambda k: times[k])
    out = [-1] * len(times)
    stack: List[int] = []
    j = 0
    for k in order:
        t = times[k]
        while j < len(spans) and spans[j][1] <= t:
            while stack and spans[stack[-1]][2] < spans[j][1]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[k] = stack[-1] if stack else -1
    return out


class _Flat:
    """Spans that do not nest (the benchmark's ``pb.*``): the one open at t."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda x: x[1])
        self.starts = [s[1] for s in self.spans]

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.spans[i][0] if i >= 0 and t < self.spans[i][2] else None


def attribute(ops, calls, spans, pb_spans, t0: int, t1: int, steps: int,
              counters: Optional[dict] = None) -> dict:
    """``phases``, ``counters``, ``pb_step`` and the phase metrics of a
    window of ``steps`` fleet steps.  ``ops`` and ``calls`` are as
    ``split_events`` gives them, ``spans`` the port's (``record_spans``),
    ``pb_spans`` the benchmark's (name, start ns, end ns), t0-t1 the window
    as ``trace.read`` bounds it.  ``pb_step`` holds what the fleet step
    (``pb.step``) launched: its device ms and launches, the shares of that
    device time under ``lk.step`` or ``lk.fleet.stats`` and under
    ``lk.fleet`` alone, and its runtime calls' ms and count by name."""
    pb = _Flat(pb_spans)
    step_spans = _Flat([s for s in pb_spans if s[0] == "pb.step"])
    names: Dict[int, frozenset] = {}

    def inside(i: int) -> frozenset:  # the names of span i and its ancestors
        if i not in names:
            names[i] = frozenset() if i < 0 else inside(spans[i][3]) | {spans[i][0]}
        return names[i]

    def name_at(i: int, t: int) -> str:
        return spans[i][0] if i >= 0 else (pb.at(t) or OTHER)

    rows: Dict[str, Dict[str, float]] = {}

    def row(name):
        return rows.setdefault(name, dict(host_self_ms=0.0, device_ms=0.0, launches=0,
                                          launch_wait_ms=0.0, idle_ms=0.0))

    for i, (name, a, b, parent, _) in enumerate(spans):
        row(name)["host_self_ms"] += (b - a) / 1e6
        if parent >= 0:
            row(spans[parent][0])["host_self_ms"] -= (b - a) / 1e6

    launch = {c: s for _, s, _, c in calls}
    at = innermost(spans, [launch.get(c, t0) for _, _, _, c in ops])
    metric_ns = dict.fromkeys(DEVICE_MS, 0)
    in_step = dict(device_ns=0, launches=0, scan_ns=0, fleet_self_ns=0)
    for (_, s, e, c), i in zip(ops, at):
        t = launch.get(c)
        name = LOST if t is None else name_at(i, t)
        r = row(name)
        r["device_ms"] += (e - s) / 1e6
        r["launches"] += 1
        if t is None:
            continue
        held = inside(i)
        for metric, span_name in DEVICE_MS.items():
            if span_name in held:
                metric_ns[metric] += e - s
        if step_spans.at(t):
            in_step["device_ns"] += e - s
            in_step["launches"] += 1
            if "lk.step" in held or "lk.fleet.stats" in held:
                in_step["scan_ns"] += e - s
            elif name == "lk.fleet":
                in_step["fleet_self_ns"] += e - s

    wait_step, end = 0, -1
    by_call: Dict[str, list] = {}
    calls_at = innermost(spans, [s for _, s, _, _ in calls])
    for (call, s, e, _), i in zip(calls, calls_at):
        if e <= end:  # a cu* call inside a cuda* call counts once
            continue
        s, end = max(s, end), e
        row(name_at(i, s))["launch_wait_ms"] += (e - s) / 1e6
        if step_spans.at(s):
            wait_step += e - s
            c = by_call.setdefault(call, [0, 0])
            c[0] += e - s
            c[1] += 1

    busy = trace.busy_intervals(trace.Trace(ops=[o[:3] for o in ops], spans=[], t0=t0, t1=t1))
    gaps, prev = [], t0
    for s, e in busy + [(t1, t1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle_lk = 0
    for (s, e), i in zip(gaps, innermost(spans, [(s + e) // 2 for s, e in gaps])):
        row(name_at(i, (s + e) // 2))["idle_ms"] += (e - s) / 1e6
        idle_lk += (e - s) if i >= 0 else 0

    n = max(int(steps), 1)
    phases = {k: {f: v / n for f, v in r.items()} for k, r in sorted(rows.items())}
    metrics = {m: v / 1e6 / n for m, v in metric_ns.items()}
    metrics["dispatch_idle_pct"] = 100.0 * idle_lk / max(t1 - t0, 1)
    metrics["host_launch_wait_ms_per_step"] = wait_step / 1e6 / n
    total = max(in_step["device_ns"], 1)
    pb_step = {"device_ms": in_step["device_ns"] / 1e6 / n, "launches": in_step["launches"] / n,
               "scan_share": in_step["scan_ns"] / total,
               "fleet_self_share": in_step["fleet_self_ns"] / total,
               "calls": {k: {"ms": v[0] / 1e6 / n, "count": v[1] / n}
                         for k, v in sorted(by_call.items(), key=lambda x: -x[1][0])}}
    return {"metrics": metrics, "phases": phases, "pb_step": pb_step,
            "counters": {k: v / n for k, v in sorted((counters or {}).items())}}


def read(prof, window, spans) -> Tuple[trace.Trace, dict]:
    """The window's ``trace.read`` (for the per-layer readers) and its
    attribution (``attribute``)."""
    tr = trace.read(prof, window)
    ops, calls = split_events(events_of(prof))
    steps = window.calls * window.scans_per_call
    return tr, attribute(ops, calls, list(spans), tr.spans, tr.t0, tr.t1, steps,
                         getattr(spans, "counters", {}))


def run_phases(root: str, cell_name: str, seed: int, seconds: float, spans_on: bool,
               device: str = "cuda", overrides: Optional[dict] = None) -> dict:
    """Set up a cell and run its traced window (module doc); the result
    object.  ``overrides`` shrink the cell (``harness.inputs``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from legkilo_torch.utils.timing import record_spans

    from . import harness, manifest
    from .fleet import Fleet, draw_samples

    man = manifest.Manifest(root)
    _, settings, traffic, data = harness.inputs(man, cell_name, seed, overrides)
    fleet = Fleet(settings, traffic, data, seed, device)
    samples = draw_samples(seed, fleet.calls_per_trial, int(traffic["checked_calls"]),
                           fleet.batch)
    fleet.warm_up()
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        with (record_spans() if spans_on else contextlib.nullcontext([])) as spans:
            window = fleet.run_window(seconds, samples)
    tr, got = read(prof, window, spans)
    del prof
    run = harness.Run(batch=fleet.batch, window=window, setup_s=0.0, peak_bytes=None,
                      mem0_bytes=0, trace=tr, shapes=harness.shapes_of(settings, fleet.batch),
                      kernels=harness._kernel_patterns(root))
    metrics = {m["name"]: man.reader(m["name"]).read(run) for m in man.metrics(cell_name, True)}
    metrics.update(got.pop("metrics"))
    return {"workload": cell_name, "seed": seed, "spans": bool(spans_on), "calls": window.calls,
            "steps": run.steps, "seconds": window.seconds,
            "device": torch.cuda.get_device_name(0) if cuda else "cpu", "metrics": metrics, **got}


def main(root: str, argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.phases: needs a CUDA card", file=sys.stderr)
        return 2
    # The kernels' build cache, as portbench/run.py keeps it.
    os.environ["LEGKILO_TORCH_BUILD_DIR"] = os.path.join(root, "build", "kernels")
    out = run_phases(root, args.workload, args.seed, args.seconds, bool(args.spans))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
