"""Device profiling helpers.

The port's own copy of ``legkilo_tpu/utils/profiling.py``.  The reference's
observability is wall-clock running averages (timer_utils.hpp) plus
per-scan match-rate log lines (ros_interface.cc:391-394).  On the card we
add torch.profiler traces (a Chrome trace file) and a device-time report by
CUDA events.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str = "result/trace"):
    """Trace the host and the card around a block with torch.profiler and
    write ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_time(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds of the card's work for one ``fn(*args)``, by CUDA
    events around each call after ``warmup`` calls.  Needs a card: there
    is no host-clock fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs CUDA (torch.cuda.is_available() is False)")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) * 1e-3 for s, e in pairs)
    return times[len(times) // 2]


class ScanStats:
    """Per-scan counters (match ratio, drops) aggregated for reporting.

    Parity with the reference's per-scan INFO lines: raw size, downsampled
    size, "useful pcl percent" (ros_interface.cc:391-394).
    """

    def __init__(self) -> None:
        self.scans = 0
        self.total_points = 0
        self.total_matched = 0
        self.total_raw = 0
        self.dropped_points = 0
        self.dropped_events = 0

    def update(self, n_raw: int, n_points: int, n_matched: int,
               dropped_points: int = 0, dropped_events: int = 0) -> None:
        self.scans += 1
        self.total_raw += n_raw
        self.total_points += n_points
        self.total_matched += n_matched
        self.dropped_points += dropped_points
        self.dropped_events += dropped_events

    @property
    def match_ratio(self) -> float:
        return self.total_matched / max(self.total_points, 1)

    def report(self) -> Dict:
        return {
            "scans": self.scans,
            "avg_raw": self.total_raw / max(self.scans, 1),
            "avg_down": self.total_points / max(self.scans, 1),
            "match_ratio": round(self.match_ratio, 4),
            "dropped_points": self.dropped_points,
            "dropped_events": self.dropped_events,
        }

    def __str__(self) -> str:
        return json.dumps(self.report())
