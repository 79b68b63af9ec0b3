"""Per-scan counters (ScanStats).

The port's own copy of ``legkilo_tpu/utils/profiling.py``'s ScanStats: the
reference's observability is wall-clock running averages (timer_utils.hpp,
here ``utils/timing.py``, which also records the step's phase spans) plus
per-scan match-rate log lines (ros_interface.cc:391-394).  A trace of the
card is torch.profiler's own, with ``timing.record_spans`` beside it
(README, "Tracing the port").
"""

from __future__ import annotations

import json
from typing import Dict


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
