"""What a ``--trace 1`` run reads from torch.profiler: the card's operations
(kernels, copies, sets), and the benchmark's own host spans beside them.

The profiler records the card's activity only: recording every host
operation as well would slow the host's enqueue by about half and make the
card look idle for the profiler's sake.  The traced window runs from the
first device operation's start to the last one's end.  The host spans are
the window's own (perf_counter), placed on the trace's wall-clock timeline
by one reading of both clocks; they serve ``breakdown``'s idle gaps alone,
which they name by the span open at each gap's middle.  The check's
snapshots (``pb.snapshot``: a few hundred small operations a trial) stay
in the trace.  The profiler's raw events are read
(``kineto_results.events()``): building its Python event objects takes
minutes for the ~10^5 launches of a window.  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace(NamedTuple):
    ops: List[Tuple[str, int, int]]    # device operations: (name, start ns, end ns)
    spans: List[Tuple[str, int, int]]  # the benchmark's host spans (pb.*)
    t0: int                            # the traced window, ns
    t1: int


def _start_ns(e) -> int:
    return int(e.start_ns()) if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _dur_ns(e) -> int:
    return int(e.duration_ns()) if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


def _kind(e) -> Optional[str]:
    try:
        return str(e.activity_type())
    except (AttributeError, RuntimeError):
        return None


def read(prof, window) -> Trace:
    """The device operations of a finished profile and the window's spans."""
    ops = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        kind = _kind(e)
        if kind is not None and kind not in DEVICE_KINDS:
            continue
        s = _start_ns(e)
        ops.append((e.name(), s, s + _dur_ns(e)))
    perf0, wall0 = window.clock0
    spans = sorted(((n, wall0 + int((a - perf0) * 1e9), wall0 + int((b - perf0) * 1e9))
                    for n, a, b in window.spans), key=lambda x: x[1])
    ops.sort(key=lambda x: x[1])
    t0 = min((o[1] for o in ops), default=0)
    t1 = max((o[2] for o in ops), default=0)
    return Trace(ops=ops, spans=spans, t0=t0, t1=t1)


def busy_intervals(tr: Trace) -> List[Tuple[int, int]]:
    """The union of the device operations' intervals, clipped to the window."""
    out: List[List[int]] = []
    for _, s, e in tr.ops:
        s, e = max(s, tr.t0), min(e, tr.t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr)) / 1e9


def window_s(tr: Trace) -> float:
    return (tr.t1 - tr.t0) / 1e9


def idle_by_span(tr: Trace) -> Dict[str, float]:
    """Seconds the card sat idle, by the host span under each gap's middle
    ("host: other" where no span was open)."""
    starts = [s for _, s, _ in tr.spans]
    out: Dict[str, float] = {}
    prev = tr.t0
    for s, e in busy_intervals(tr) + [(tr.t1, tr.t1)]:
        if s > prev:
            mid = (prev + s) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = tr.spans[i][0] if i >= 0 and mid < tr.spans[i][2] else "host: other"
            out[name] = out.get(name, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    return out


def device_time_by_name(tr: Trace) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s, e in tr.ops:
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, [[name, seconds], ...] each."""
    dev = sorted(device_time_by_name(tr).items(), key=lambda x: -x[1])[:top]
    idle = sorted(idle_by_span(tr).items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in dev],
            "idle_gaps": [[n, s] for n, s in idle]}
