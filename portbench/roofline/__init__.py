"""A kernel's share of its roofline: the least time the card could take
for the kernel's work at the cell's shapes (the larger of its bytes over
the peak bandwidth and its operations over the peak fp32 rate,
``peaks.json``) over the kernel's mean time in the traced window.

One module a kernel defines ``KERNEL`` (a regular expression on the traced
kernel name) and ``count(shapes) -> (bytes, flops)`` for one launch of
the whole fleet.  Bytes count each input and output once; operations are
reckoned from the kernel's loops (chip_smoke.py's arithmetic, copied here
so that a later change to chip_smoke leaves the yardstick as it is).
"""

from __future__ import annotations

import json
import os
import re

_PEAKS = os.path.join(os.path.dirname(__file__), "peaks.json")


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def bound_s(n_bytes: float, n_flops: float) -> float:
    p = peaks()
    return max(n_bytes / p["bytes_per_s"], n_flops / p["fp32_flops_per_s"])


def share(run, kernel):
    """Percent of the roofline, or None where the kernel did not run."""
    if run.trace is None:
        return None
    pat = re.compile(kernel.KERNEL)
    durs = [e - s for name, s, e in run.trace.ops if pat.search(name)]
    if not durs:
        return None
    n_bytes, n_flops = kernel.count(run.shapes)
    return 100.0 * bound_s(n_bytes, n_flops) / (sum(durs) / len(durs) / 1e9)
