"""Per-stage running-average wall timing.

The port's own copy of ``legkilo_tpu/utils/timing.py``.  Parity: Timer
(legkilo/src/common/timer_utils.hpp:15-61) — a process-wide singleton
accumulating running-average wall time per label, dumped at exit
(leg_kilo_node.cc:45).  Used as a context manager:

    with Timer.measure("Downsampling"):
        ...
    Timer.log_all_average_time()

PyTorch returns before the card finishes, so a label around card work
measures its enqueue unless the block ends in ``sync``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict

import torch

log = logging.getLogger(__name__)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def sync(tree) -> None:
    """Wait for the card's work: ``torch.cuda.synchronize`` on each CUDA
    device that holds a tensor of ``tree`` (a tensor, or tuples, lists,
    named tuples and dicts of them).  CPU tensors need no wait."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class _TimerRegistry:
    def __init__(self) -> None:
        self._avg: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt_ms = (time.perf_counter() - t0) * 1e3
            c = self._count.get(name, 0)
            avg = self._avg.get(name, 0.0)
            self._avg[name] = (avg * c + dt_ms) / (c + 1)
            self._count[name] = c + 1

    def average_ms(self, name: str) -> float:
        return self._avg.get(name, 0.0)

    def count(self, name: str) -> int:
        return self._count.get(name, 0)

    def log_all_average_time(self) -> None:
        for name, avg in sorted(self._avg.items()):
            log.info(">>> Average time of %s: %.3f ms (n=%d)", name, avg, self._count[name])

    def reset(self) -> None:
        self._avg.clear()
        self._count.clear()


Timer = _TimerRegistry()
