"""Per-stage running-average wall timing, and the phase spans of a step.

The port's own copy of ``legkilo_tpu/utils/timing.py``.  Parity: Timer
(legkilo/src/common/timer_utils.hpp:15-61) — a process-wide singleton
accumulating running-average wall time per label, dumped at exit
(leg_kilo_node.cc:45).  Used as a context manager:

    with Timer.measure("Downsampling"):
        ...
    Timer.log_all_average_time()

PyTorch returns before the card finishes, so a label around card work
measures its enqueue unless the block ends in ``sync``.

Spans.  ``span(name)`` marks a phase of the scan step (the ``lk.*`` names,
listed in PERF.md §3).  Recording is off by default, and ``span`` then
returns one shared context that does nothing: no clock read, no
allocation, no device work.  ``record_spans()`` turns it on for a block
and yields the list it records into, to be read after the block:

    with record_spans() as spans:
        carry, out, stats = step(carry, packet, params)
    for name, start_ns, end_ns, parent, step_id in spans:
        ...
    spans.counters  # {"map.table_bytes": ..., "map.claim_rows": ...}

Each span is (name, start_ns, end_ns, parent, step_id) in the order the
spans began; ``parent`` is the index of the span it lies in (-1 for none)
and ``step_id`` the index of the last ``lk.step`` begun by the span's end
(-1 before the first): a scan's spans share it with the fleet call whose
last scan it is.  The stamps are the unix clock in ns (``time.time_ns``),
the clock torch.profiler converts its host and device events to, so the
spans lie on the timeline of a profile's events with no offset to fit
(the profiler's own approximate clock is not exposed by every torch: 2.11
has neither it nor its converter in Python).  ``Timer.measure`` records a
span too.  ``tally(name, n)`` adds ``n`` to a host counter of the
recording (Python ints from shapes) and does nothing while recording is
off.  Nothing is written while recording.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List

import torch

log = logging.getLogger(__name__)
_tick = time.time_ns


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


class _Off:
    """The span while recording is off: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Spans(list):
    """The spans of one recording (module doc) and its host counters."""

    def __init__(self) -> None:
        super().__init__()
        self.counters: Dict[str, int] = {}


class _Recording:
    """Spans as [name, start ns, end ns, parent, step_id] lists while they
    are open, tuples once ``finish`` has run."""

    def __init__(self) -> None:
        self.spans = Spans()
        self.stack: List[int] = []
        self.steps = 0

    def open(self, name: str) -> int:
        if name == "lk.step":
            self.steps += 1
        i = len(self.spans)
        self.spans.append([name, 0, 0, self.stack[-1] if self.stack else -1, 0])
        self.stack.append(i)
        self.spans[i][1] = _tick()
        return i

    def close(self, i: int) -> None:
        t = _tick()
        rec = self.spans[i]
        rec[2], rec[4] = t, self.steps - 1
        self.stack.pop()

    def finish(self) -> None:
        for i, rec in enumerate(self.spans):
            self.spans[i] = tuple(rec)


class _Span:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: _Recording, name: str) -> None:
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = self.rec.open(self.name)

    def __exit__(self, *exc):
        self.rec.close(self.i)
        return False


class _TimerRegistry:
    def __init__(self) -> None:
        self._avg: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._rec = None  # the _Recording while record_spans is on

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            with self.span(name):
                yield
        finally:
            dt_ms = (time.perf_counter() - t0) * 1e3
            c = self._count.get(name, 0)
            avg = self._avg.get(name, 0.0)
            self._avg[name] = (avg * c + dt_ms) / (c + 1)
            self._count[name] = c + 1

    def span(self, name: str):
        """A context that records the span ``name`` while recording is on
        (module doc), and does nothing otherwise."""
        rec = self._rec
        return _OFF if rec is None else _Span(rec, name)

    def tally(self, name: str, n: int) -> None:
        """Add ``n`` to the host counter ``name`` while recording is on."""
        rec = self._rec
        if rec is not None:
            c = rec.spans.counters
            c[name] = c.get(name, 0) + int(n)

    @contextlib.contextmanager
    def record_spans(self):
        """Record spans and counters for the block; yields their list, read
        it after the block.  Recordings do not nest."""
        if self._rec is not None:
            raise RuntimeError("record_spans is already on")
        rec = self._rec = _Recording()
        try:
            yield rec.spans
        finally:
            self._rec = None
            rec.finish()

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
span = Timer.span
record_spans = Timer.record_spans
tally = Timer.tally
