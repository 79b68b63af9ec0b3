"""Scatter-adds summed in row order, the same on every device.

``index_add_`` on a CPU tensor adds source row 0, then row 1, ... into
their targets, as the JAX package's scatter-add does on the CPU.  On a
CUDA tensor it adds with atomics, so the order in which the rows of one
target meet changes from run to run, and with it the rounding: two runs
of one commit give different maps.  ``index_add_rows`` sums in row order
on every device, by one form that the CPU tests run and the card runs:

1. One stable sort of the targets, shared by every table summed with them:
   the rows of one target become a segment, in ascending row order.
2. Each segment's first row is added to its target's current value (one
   rounding, as the first ``index_add_`` step).
3. ``torch.segment_reduce`` sums each segment from 0: a thread a segment
   and column adds the segment's rows one after the other, so the running
   sum rounds after every add (a sum that starts at 0 changes no value).
4. The segment sums replace their targets (``index_copy_``; the padding
   segments all write to ``drop``, a row the caller discards).

The rows aimed at ``drop`` (the table's last row: masked and padding
rows) are not summed at all: their segment is given no rows, since one
thread summing thousands of them would be the launch's long pole.  So the
``drop`` row ends up holding no sum; both callers discard it.

The sums run in f32 for an f16 or bf16 table and round to the table's
dtype once, at the copy: that is what ``index_add_`` of a CPU tensor does
with a narrow table (it accumulates in f32 and stores once), so the result
is bit-equal to it for f32, f16 and bf16 tables on every row but ``drop``
(tests/test_torch_ordered_sum.py holds the two on the CPU, and
tests/test_torch_cuda.py the card's result against the CPU's).  The cost
is one sort, a gather of the rows and of their targets, one
``segment_reduce`` and one ``index_copy_`` a table.
"""

from __future__ import annotations

from typing import Sequence

import torch


def index_add_rows(dests: Sequence[torch.Tensor], tgt: torch.Tensor,
                   rows: Sequence[torch.Tensor], drop: int) -> None:
    """``dests[i][tgt[r]] += rows[i][r]`` for r = 0, 1, ... in that order,
    in place, on any device (module doc).  ``tgt`` [R] int64 names rows of
    every table; ``drop`` is the last row of every table, whose contents
    the caller discards."""
    n = tgt.shape[0]
    dev = tgt.device
    srt, perm = torch.sort(tgt, stable=True)
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = srt[1:] != srt[:-1]
    # offsets[s] = position of segment s's first row; segments past the
    # last target are empty (offset n).  Rows that start no segment write
    # to position n + 1, which is cut off.
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    offsets = torch.full((n + 2,), n, dtype=torch.int64, device=dev)
    offsets.scatter_(0, torch.where(first, pos, n + 1), torch.arange(n, dtype=torch.int64, device=dev))
    # The rows aimed at drop sort last; ending every segment from theirs on
    # at their first row leaves them out of the sums.
    offsets = torch.minimum(offsets[: n + 1], (srt != drop).sum())
    used = offsets[:n] < n
    seg_tgt = torch.where(used, srt[torch.clamp(offsets[:n], max=n - 1)], drop)
    for d, x in zip(dests, rows):
        acc = torch.promote_types(d.dtype, torch.float32)
        xs = x.to(d.dtype).to(acc).reshape(n, -1)[perm]
        xs = torch.where(first[:, None], d.reshape(d.shape[0], -1)[srt].to(acc) + xs, xs)
        sums = torch.segment_reduce(xs, "sum", offsets=offsets, axis=0, unsafe=True)
        d.index_copy_(0, seg_tgt, sums.to(d.dtype).reshape((n,) + tuple(d.shape[1:])))
