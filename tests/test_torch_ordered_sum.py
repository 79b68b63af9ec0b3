"""The row-order scatter-add (core/ordered_sum.py) against ``index_add_`` on the CPU.

``index_add_rows`` runs one form on every device (a stable sort of the
targets, a running sum a segment): here it runs on CPU tensors and must
give what ``index_add_`` gives, bit for bit on every row but the dropped
one, for the tables' widths and dtypes (meta 4, mom 9, moms 60 in f32/f16/bf16, s40 40x40), with
targets repeated hundreds of times, targets never hit, the dropped row in
use, and destinations that already hold sums.  On the card the same
helper is held against this CPU result (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from legkilo_torch.core import ordered_sum
from torch_util import one_thread  # noqa: F401

DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}


def tables(rng, m, r, width, dtype):
    """A destination of m rows already holding sums, r source rows and
    their targets (row m - 1 is the dropped row; a tenth of the rows hit it)."""
    dest = torch.from_numpy(rng.normal(scale=3.0, size=(m,) + width).astype(np.float32)).to(dtype)
    src = torch.from_numpy(rng.normal(size=(r,) + width).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, m // 2, size=r)).to(torch.int64)
    tgt[::10] = m - 1
    return dest, src, tgt


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width,m,r", [((4,), 40, 3000), ((9,), 400, 500), ((60,), 40, 3000),
                                       ((40, 40), 9, 600)])
def test_segment_add_is_index_add(rng, dtype, width, m, r):
    dest, src, tgt = tables(rng, m, r, width, DTYPES[dtype])
    ref = dest.clone().index_add_(0, tgt, src.to(dest.dtype))
    got = dest.clone()
    ordered_sum.index_add_rows([got], tgt, [src], drop=m - 1)
    assert torch.equal(got[: m - 1], ref[: m - 1])


def test_shared_sort_for_several_tables(rng):
    """One call sums three tables of different widths and dtypes over the
    same targets, as the insert does (meta, mom, moms)."""
    meta, s4, tgt = tables(rng, 64, 2000, (4,), torch.float32)
    mom, s9, _ = tables(rng, 64, 2000, (9,), torch.float32)
    moms, s60, _ = tables(rng, 64, 2000, (60,), torch.float16)
    refs = [t.clone().index_add_(0, tgt, s.to(t.dtype)) for t, s in ((meta, s4), (mom, s9), (moms, s60))]
    got = [meta.clone(), mom.clone(), moms.clone()]
    ordered_sum.index_add_rows(got, tgt, [s4, s9, s60], drop=63)
    for a, b in zip(got, refs):
        assert torch.equal(a[:63], b[:63])


def test_index_add_rows_on_cpu_is_index_add(rng):
    """The edges: one row a target, every row aimed at the dropped row (the
    table stays as it was), and a single row."""
    dest, src, _ = tables(rng, 30, 29, (9,), torch.float32)
    for tgt in (torch.from_numpy(rng.permutation(29)), torch.full((29,), 29), torch.arange(1)):
        got = dest.clone()
        ordered_sum.index_add_rows([got], tgt, [src[: tgt.shape[0]]], drop=29)
        assert torch.equal(got[:29], dest.clone().index_add_(0, tgt, src[: tgt.shape[0]])[:29])
