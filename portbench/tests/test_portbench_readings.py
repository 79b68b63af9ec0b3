"""The arithmetic of the readings: the rate is all work over all time, the
p95 is taken over every call, the trace's busy time is a union, and the
roofline counts are chip_smoke's at the cells' shapes."""

import numpy as np
import pytest

from portbench import trace
from portbench.fleet import Window, draw_samples
from portbench.harness import Run
from portbench.metrics import (
    chain_points_roofline_pct, device_idle_pct, glue_device_ms_per_step, host_ms_per_step,
    launches_per_step, peak_mb_per_replica, replica_scans_per_s, select_roofline_pct,
    step_ms_p95,
)
from portbench.roofline import chain_points, peaks, select


def window(call_ms, chunk=1, batch=4, seconds=None, spans=()):
    n = len(call_ms)
    return Window(seconds=seconds if seconds is not None else sum(call_ms) / 1e3, calls=n,
                  scans_per_call=chunk, replica_scans=n * chunk * batch, call_ms=list(call_ms),
                  spans=list(spans), clock0=(0.0, 0), readback={},
                  non_finite=0, snapshots={}, trials=1, trial_of={})


def run(w, tr=None, batch=4, shapes=None, peak=None):
    import re

    return Run(batch=batch, window=w, setup_s=1.0, peak_bytes=peak,
               mem0_bytes=1000, trace=tr, shapes=shapes or {},
               kernels=(re.compile(r"\bselect_kernel\b"), re.compile(r"chain_points_warp_kernel")))


def test_rate_is_all_work_over_all_time():
    # 3 calls of 4 replicas, but the window also spent 1 s re-initialising.
    w = window([100.0, 100.0, 100.0], seconds=1.3)
    assert replica_scans_per_s.read(run(w)) == pytest.approx(12 / 1.3)
    w8 = window([800.0] * 2, chunk=8, seconds=2.0)
    assert replica_scans_per_s.read(run(w8)) == pytest.approx(2 * 8 * 4 / 2.0)


def test_p95_is_over_every_call_and_only_per_step():
    ms = list(np.arange(1.0, 201.0))     # 200 calls, 1..200 ms
    assert step_ms_p95.read(run(window(ms))) == pytest.approx(np.percentile(ms, 95))
    # Not a median of chunk medians: a slow tail of 10 calls shows.
    ms = [10.0] * 190 + [100.0] * 10
    assert step_ms_p95.read(run(window(ms))) == pytest.approx(np.percentile(ms, 95))
    assert step_ms_p95.read(run(window(ms))) > 10.0
    assert step_ms_p95.read(run(window([5.0] * 20, chunk=8))) is None


def test_peak_per_replica():
    assert peak_mb_per_replica.read(run(window([1.0]), peak=1000 + 8e6)) == pytest.approx(2.0)


def synthetic_trace():
    # Window 0..100 ns; device ops: select 10-20, glue 15-30 (overlaps), glue 60-70.
    ops = [("void select_kernel(float*)", 10, 20), ("at::index_copy_kernel", 15, 30),
           ("Memcpy DtoH (Device -> Pageable)", 60, 70)]
    spans = [("pb.step", 0, 40), ("pb.readback", 40, 75), ("pb.reinit", 75, 100)]
    return trace.Trace(ops=ops, spans=spans, t0=0, t1=100)


def test_trace_busy_idle_and_breakdown():
    tr = synthetic_trace()
    assert trace.busy_intervals(tr) == [(10, 30), (60, 70)]
    assert trace.busy_s(tr) == pytest.approx(30e-9)
    idle = trace.idle_by_span(tr)
    assert idle == pytest.approx({"pb.step": 10e-9, "pb.readback": 30e-9, "pb.reinit": 30e-9})
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "at::index_copy_kernel" and len(b["idle_gaps"]) == 3
    w = window([1.0, 1.0], spans=[("pb.step", 0.0, 0.002), ("pb.step", 0.1, 0.103)])
    r = run(w, tr)
    assert device_idle_pct.read(r) == pytest.approx(70.0)
    assert launches_per_step.read(r) == pytest.approx(1.5)
    assert glue_device_ms_per_step.read(r) == pytest.approx(25e-6 / 2)
    assert host_ms_per_step.read(r) == pytest.approx(2.5)
    assert device_idle_pct.read(run(w)) is None


def test_roofline_counts_are_chip_smokes():
    """chip_smoke's figures at one replica of the main path's shapes:
    select 4,322,336 B and 13.4 M operations; the per-point chain's kin
    branch 273,440 B and 4.76 M."""
    b, f = select.count(dict(B=1, match_cap=3584, nb=28, levels=3))
    assert (b, round(f / 1e5)) == (4_322_336, 134)
    b, f = chain_points.count(dict(B=1, nb=28, k=1, p=256, use_kin=True))
    assert (b, round(f / 1e4)) == (273_440, 476)
    b256, _ = select.count(dict(B=256, match_cap=3584, nb=28, levels=3))
    assert b256 == 256 * 4_322_336
    p = peaks()
    assert (p["bytes_per_s"], p["fp32_flops_per_s"]) == (3.35e12, 67e12)


def test_roofline_share_reads_the_named_kernel_only():
    shapes = dict(B=256, match_cap=3584, nb=28, levels=3, k=1, p=256, use_kin=True)
    tr = trace.Trace(ops=[("void select_kernel(SelectArgs)", 0, 1_000_000),
                          ("void select_kernel(SelectArgs)", 2_000_000, 3_000_000)],
                     spans=[], t0=0, t1=3_000_000)
    r = run(window([1.0]), tr, shapes=shapes)
    want = 100 * 256 * 4_322_336 / 3.35e12 / 1e-3
    assert select_roofline_pct.read(r) == pytest.approx(want)
    assert chain_points_roofline_pct.read(r) is None
    assert select_roofline_pct.read(run(window([1.0]), None, shapes=shapes)) is None


@pytest.mark.parametrize("batch", [2, 128, 256])
def test_samples_cover_both_halves_the_start_and_the_end(batch):
    """The first trial's first and last call and one between, a replica
    from each half; a later trial's first call and one other."""
    for seed in (1, 2**31 + 7, 123456789012):
        s = draw_samples(seed, 99, 3, batch)
        first = [x for x in s if x.tag == 0]
        later = [x for x in s if x.tag == 1]
        assert [x.call for x in first][0] == 0 and first[-1].call == 98 and len(first) == 3
        for x in first:
            assert x.replicas[0] < batch // 2 <= x.replicas[1] < batch
        assert later[0].call == 0 and len(later) == 2 and 0 < later[1].call < 99
        assert all(len(x.replicas) == 1 and 0 <= x.replicas[0] < batch for x in later)
        assert draw_samples(seed, 99, 3, batch) == s
