"""The phase spans of the port's scan step (``legkilo_torch/utils/timing.py``).

Off by default: ``span`` hands back one shared context and reads no clock.
Inside ``record_spans()`` each ``lk.*`` phase of a fleet step is one span,
nested as the step nests its phases, with the index of its scan; the stamps
are torch.profiler's clock, so a profiler's event lies inside the span that
holds it; and recording leaves a fleet step's outputs bit for bit as they
were.  On the CPU at tests/test_torch_fleet.py's small configuration (2
replicas); the case marked ``cuda`` traces one fleet step on the card.
"""

import pytest
import torch

from legkilo_torch.core import filter_deferred as t_fd
from legkilo_torch.parallel import sweep as t_sw
from legkilo_torch.utils import timing
from test_torch_fleet import assert_trees_equal, distinct_start, small_cfg
from torch_util import one_thread  # noqa: F401

B = 2

# Each phase's spans a scan, by the path's insert route: the five-kernel
# fused path (the moments kernel's gated rows) and the per-point path
# (the claiming insert_points, its moments computed in the insert).  The
# tables are copied twice a scan: the probe table before the claims, the
# other four after them.
PER_SCAN = {"lk.step": 1, "lk.pose": 1, "lk.match": 1, "lk.chain": 1, "lk.insert": 1,
            "lk.insert.rows": 1, "lk.insert.tables": 2, "lk.insert.claim": 1,
            "lk.insert.accumulate": 1, "lk.insert.refit": 1, "lk.slide": 1}
PARENT = {"lk.step": "lk.fleet", "lk.pose": "lk.step", "lk.match": "lk.step",
          "lk.chain": "lk.step", "lk.insert": "lk.step", "lk.slide": "lk.step",
          "lk.insert.rows": "lk.insert", "lk.insert.tables": "lk.insert",
          "lk.insert.claim": "lk.insert", "lk.insert.accumulate": "lk.insert",
          "lk.insert.refit": "lk.insert", "lk.fleet.stats": "lk.fleet",
          "lk.match.probe": "lk.match"}
FUSED_PER_SCAN = dict(PER_SCAN, **{"lk.match.probe": 1})


def fleet(path):
    """(scfg, carry, params, per-step [B, ...] packets) of 2 distinct sims
    with the map slide on (its threshold far away)."""
    cfg = small_cfg()
    cfg.voxel_map.map_sliding_en = True
    if path == "points":
        cfg.tpu.chain_impl = "jax"
    scfg, carry, params, seqs = distinct_start(cfg, B, duration=0.4)
    return scfg, carry, params, t_sw.stack_packets(seqs)


@pytest.fixture(scope="module", params=["fused", "points"])
def small(request):
    return (request.param,) + fleet(request.param)


def run(scfg, carry, params, steps, chunk):
    """The fleet over ``steps``, per scan or ``chunk`` scans a call."""
    outs = []
    if chunk == 1:
        step = t_sw.make_fleet_step(scfg)
        for pk in steps:
            carry, out, stats = step(carry, pk, params)
            outs.append((out, stats))
    else:
        step = t_sw.make_fleet_chunk_step(scfg)
        for pks in t_sw.stack_fleet_chunks(steps, chunk):
            carry, out, stats = step(carry, pks, params)
            outs.append((out, stats))
    return carry, outs


def test_spans_off_read_no_clock_and_record_nothing(monkeypatch):
    """Off (the default): ``span`` is one shared do-nothing context and
    ``tally`` counts nothing; no clock is read."""
    def no_clock():
        raise AssertionError("a clock was read with recording off")

    monkeypatch.setattr(timing, "_tick", no_clock)
    first = timing.span("lk.step")
    for name in ("lk.step", "lk.insert.claim", "anything"):
        with timing.span(name) as got:
            assert got is None
        assert timing.span(name) is first
    timing.tally("map.claim_rows", 5)
    with pytest.raises(AssertionError, match="clock"):  # on, a span reads it
        with timing.record_spans() as spans:
            with timing.span("lk.step"):
                pass
    assert spans.counters == {}


def test_recording_nests_counts_and_refuses_to_nest():
    with timing.record_spans() as spans:
        with timing.span("a"):
            with timing.span("lk.step"):
                with timing.span("b"):
                    timing.tally("c", 3)
                timing.tally("c", 4)
            with timing.span("d"):
                pass
        with pytest.raises(RuntimeError):
            with timing.record_spans():
                pass
    assert timing.Timer._rec is None
    assert [(s[0], s[3], s[4]) for s in spans] == [("a", -1, 0), ("lk.step", 0, 0), ("b", 1, 0),
                                                   ("d", 0, 0)]
    assert spans.counters == {"c": 7}
    for name, t0, t1, parent, _ in spans:
        assert t0 <= t1
        if parent >= 0:
            assert spans[parent][1] <= t0 and t1 <= spans[parent][2]


def test_timer_measure_records_a_span():
    timing.Timer.reset()
    with timing.record_spans() as spans:
        with timing.Timer.measure("State predict/update & Map update"):
            pass
    assert [s[0] for s in spans] == ["State predict/update & Map update"]
    assert timing.Timer.count("State predict/update & Map update") == 1
    timing.Timer.reset()


@pytest.mark.parametrize("chunk", [1, 2])
def test_fleet_step_spans_nest_once_a_scan(small, chunk):
    """Every phase once a scan (the tables twice) on both paths, each in its
    parent; a call's ``lk.fleet`` holds its scans' ``lk.step`` spans and
    ``lk.fleet.stats``; ``step_id`` is the scan's index, and a call's own
    spans take its last scan's."""
    path, scfg, carry, params, steps = small
    per_scan = FUSED_PER_SCAN if path == "fused" else PER_SCAN
    steps = steps[:2]
    with timing.record_spans() as spans:
        run(scfg, carry, params, steps, chunk)
    names = [s[0] for s in spans]
    assert set(names) == set(per_scan) | {"lk.fleet", "lk.fleet.stats"}
    assert names.count("lk.fleet") == names.count("lk.fleet.stats") == len(steps) // chunk
    for scan in range(len(steps)):
        mine = [s[0] for s in spans if s[4] == scan and s[0] not in ("lk.fleet", "lk.fleet.stats")]
        assert {n: mine.count(n) for n in per_scan} == per_scan, (path, scan)
    for name, t0, t1, parent, step in spans:
        assert t0 <= t1
        if name == "lk.fleet":
            assert parent == -1
            continue
        assert spans[parent][0] == PARENT[name], name
        assert spans[parent][1] <= t0 and t1 <= spans[parent][2]
        assert step == spans[parent][4] or spans[parent][0] == "lk.fleet"
    fleets = [s for s in spans if s[0] == "lk.fleet"]
    assert [s[4] for s in fleets] == [k * chunk + chunk - 1 for k in range(len(fleets))]
    steps_in = [[s[4] for s in spans if s[0] == "lk.step" and spans[s[3]] == f] for f in fleets]
    assert steps_in == [list(range(k * chunk, (k + 1) * chunk)) for k in range(len(fleets))]


def test_counters_count_the_table_copies_and_claim_rows(small):
    """``map.table_bytes``: the five sentinel copies of every table, bytes
    of each copy; ``map.claim_rows``: the rows a claim series takes times
    its rounds, from shapes alone."""
    path, scfg, carry, params, steps = small
    with timing.record_spans() as spans:
        run(scfg, carry, params, steps[:1], 1)
    vm, mcfg = carry.vm, scfg.map_cfg
    one_row = sum(t[0, 0].nbytes for t in vm[:5])
    slots = B * mcfg.levels * mcfg.capacity
    assert spans.counters["map.table_bytes"] == (slots + 1) * one_row
    rows = B * (mcfg.insert_row_cap if path == "fused" else mcfg.levels * scfg.insert_cap)
    assert spans.counters["map.claim_rows"] == rows * mcfg.insert_rounds


def test_match_probe_rows_count_the_fused_probes(small):
    """``match.probe_rows``: 2L candidates of every compacted match row a
    pass of the fused match (B x cap rows), from shapes alone; the
    per-point path has no such probe and no such counter."""
    path, scfg, carry, params, steps = small
    with timing.record_spans() as spans:
        run(scfg, carry, params, steps[:2], 1)
    if path == "fused":
        cap = t_fd._row_cap(scfg, *steps[0].points.shape[-3:-1])
        passes = 2 * max(1, scfg.match_iters)
        assert spans.counters["match.probe_rows"] == passes * 2 * scfg.map_cfg.levels * B * cap
    else:
        assert "match.probe_rows" not in spans.counters


def test_spans_share_the_profilers_clock():
    """A span around a ``record_function`` under a CPU profile holds that
    event's start and end: spans and the profiler's events share a clock,
    with no offset fitted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.record_spans() as spans:
            for k in range(3):
                with timing.span(f"lk.probe{k}"):
                    with record_function(f"probe{k}"):
                        torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe")}
    assert len(events) == 3
    for name, t0, t1, _, _ in spans:
        e = events[name[3:]]
        assert t0 <= e.start_ns() and e.end_ns() <= t1, (name, t0, e.start_ns(), e.end_ns(), t1)


@pytest.mark.parametrize("chunk", [1, 2])
def test_fleet_outputs_are_bit_equal_with_spans_on(small, chunk):
    path, scfg, carry, params, steps = small
    c_off, outs_off = run(scfg, carry, params, steps[:2], chunk)
    with timing.record_spans():
        c_on, outs_on = run(scfg, carry, params, steps[:2], chunk)
    assert_trees_equal(c_off, c_on)
    for (o1, s1), (o2, s2) in zip(outs_off, outs_on):
        assert_trees_equal(o1, o2)
        assert_trees_equal(s1, s2)


@pytest.mark.cuda
def test_traced_fleet_step_on_card_attributes_every_launch():
    """One traced fleet step of the small five-kernel fleet on the card:
    every device operation launched inside the step is attributed to an
    ``lk.*`` span by its launch's runtime event, and each runtime event
    lies inside its span (the profiler's clock, no offset fitted).  Spans
    on launch what spans off launch and synchronise as often: under
    ``set_sync_debug_mode("warn")`` the step warns as many times either
    way (the step's own copies of Python lists to the card synchronise;
    PERF.md §5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    import contextlib
    import warnings

    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from portbench import phases

    chip_smoke.phase_build()
    dev = torch.device("cuda")
    scfg, carry, params, steps = fleet("fused")
    move = lambda tree: t_sw.tree_map(lambda x: x.to(dev), tree)  # noqa: E731
    carry, params, steps = move(carry), move(params), [move(s) for s in steps[:3]]
    step = t_sw.make_fleet_step(scfg)
    carry, _, _ = step(carry, steps[0], params)  # warm-up
    torch.cuda.synchronize()

    def traced(on):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with (timing.record_spans() if on else contextlib.nullcontext([])) as spans:
                        step(carry, steps[1], params)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        syncs = sum(str(w.message) == "called a synchronizing CUDA operation" for w in caught)
        return phases.split_events(phases.events_of(prof)), spans, syncs

    (ops, runtime), spans, syncs_on = traced(True)
    (ops_off, _), _, syncs_off = traced(False)
    assert ops and runtime
    assert len(ops) == len(ops_off) and syncs_on == syncs_off
    assert [s[0] for s in spans].count("lk.fleet") == 1
    launch = {c: (name, t0, t1) for name, t0, t1, c in runtime}
    inner = phases.innermost(spans, [launch[c][1] if c in launch else 0 for _, _, _, c in ops])
    for (op, _, _, c), i in zip(ops, inner):
        assert c in launch, op
        assert i >= 0 and spans[i][0].startswith("lk."), op
        name, t0, t1 = launch[c]
        assert spans[i][1] <= t0 and t1 <= spans[i][2], (op, name, spans[i], t0, t1)
