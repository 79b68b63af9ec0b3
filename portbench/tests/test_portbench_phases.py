"""The phases of a traced window (portbench/phases.py) on a synthetic trace:
each device operation is its launch's, not the span it ran under; idle
gaps are named by the span at their middle; launch waits are the host's
time inside CUDA API calls, a nested call counted once; and the
per-layer readers read what they read before, runtime events or none.  A
tiny cell runs the traced window with spans on the CPU."""

import re

import pytest

from portbench import phases, trace
from portbench.fleet import Window
from portbench.harness import Run
from portbench.metrics import (
    device_idle_pct, glue_device_ms_per_step, host_ms_per_step, launches_per_step,
    select_roofline_pct,
)

from .conftest import tiny

# The port's spans of one window: (name, start, end, parent, step_id), ns.
SPANS = [("lk.fleet", 10, 590, -1, 0), ("lk.step", 20, 500, 0, 0), ("lk.match", 30, 100, 1, 0),
         ("lk.insert", 110, 400, 1, 0), ("lk.insert.tables", 120, 150, 3, 0),
         ("lk.insert.claim", 160, 300, 3, 0), ("lk.fleet.stats", 510, 580, 0, 0)]
PB = [("pb.step", 0, 600), ("pb.readback", 600, 700), ("pb.upload", 700, 1000)]
# The host's CUDA API calls: (name, start, end, correlation id).
CALLS = [("cudaLaunchKernel", 40, 45, 1), ("cudaLaunchKernel", 125, 128, 2),
         ("cudaMemcpyAsync", 130, 140, 3), ("cudaLaunchKernel", 170, 260, 4),
         ("cuLaunchKernel", 180, 200, 5), ("cudaLaunchKernel", 350, 355, 6),
         ("cudaLaunchKernel", 505, 507, 10), ("cudaLaunchKernel", 520, 525, 7),
         ("cudaMemcpyAsync", 610, 620, 8)]
# Device operations: the match kernel runs while the host is in the insert;
# the last one's launch was lost.
OPS = [("void match_kernel()", 50, 150, 1), ("void cat_kernel()", 150, 200, 2),
       ("Memcpy DtoD (Device -> Device)", 200, 230, 3), ("void claim_kernel()", 260, 300, 4),
       ("void gemv()", 300, 310, 5), ("void insert_kernel()", 400, 450, 6),
       ("void stats_kernel()", 530, 540, 7), ("void stack_kernel()", 545, 550, 10),
       ("Memcpy DtoH (Device -> Pageable)", 625, 640, 8), ("void lost_kernel()", 700, 720, 99)]
STEPS = 2


def attributed():
    return phases.attribute(OPS, CALLS, SPANS, PB, 0, 1000, STEPS, {"map.claim_rows": 10})


def test_operations_belong_to_their_launch():
    p = attributed()["phases"]
    dev = {k: v["device_ms"] * STEPS * 1e6 for k, v in p.items() if v["device_ms"]}
    assert dev == pytest.approx({"lk.match": 100, "lk.insert.tables": 80, "lk.insert.claim": 50,
                                 "lk.insert": 50, "lk.fleet.stats": 10, "lk.fleet": 5,
                                 "pb.readback": 15, "unattributed": 20})
    assert sum(v["launches"] for v in p.values()) * STEPS == len(OPS)
    assert p["lk.insert.tables"]["launches"] * STEPS == 2


def test_host_self_time_is_what_children_leave():
    p = attributed()["phases"]
    assert p["lk.fleet"]["host_self_ms"] * STEPS * 1e6 == pytest.approx(580 - 480 - 70)
    assert p["lk.insert"]["host_self_ms"] * STEPS * 1e6 == pytest.approx(290 - 30 - 140)
    assert p["lk.match"]["host_self_ms"] * STEPS * 1e6 == pytest.approx(70)


def test_idle_gaps_are_named_by_the_span_at_their_middle():
    p = attributed()["phases"]
    idle = {k: v["idle_ms"] * STEPS * 1e6 for k, v in p.items() if v["idle_ms"]}
    assert idle == pytest.approx({"lk.step": 50 + 80, "lk.insert.claim": 30, "lk.insert": 90,
                                  "lk.fleet.stats": 5, "lk.fleet": 75, "pb.readback": 60,
                                  "pb.upload": 280})


def test_launch_waits_count_nested_calls_once():
    p = attributed()["phases"]
    wait = {k: v["launch_wait_ms"] * STEPS * 1e6 for k, v in p.items() if v["launch_wait_ms"]}
    assert wait == pytest.approx({"lk.match": 5, "lk.insert.tables": 13, "lk.insert.claim": 90,
                                  "lk.insert": 5, "lk.fleet": 2, "lk.fleet.stats": 5,
                                  "pb.readback": 10})


@pytest.mark.parametrize("metric,ns", [
    ("match_device_ms_per_step", 100), ("insert_device_ms_per_step", 80 + 50 + 50),
    ("claim_device_ms_per_step", 50), ("table_copy_device_ms_per_step", 80),
    ("host_launch_wait_ms_per_step", 5 + 13 + 90 + 5 + 2 + 5),
])
def test_phase_metric(metric, ns):
    assert attributed()["metrics"][metric] == pytest.approx(ns / 1e6 / STEPS)


def test_dispatch_idle_pct_is_the_cards_idle_share_under_the_ports_spans():
    assert attributed()["metrics"]["dispatch_idle_pct"] == pytest.approx(
        100 * (50 + 30 + 90 + 80 + 5 + 75) / 1000)


def test_pb_step_shares_and_counters():
    got = attributed()
    assert got["pb_step"]["launches"] * STEPS == 8
    assert got["pb_step"]["device_ms"] * STEPS * 1e6 == pytest.approx(295)
    assert got["pb_step"]["scan_share"] == pytest.approx(290 / 295)
    assert got["pb_step"]["fleet_self_share"] == pytest.approx(5 / 295)
    assert got["counters"] == {"map.claim_rows": 10 / STEPS}
    calls = {k: (v["ms"] * STEPS * 1e6, v["count"] * STEPS) for k, v in got["pb_step"]["calls"].items()}
    assert calls == {"cudaLaunchKernel": (5 + 3 + 90 + 5 + 2 + 5, 6), "cudaMemcpyAsync": (10, 1)}


def test_innermost_takes_times_in_any_order():
    assert phases.innermost(SPANS, [505, 35, 5, 130, 165, 350, 520]) == [0, 2, -1, 4, 5, 3, 6]


class _Event:
    def __init__(self, name, s, e, corr, device, kind):
        self._v = (name, s, e, corr, device, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]


class _Prof:
    def __init__(self, events):
        kineto = type("K", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def _events(with_calls):
    kinds = {"Memcpy": "gpu_memcpy"}
    ev = [_Event(n, s, e, c, "DeviceType.CUDA", kinds.get(n.split()[0], "kernel"))
          for n, s, e, c in OPS]
    if with_calls:
        ev += [_Event(n, s, e, c, "DeviceType.CPU", "cuda_runtime") for n, s, e, c in CALLS]
    return ev


def test_split_events_keeps_what_trace_read_keeps():
    ops, calls = phases.split_events(_events(True))
    assert ops == sorted(OPS, key=lambda x: x[1]) and calls == sorted(CALLS, key=lambda x: x[1])


def test_per_layer_readers_read_as_before_with_runtime_events():
    """trace.read and every per-layer reader of the accepted benchmark give
    the same value on a trace that holds the runtime events as on one
    without them."""
    w = Window(seconds=1e-6, calls=STEPS, scans_per_call=1, replica_scans=STEPS * 4,
               call_ms=[1e-4] * STEPS, spans=[("pb.step", 0.0, 6e-7), ("pb.step", 1.0, 1.0 + 5e-7)],
               clock0=(0.0, 0), readback={}, non_finite=0, snapshots={}, trials=1, trial_of={})
    shapes = dict(B=4, match_cap=3584, nb=28, levels=3, k=1, p=256, use_kin=False)
    readings = []
    for with_calls in (False, True):
        tr = trace.read(_Prof(_events(with_calls)), w)
        run = Run(batch=4, window=w, setup_s=1.0, peak_bytes=None, mem0_bytes=0, trace=tr,
                  shapes=shapes, kernels=(re.compile(r"\bmatch_kernel\b"),))
        readings.append((tr, [m.read(run) for m in (device_idle_pct, glue_device_ms_per_step,
                                                    host_ms_per_step, launches_per_step,
                                                    select_roofline_pct)]))
    assert readings[0] == readings[1]
    assert readings[0][1][3] == pytest.approx(len(OPS) / STEPS)


def test_tiny_cell_records_the_ports_phases(root):
    """A tiny cell's traced window on the CPU, spans on: every phase of the
    fused step has host time, the counters are counted, and the cell's
    per-layer metrics are read as ``portbench/run.py --trace 1`` reads them."""
    res = phases.run_phases(root, "go1_imu.mc256", 2**31 + 3, 0.3, True, device="cpu",
                            overrides=tiny("go1_imu.mc256"))
    for name in ("lk.fleet", "lk.fleet.stats", "lk.step", "lk.pose", "lk.match", "lk.chain",
                 "lk.insert", "lk.insert.rows", "lk.insert.tables", "lk.insert.claim",
                 "lk.insert.accumulate", "lk.insert.refit"):
        assert res["phases"][name]["host_self_ms"] > 0, name
    assert res["counters"]["map.table_bytes"] > 0 and res["counters"]["map.claim_rows"] > 0
    assert res["metrics"]["host_ms_per_step"] > 0
    off = phases.run_phases(root, "go1_imu.mc256", 2**31 + 3, 0.3, False, device="cpu",
                            overrides=tiny("go1_imu.mc256"))
    assert not any(k.startswith("lk.") for k in off["phases"]) and off["counters"] == {}
