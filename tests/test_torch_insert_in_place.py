"""The map insert writes the carry's tables in place (core/voxel_map.py's
module doc), on the CPU.

An insert whose tables an earlier insert made writes them in place, their
spare sentinel row zeroed on entry; any other map is copied once.  So a
chain of steps that hands each step the carry the last one returned (in
place from the second step on) equals the same chain with the carry
cloned before every step (a copy every step), bit for bit: every table,
the state, the covariance, ``ocnt`` and the outputs.  That holds on the
fused route (the five kernel switches, their plain versions here), the
fused kinematic fleet at configs/leg_fusion.yaml's 2 ms shape (NB 64, K 4),
the per-point path, the sequential pipeline, the chunked fleet step, and a
map so small that claims fail and the refit budget overflows, so that the
sentinel rows take writes in one step and must read zero in the next.

From the second step on the carry's tables keep their addresses,
``map.tables_in_place`` counts the inserts that wrote in place and
``map.table_bytes`` only the first step's copies; a map that no insert
made (``make_map``, ``fleet_init``, a ``.clone()``, a replica view of a
fleet of two) is left as it was.  The case marked ``cuda`` holds the
five-kernel fleet's two chains equal on the card, with the claim series
and the fit kernel launched; the file imports no JAX, so on the card

    python3 -m pytest --noconftest tests/test_torch_insert_in_place.py -q -m cuda
"""

import os

import pytest
import torch

from legkilo_torch import config as t_config
from legkilo_torch.core import voxel_map as t_vm
from legkilo_torch.core.filter import process_scan_any
from legkilo_torch.core.filter_fleet import replica, tree_map
from legkilo_torch.parallel import sweep as t_sw
from legkilo_torch.utils import timing
from test_torch_fleet import FIVE, assert_trees_equal, distinct_start, small_cfg
from torch_util import cloned, one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS = 2, 4


def _overflowing(cfg):
    """A map small enough that claims fail every scan (2^10 slots a level,
    probe 2, one round) and that more planes ask for a refit than the
    budget of one."""
    cfg.voxel_map.capacity_log2 = 10
    cfg.voxel_map.probe_length = 2
    cfg.voxel_map.insert_rounds = 1
    cfg.voxel_map.refit_budget = 1
    return cfg


def _kin_yaml():
    """configs/leg_fusion.yaml on the fused path at its 2 ms shape (NB 64,
    P 128, K 4, kinematics on), the five switches on, 2^10 slots a level."""
    cfg = t_config.load(os.path.join(ROOT, "configs", "leg_fusion.yaml"))
    cfg.lidar.filter_num, cfg.lidar.blind = 1, 0.3
    cfg.voxel_map.capacity_log2 = 10
    cfg.voxel_map.insert_row_cap = 512
    cfg.tpu.insert_cap = cfg.tpu.match_cap = 512
    for k in FIVE:
        setattr(cfg.tpu, k, True)
    return cfg


def _points():
    cfg = small_cfg()
    cfg.tpu.chain_impl = "jax"
    return cfg


ROUTES = {
    "fused": small_cfg,
    "fused_kin": _kin_yaml,
    "points": _points,
    "sequential": lambda: small_cfg(five=False, pipeline="sequential"),
    "fused_overflow": lambda: _overflowing(small_cfg()),
    "points_overflow": lambda: _overflowing(_points()),
}


@pytest.fixture(scope="module", params=list(ROUTES))
def fleet(request):
    """(route, scfg, carry, params, STEPS per-step [B, ...] packets) of B
    distinct sims; the carry is ``fleet_init``'s."""
    scfg, carry, params, seqs = distinct_start(ROUTES[request.param](), B, duration=0.6)
    steps = t_sw.stack_packets(seqs)[:STEPS]
    assert len(steps) == STEPS
    return request.param, scfg, carry, params, steps


def chain(step, carry, packets, params, keep):
    """``step`` over ``packets`` from a clone of ``carry``: each step on
    the carry the last returned, or (``keep``) on a clone of it, so that
    every step copies.  Returns each step's (carry, outputs), cloned."""
    carry, got = cloned(carry), []
    for pk in packets:
        if keep:
            carry = cloned(carry)
        carry, out, _ = step(carry, pk, params)
        got.append((cloned(carry), cloned(out)))
    return got


def spare_rows(vm):
    """The spare sentinel row past each of a map's five tables."""
    return [t_vm._spare_row_buffer(t.reshape(-1, t.shape[-1]))[-1] for t in vm[:5]]


@pytest.mark.parametrize("chunk", [1, 2])
def test_in_place_chain_equals_the_copying_chain(fleet, chunk):
    route, scfg, carry, params, steps = fleet
    if chunk == 1:
        step = t_sw.make_fleet_step(scfg)
    else:
        step = t_sw.make_fleet_chunk_step(scfg)
        steps = t_sw.stack_fleet_chunks(steps, chunk)
    in_place = chain(step, carry, steps, params, keep=False)
    copying = chain(step, carry, steps, params, keep=True)
    for (c1, o1), (c2, o2) in zip(in_place, copying):
        assert_trees_equal(c1, c2)
        assert_trees_equal(o1, o2)
    last = in_place[-1][0]
    assert bool(torch.isfinite(last.state.lin).all())
    if route.endswith("_overflow"):  # each replica's claims failed and refits waited
        over = sum(o.map_overflow.reshape(B, -1, 3).sum(1) for _, o in in_place)
        assert bool((over[:, t_vm.OCNT_CLAIM] > 0).all()), over
        assert bool((over[:, t_vm.OCNT_REFIT] > 0).all()), over


def test_sentinel_rows_read_zero_on_entry_as_on_a_fresh_copy(fleet, monkeypatch):
    """A step leaves writes in the spare rows (the refit's unused budget
    entries aim there); the next insert zeroes them on entry, so the claims,
    the scatter-adds and the refit find the sentinel rows zero, as on a
    fresh copy."""
    _, scfg, carry, params, steps = fleet
    step = t_sw.make_fleet_step(scfg)
    carry, _, _ = step(cloned(carry), steps[0], params)
    assert any(bool(row.any()) for row in spare_rows(carry.vm))
    real, seen = t_vm._sentinel_tables, []

    def recorded(*tables):
        out = real(*tables)
        seen.extend((x.data_ptr() == t.data_ptr(), x[-1].clone()) for x, t in zip(out, tables))
        return out

    monkeypatch.setattr(t_vm, "_sentinel_tables", recorded)
    step(carry, steps[1], params)
    assert len(seen) >= 5 and all(in_place for in_place, _ in seen)
    assert not any(bool(row.any()) for _, row in seen)


def test_tables_stay_in_place_after_the_first_step(fleet):
    """The carry's tables keep their addresses from the second step on;
    ``map.tables_in_place`` counts every insert but the first (one a step,
    a bucket's on the sequential pipeline) and ``map.table_bytes`` is the
    first step's copies alone."""
    route, scfg, carry, params, steps = fleet
    step = t_sw.make_fleet_step(scfg)
    carry = cloned(carry)
    ptrs, counters = [], []
    for pk in steps:
        with timing.record_spans() as spans:
            carry, _, _ = step(carry, pk, params)
        ptrs.append([t.data_ptr() for t in carry.vm[:5]])
        counters.append(dict(spans.counters))
    assert all(p == ptrs[0] for p in ptrs[1:])
    inserts = steps[0].points.shape[1] if route == "sequential" else 1
    assert [c.get("map.tables_in_place", 0) for c in counters] == (
        [inserts - 1] + [inserts] * (STEPS - 1))
    copied = sum(t[0, 0].nbytes for t in carry.vm[:5]) * (carry.vm.ptab[..., 0].numel() + 1)
    assert [c["map.table_bytes"] for c in counters] == [copied] + [0] * (STEPS - 1)


def test_a_map_no_insert_made_is_left_untouched(fleet):
    """``make_map``'s map, ``fleet_init``'s carry, a ``.clone()`` of a
    stepped carry and a replica view of a fleet of two are copied, not
    written: each reads after the insert or step what it read before."""
    _, scfg, carry, params, steps = fleet
    mcfg = scfg.map_cfg
    step = t_sw.make_fleet_step(scfg)

    p_w = steps[0].points[0].reshape(-1, 3)
    var = torch.eye(3).expand(p_w.shape[0], 3, 3) * 1e-4
    mask = steps[0].point_mask[0].reshape(-1)
    empty = t_vm.make_map(mcfg, "cpu")
    vm = t_vm.insert_points(empty, mcfg, p_w, var, mask)
    assert all(not bool(t.any()) for t in empty)
    assert bool(vm.ptab.any())

    kept = cloned(carry)
    stepped, _, _ = step(carry, steps[0], params)
    assert_trees_equal(carry, kept)

    copy = cloned(stepped)
    kept = cloned(copy)
    step(copy, steps[1], params)
    assert_trees_equal(copy, kept)

    kept = cloned(stepped)
    for r in range(B):
        t_vm.insert_points(replica(stepped.vm, r), mcfg, p_w, var, mask)
    assert_trees_equal(stepped, kept)


@pytest.mark.cuda
def test_in_place_chain_equals_the_copying_chain_on_card():
    """The five-kernel fleet (B = 2) on the card: the in-place chain equals
    the copying chain step after step, with the claim series and the fit
    kernel launched on the sentinel-extended tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from legkilo_torch.ops.claim_slots import claim_call
    from legkilo_torch.ops.plane_fit_rows import fit_slots_call

    dev = torch.device("cuda")
    for make in (small_cfg, lambda: _overflowing(small_cfg())):
        scfg, carry, params, seqs = distinct_start(make(), B, duration=0.6)
        steps = [tree_map(lambda x: x.to(dev), s) for s in t_sw.stack_packets(seqs)[:STEPS]]
        carry, params = tree_map(lambda x: x.to(dev), carry), tree_map(lambda x: x.to(dev), params)
        step = t_sw.make_fleet_step(scfg)
        n_claim, n_fit = claim_call.launches, fit_slots_call.launches
        in_place = chain(step, carry, steps, params, keep=False)
        copying = chain(step, carry, steps, params, keep=True)
        torch.cuda.synchronize()
        assert claim_call.launches - n_claim == 2 * STEPS
        assert fit_slots_call.launches - n_fit == 2 * STEPS
        for (c1, o1), (c2, o2) in zip(in_place, copying):
            assert_trees_equal(c1, c2)
            assert_trees_equal(o1, o2)
        assert in_place[-1][0].vm.ptab.device.type == "cuda"


def test_single_filter_step_consumes_its_carry(fleet):
    """``process_scan_any`` on one filter (replica 0 cloned out of the
    fleet): from its second scan on, the map it was given is the map it
    returns."""
    route, scfg, carry, params, steps = fleet
    one = cloned(replica(carry, 0))
    prm = replica(params, 0)
    ptrs = []
    for pk in steps[:3]:
        one, _ = process_scan_any(one, replica(pk, 0), prm, scfg)
        ptrs.append(one.vm.ptab.data_ptr())
    assert ptrs[1] == ptrs[0] and ptrs[2] == ptrs[0]
