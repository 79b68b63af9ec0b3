"""The fleet on every configuration (``core/filter_fleet.py``'s one route,
the JAX package's ``vmap(process_scan_any)``) on the CPU.

A fleet step is the single step given a leading replica axis, on every
route: the sequential pipeline (IMU and kinematic events), the fused path
with every kernel switch off and with the match off alone, the per-point
path (IMU and kin), the constant-velocity match pose and ``return_cloud``
on both pipelines.  Each route's fleet of B = 3 distinct sims, each
replica with its own process noise, holds each replica against its own
single ``process_scan_any`` over 2 scans:

* integer outputs (``n_matched``, ``n_points``, ``n_cap_dropped``,
  ``map_overflow``, ``ocnt``) and the maps' key and occupancy tables are
  equal on every route;
* on the routes whose products keep their single-run shapes (the fused
  path, the per-point path) every float is ``torch.equal`` as well;
* on the sequential pipeline the ESKF's products of small matrices become
  batched products (the 3x3 and 6x6 products of ``exp_so3``,
  ``transition_fx``, ``inv6`` and the boxplus, the 6x6 information matrix
  and gain of ``update_by_points``, the 3x3 sandwiches of ``_point_vars``),
  which round apart from the unbatched ones on the CPU: pos, rot, the rest
  of the state and the clouds within 1e-5 absolute, the covariance within
  1e-6 absolute plus 1e-6 of the entry (the spread reaches 9.7e-7 on
  entries up to 0.31 over two scans), the clocks equal.

The sequential fleet also tracks the JAX package's ``make_fleet_step`` (its
``vmap``) at tests/test_torch_fleet.py's bounds, and chunked stepping equals
per-scan stepping on it.  The tests marked ``cuda`` repeat the per-point
kernel's replica axis and each route's launches a fleet step on a card.
The small configuration is tests/test_torch_fleet.py's ``small_cfg`` with
buckets of 12.5 ms, so that a scan's events (and, with leg kinematics,
its feet in contact) and most of its points land in the 8 buckets.
"""

import numpy as np
import pytest
import torch

from legkilo_torch.core import filter as t_filter
from legkilo_torch.core import filter_deferred as t_fd
from legkilo_torch.core.filter import process_scan_any
from legkilo_torch.core.filter_fleet import replica
from legkilo_torch.parallel import sweep as t_sw
from test_torch_fleet import count_calls, distinct_start, small_cfg
from torch_util import N, one_thread  # noqa: F401

B = 3
SCANS = 2
POS_ATOL = 1e-5
COV_ATOL = 1e-6
COV_RTOL = 1e-6  # the spread reaches 9.7e-7 on entries up to 0.31 in 2 scans


def _kin(cfg):
    cfg.only_imu_use = False
    return cfg


def _points(cfg):
    cfg.tpu.chain_impl = "jax"
    return cfg


def _five_but_match(cfg):
    cfg.tpu.use_pallas_match = False
    return cfg


def _const_vel(cfg):
    cfg.tpu.match_pose = "const_vel"
    return cfg


def _pose_refit(cfg):
    cfg.tpu.use_pallas_pose = True
    cfg.tpu.use_pallas_refit = True
    return cfg


# route: (pipeline, kernel switches on, edits, return_cloud, every float bit-equal)
ROUTES = {
    "sequential": ("sequential", False, (), False, False),
    "sequential_kin": ("sequential", False, (_kin,), False, False),
    "fused_off_kin": ("deferred", False, (_kin,), False, True),
    "fused_match_off": ("deferred", True, (_five_but_match,), False, True),
    "points": ("deferred", False, (_points, _pose_refit), False, True),
    "points_kin": ("deferred", False, (_points, _kin), False, True),
    "const_vel": ("deferred", False, (_const_vel,), False, True),
    "cloud_fused": ("deferred", False, (), True, True),
    "cloud_sequential": ("sequential", False, (), True, False),
}


QUANTUM_MS = 12.5  # 8 buckets of 12.5 ms span a scan, so its events and most points land in them


def route_cfg(route):
    pipeline, five, edits, _, _ = ROUTES[route]
    cfg = small_cfg(five=five, pipeline=pipeline)
    cfg.tpu.bucket_quantum_ms = QUANTUM_MS
    for edit in edits:
        cfg = edit(cfg)
    return cfg


def _leaves(tree, prefix=""):
    """(dotted field name, tensor) for every tensor of a NamedTuple tree."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f, x in zip(tree._fields, tree) for kv in _leaves(x, prefix + f + ".")]
    return [(prefix[:-1], tree)]


def assert_replica_matches(single, fleet_r, exact):
    """One replica's fleet outputs or carry against its single run's:
    integers and the maps' key/occupancy columns equal; with ``exact``
    every tensor ``torch.equal``, else the poses, states and clouds within
    POS_ATOL, the covariance within COV_ATOL + COV_RTOL |entry| and the
    clocks equal (module doc)."""
    got, want = _leaves(fleet_r), _leaves(single)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, x), (_, y) in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if exact:
            assert torch.equal(x, y), name
        elif name == "vm.ptab":
            assert torch.equal(x[..., 0:4], y[..., 0:4]), name  # keys and occupancy
        elif name == "vm.meta":
            assert torch.equal(x[..., 0], y[..., 0]), name      # a slot's point count
        elif name in ("vm.mom", "vm.moms", "vm.plane"):
            continue                                           # sums of the rounded points
        elif not x.is_floating_point() or name.endswith("_t"):
            assert torch.equal(x, y), name
        elif name == "cov":
            err = (x - y).abs() - COV_RTOL * y.abs()
            assert float(err.max()) <= COV_ATOL, f"cov: max err {float((x - y).abs().max()):.3g}"
        else:
            err = float((x - y).abs().max()) if x.numel() else 0.0
            assert err <= POS_ATOL, f"{name}: max abs err {err:.3g} > {POS_ATOL}"


def fleet_and_singles(cfg, return_cloud=False, b=B, scans=SCANS):
    """A fleet of ``b`` distinct sims with perturbed q_diag, stepped
    ``scans`` times: (scfg, carry0, params, steps, fleet outputs, fleet
    carry)."""
    scfg, carry0, params, seqs = distinct_start(cfg, b, duration=0.4)
    scfg = scfg._replace(return_cloud=return_cloud)
    params = t_sw.perturb_params(replica(params, 0), b, scale=0.2, seed=1)._replace(
        g_over_acc_norm=params.g_over_acc_norm)
    steps = t_sw.stack_packets(seqs)[:scans]
    assert len(steps) == scans
    step = t_sw.make_fleet_step(scfg, with_stats=False)
    carry, outs = carry0, []
    for pk in steps:
        carry, out, _ = step(carry, pk, params)
        outs.append(out)
    return scfg, carry0, params, steps, outs, carry


@pytest.mark.parametrize("route", list(ROUTES))
def test_fleet_route_equals_single_runs(route, monkeypatch):
    """Every replica of a B = 3 fleet against its own single run over 2
    scans, on each route the fleet used to loop (module doc); each fleet
    step is one single step given the leading axis (the route's step runs
    once a fleet step)."""
    cfg = route_cfg(route)
    return_cloud, exact = ROUTES[route][3:]
    name = "process_scan" if cfg.tpu.pipeline == "sequential" else "process_scan_deferred"
    calls = count_calls(monkeypatch, t_filter if name == "process_scan" else t_fd, name)
    scfg, carry0, params, steps, outs, carry = fleet_and_singles(cfg, return_cloud)
    monkeypatch.undo()
    assert len(calls) == SCANS
    assert int(sum(o.n_matched.sum() for o in outs)) > 0
    assert (outs[0].cloud_world is None) != return_cloud
    if return_cloud:
        assert outs[0].cloud_world.shape == (B,) + tuple(steps[0].points.shape[1:])
    for r in range(B):
        c = replica(carry0, r)
        for k, pk in enumerate(steps):
            c, o = process_scan_any(c, replica(pk, r), replica(params, r), scfg)
            assert_replica_matches(o, replica(outs[k], r), exact)
        assert_replica_matches(c, replica(carry, r), exact)


def test_sequential_fleet_chunk_equals_per_scan_stepping():
    """The sequential pipeline's fleet of 2, K = 2 scans a call, equals two
    per-scan fleet steps (outputs stacked [B, K, ...], final carry), bit for
    bit."""
    cfg = route_cfg("sequential")
    scfg, carry0, params, seqs = distinct_start(cfg, 2, duration=0.4)
    steps = t_sw.stack_packets(seqs)[:2]
    step = t_sw.make_fleet_step(scfg, with_stats=False)
    c1, per_scan = carry0, []
    for pk in steps:
        c1, out, _ = step(c1, pk, params)
        per_scan.append(out)
    (chunk,) = t_sw.stack_fleet_chunks(steps, 2)
    c2, outs, stats = t_sw.make_fleet_chunk_step(scfg)(carry0, chunk, params)
    assert_replica_matches(c1, c2, exact=True)
    for k, out in enumerate(per_scan):
        assert_replica_matches(out, t_sw.tree_map(lambda x: x[:, k], outs), exact=True)
    assert torch.equal(stats.mean_pos, per_scan[-1].pos.mean(dim=0))


def test_sequential_fleet_tracks_jax_make_fleet_step():
    """The sequential pipeline's fleet (``Config()``'s pipeline, the JAX
    ``sweep`` default) against the JAX package's ``make_fleet_step`` on the
    same packets, the carry handed across by ``convert``: one map boot, B =
    2, three fleet steps, on tests/test_torch_fleet.py's configuration and
    at its bounds (pos rtol/atol 2e-3, mean_matched atol 3)."""
    import jax
    import jax.numpy as jnp

    from legkilo_tpu.core import eskf as j_eskf
    from legkilo_tpu.core.filter import FilterParams as JParams
    from legkilo_tpu.io.dataset import PacketBuilder as JBuilder
    from legkilo_tpu.io.dataset import to_device_packet as j_to_device
    from legkilo_tpu.models import sim as j_sim
    from legkilo_tpu.parallel import sweep as j_sw
    from legkilo_tpu.runner import make_static_config as j_static
    from test_fleet_pallas import _build

    from legkilo_torch import convert
    from legkilo_torch.core.filter import ScanPacket, first_frame_map, init_carry
    from legkilo_torch.runner import make_static_config

    b = 2
    _, jcfg = _build(False)
    jcfg.tpu.pipeline = "sequential"
    scfg_j = j_static(jcfg)
    jparams = j_sw.perturb_params(JParams(
        noise=j_eskf.make_noise_params(jcfg.eskf), ext_r=jnp.eye(3),
        ext_t=jnp.asarray([0.0, 0.0, 0.2]), g_over_acc_norm=jnp.asarray(1.0)), b, scale=0.0)
    data = j_sim.simulate(j_sim.SimConfig(duration=0.6, scan_points=4000, seed=3))
    builder = JBuilder(jcfg)
    for ev in data.imu:
        builder.add_imu(ev)
    jdev = []
    for s in data.scans:
        builder.add_scan(s)
        while builder.ready():
            jdev.append(j_to_device(builder.pop()))
    tdev = [ScanPacket(*(torch.from_numpy(np.array(x, order="C")) for x in p)) for p in jdev]

    scfg = make_static_config(small_cfg(five=False, pipeline="sequential"))
    assert scfg.pipeline == "sequential"
    params = convert.params_from_numpy([np.asarray(x) for x in jax.tree.leaves(jparams)], "cpu")
    one = first_frame_map(init_carry(scfg, "cpu"), scfg, replica(params, 0),
                          tdev[0].points.reshape(-1, 3), tdev[0].point_mask.reshape(-1))
    carry = t_sw.tree_map(lambda x: x.expand((b,) + tuple(x.shape)).clone(), one)
    jcarry = jax.tree.unflatten(jax.tree.structure(j_sw.batched_carry(scfg_j, b)),
                                [jnp.asarray(x) for x in convert.carry_to_numpy(carry)])

    jstep, tstep = j_sw.make_fleet_step(scfg_j), t_sw.make_fleet_step(scfg)
    for jp, tp in zip(jdev[1:4], tdev[1:4]):
        jcarry, _, jstats = jstep(jcarry, j_sw.broadcast_packets(jp, b), jparams)
        carry, _, tstats = tstep(carry, t_sw.broadcast_packets(tp, b), params)
    assert float(jstats.mean_matched) > 0 and float(tstats.mean_matched) > 0
    np.testing.assert_allclose(float(tstats.mean_matched), float(jstats.mean_matched), atol=3.0)
    np.testing.assert_allclose(N(carry.state.pos), np.asarray(jcarry.state.pos), rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------------ card --


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_kin", [False, True], ids=["imu", "kin"])
def test_per_point_chain_fleet_equals_single_launches_on_card(cuda_device, use_kin):
    """The per-point chain kernel at B = 8 distinct replicas of the
    ``points`` shapes (NB 28, P 256): one launch equals 8 single launches,
    bit for bit, in each branch."""
    import chip_smoke

    chip_smoke.phase_build()
    cases = chip_smoke._fleet_kernel_cases(torch, cuda_device, np.random.default_rng(5), 8)
    fargs, singles, call, fleet_of, _, _ = cases["chain_points_kin" if use_kin else "chain_points"]
    got, want = call(fargs), fleet_of([call(s) for s in singles])
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["fleet_seq", "fleet_leg_fusion", "fleet_points"])
def test_fleet_route_launches_do_not_grow_with_b_on_card(cuda_device, phase):
    """Each newly batched route's launches a fleet step at B = 8 within 10 %
    of B = 1 (chip_smoke's route phases, cut to their launch counts)."""
    import chip_smoke

    chip_smoke.phase_build()
    per_step = chip_smoke.route_launches(torch, phase)
    assert per_step[8] <= 1.1 * per_step[1], per_step
