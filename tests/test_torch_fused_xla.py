"""The fused path off its kernels vs the JAX package's XLA path, on the CPU.

With a kernel switch off, JAX runs that phase on XLA: the match as
``voxel_map.match_points`` and ``eskf_fused.point_suffstats_compact``
(``_match_compact_stats``), the chain as ``_chain_fused_core`` (a lax.scan
of eskf_fused ops), the insert at the post-update bucket poses through
``insert_points_hinted`` (gated or not) or ``insert_points``.  The port
routes every mix of switches the same way; a cap that is no multiple of
128, which JAX also sends to XLA, keeps the port's kernels.  Each piece is held against its
JAX counterpart from one shared state (the JAX carry after eight scans,
converted), then a whole step with each switch off, and a short run with
every switch off scan by scan.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from legkilo_tpu import config as j_config
from legkilo_tpu import runner as j_runner
from legkilo_tpu.core import filter_deferred as j_fd
from legkilo_tpu.core import voxel_map as jv
from legkilo_tpu.io import dataset as j_ds
from legkilo_tpu.models import sim as j_sim

from legkilo_torch import config as t_config
from legkilo_torch import convert
from legkilo_torch import runner as t_runner
from legkilo_torch.core import filter_deferred as t_fd
from legkilo_torch.core import voxel_map as tv
from legkilo_torch.io import dataset as t_ds
from test_torch_slice import CAPACITY_LOG2, build_packets, make_cfg
from test_torch_voxel_map import cfgs, scene
from torch_util import N, T, assert_maps_match, one_thread  # noqa: F401

_JAX_STEP = jax.jit(j_fd.process_scan_deferred, static_argnums=3)
_JAX_MATCH = jax.jit(j_fd._match_compact_stats, static_argnums=(3, 4))
_JAX_CHAIN = jax.jit(j_fd._chain_fused_core, static_argnums=3)
CAP = 1024
SHARED = 8   # the shared state's scan: the robot is moving, the map holds planes
OFF = dict(use_pallas=False, use_pallas_match=False, use_pallas_insert=False)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def shared():
    """The JAX carry after eight scans of its XLA path from the first frame,
    the same carry and parameters in the port, and both packages' packets
    (IMU and kin) of the following scans."""
    data = j_sim.simulate(j_sim.SimConfig(duration=1.2, scan_points=2500, seed=11))
    jcfg, tcfg = make_cfg(j_config), make_cfg(t_config)
    jraw, jp = build_packets(j_ds, jcfg, data)
    _, tp = build_packets(t_ds, tcfg, data)
    _, jpk = build_packets(j_ds, make_cfg(j_config, use_kin=True), data, use_kin=True)
    _, tpk = build_packets(t_ds, make_cfg(t_config, use_kin=True), data, use_kin=True)
    jr = j_runner.OdometryRunner(jcfg)
    jr._initialize(jraw[0], jp[0])
    jscfg = jr.scfg._replace(**OFF)
    jc = jr.carry
    for i in range(1, SHARED + 1):
        jc, _ = _JAX_STEP(jc, j_ds.to_device_packet(jp[i]), jr.params, jscfg)
    return dict(
        jc=jc, tc=convert.carry_from_numpy(leaves(jc), "cpu"), jparams=jr.params,
        tparams=convert.params_from_numpy(leaves(jr.params), "cpu"),
        jscfg=jscfg, tscfg=t_runner.make_static_config(tcfg)._replace(**OFF),
        jp=jp, tp=tp, jpk=jpk, tpk=tpk,
    )


def packets(shared, i, kin=False):
    jp, tp = (shared["jpk"], shared["tpk"]) if kin else (shared["jp"], shared["tp"])
    return j_ds.to_device_packet(jp[i]), t_ds.to_device_packet(tp[i], "cpu")


def test_xla_match_matches_jax(shared):
    """``_match_compact_stats``: the same compaction, probe and keys exactly;
    the points' rows to rounding; matches and statistics to rounding (a
    match on a gate's edge may flip).  The port's aux is JAX's less
    ``pts_c`` and ``cross_c`` (JAX fields 2 and 4), which no insert reads."""
    jpk, tpk = packets(shared, SHARED + 1)
    js40, jnm, jaux = _JAX_MATCH(shared["jc"], jpk, shared["jparams"], shared["jscfg"], CAP)
    ts40, tnm, taux = t_fd._match_compact_stats(shared["tc"], tpk, shared["tparams"], shared["tscfg"], CAP)
    assert len(taux) == 9 and len(jaux) == 11
    jaux = [x for i, x in enumerate(jaux) if i not in (2, 4)]
    for i in (0, 1, 4, 5, 6, 7, 8):       # order, bidx, mask_c, own keys/slot/found/plane
        np.testing.assert_array_equal(N(taux[i]), np.asarray(jaux[i]), err_msg=str(i))
    assert taux[5].dtype == torch.int32 and taux[1].dtype == torch.int64
    for i in (2, 3):                      # p_i_c, body_cov_c
        np.testing.assert_allclose(N(taux[i]), np.asarray(jaux[i]), rtol=1e-6, atol=1e-7, err_msg=str(i))
    jn, tn = np.asarray(jnm), N(tnm)
    assert tnm.dtype == torch.int32 and jn.sum() > 100
    assert np.abs(tn - jn).max() <= 1
    same = tn == jn
    assert same.sum() >= len(jn) - 2
    assert cs.rel_err(ts40[torch.from_numpy(same)], torch.from_numpy(np.asarray(js40)[same])) <= 1e-4


@pytest.mark.parametrize("kin", [False, True], ids=["imu", "kin"])
def test_chain_fused_core_matches_jax(shared, kin):
    """``_chain_fused_core`` (the bucket loop in eager torch) against the JAX
    lax.scan, on the same statistics; tests/test_torch_chain_warp.py's
    tolerances: poses rel 1e-4, covariances rel 1e-3, counts and clocks
    exact."""
    jpk, tpk = packets(shared, SHARED + 1, kin)
    js40, jnm, _ = _JAX_MATCH(shared["jc"], jpk, shared["jparams"], shared["jscfg"], CAP)
    jscfg = shared["jscfg"]._replace(use_kin=kin)
    tscfg = shared["tscfg"]._replace(use_kin=kin)
    jout = _JAX_CHAIN(shared["jc"], jpk, shared["jparams"], jscfg, js40, jnm)
    tout = t_fd._chain_fused_core(shared["tc"], tpk, shared["tparams"], tscfg, T(js40), T(jnm))
    jcar, tcar = jout[0], tout[0]
    pairs = [(tcar.state.rot, jcar.state.rot, 1e-4), (tcar.state.lin, jcar.state.lin, 1e-4),
             (tcar.cov, jcar.cov, 1e-3)] + [(t, j, tol) for t, j, tol in
                                          zip(tout[1:5], jout[1:5], (1e-4, 1e-4, 1e-3, 1e-3))]
    for i, (t, j, tol) in enumerate(pairs):
        assert cs.rel_err(t, T(j)) <= tol, i
    np.testing.assert_array_equal(N(tout[5]), np.asarray(jout[5]))
    for f in ("last_predict_t", "last_update_t"):
        np.testing.assert_array_equal(N(getattr(tcar, f)), np.asarray(getattr(jcar, f)))


@pytest.mark.parametrize("branch", ["gated_fast", "gated_slow", "fast", "slow"])
def test_insert_points_hinted_matches_jax(rng, branch):
    """Both branches of ``insert_points_hinted``, the gated rows
    (``insert_row_cap`` > 0) and every row, each with the new keys under
    ``insert_new_cap`` (JAX's compacted claim) and over it (its full claim):
    the port's one claim series gives JAX's map slot for slot in each."""
    row_cap = 512 if branch.startswith("gated") else 0
    new_cap = 8 if branch.endswith("slow") else 4096
    jc, tc = cfgs(insert_rounds=2, insert_row_cap=row_cap)
    jc = jc._replace(insert_new_cap=new_cap)
    p, var, mask = scene(rng, 1200)
    jm = jv.insert_points(jv.make_map(jc), jc, p[:600], var[:600], mask[:600])
    q, qv, qm = p[600:], var[600:], mask[600:]
    m = jv.match_points(jm, jc, q, qv, qm)
    own = (m.own_keys, m.own_slot, m.own_found, m.own_plane)
    if row_cap:
        n_new = int(np.sum(np.asarray(jv.gated_insert_rows(jc, qm, *own).need)))
    else:
        n_new = int(np.sum(np.tile(qm, jc.levels) & ~np.asarray(m.own_found).reshape(-1)))
    assert (n_new > new_cap) == branch.endswith("slow") and n_new > 0
    want = jv.insert_points_hinted(jm, jc, q, qv, qm, *own)
    tm = tv.VoxelMap(*(T(np.asarray(x)) for x in jm))
    got = tv.insert_points_hinted(tm, tc, T(q), T(qv), T(qm), *(T(np.asarray(x)) for x in own))
    assert_maps_match(want, got, tc.capacity)
    assert N(got.meta)[:, 3].sum() > 5


@pytest.mark.parametrize("match_cap,row_cap", [(4096, 512), (1100, 1000), (384, 0)])
def test_kernel_route_takes_any_cap(shared, match_cap, row_cap):
    """The fused path's kernel routes follow the switches alone: the port's
    kernels take any row count, so a cap that is no multiple of 128 (which
    sends the JAX package to XLA) keeps its kernels; a zero insert row cap
    or probe reuse off takes the insert off the moments kernel."""
    base = shared["tscfg"]
    on = base._replace(use_pallas=True, use_pallas_match=True, use_pallas_insert=True,
                       match_cap=match_cap, insert_cap=match_cap,
                       map_cfg=base.map_cfg._replace(insert_row_cap=row_cap))
    assert t_fd.kernel_routes(on) == (True, row_cap > 0)
    assert t_fd.kernel_routes(on._replace(insert_reuse_probe=False)) == (True, False)
    assert t_fd.kernel_routes(on._replace(use_pallas_match=False, use_pallas_insert=False)) == (False, False)


@pytest.mark.parametrize("chain_impl", ["fused", "jax"])
def test_return_cloud_matches_jax(shared, chain_impl):
    """``return_cloud`` on both deferred paths: the scan's points at the
    post-update bucket poses, one step from the shared state."""
    jpk, tpk = packets(shared, SHARED + 1)
    jscfg = shared["jscfg"]._replace(return_cloud=True, chain_impl=chain_impl)
    tscfg = shared["tscfg"]._replace(return_cloud=True, chain_impl=chain_impl)
    _, jo = _JAX_STEP(shared["jc"], jpk, shared["jparams"], jscfg)
    _, to = t_fd.process_scan_deferred(shared["tc"], tpk, shared["tparams"], tscfg)
    assert to.cloud_world.shape == tuple(np.asarray(jo.cloud_world).shape) == tuple(tpk.points.shape)
    np.testing.assert_allclose(N(to.cloud_world), np.asarray(jo.cloud_world), atol=2e-4)
    _, to = t_fd.process_scan_deferred(shared["tc"], tpk, shared["tparams"], tscfg._replace(return_cloud=False))
    assert to.cloud_world is None


STEPS = {
    "chain_off": dict(use_pallas=False),
    "match_off": dict(use_pallas_match=False),
    "insert_off": dict(use_pallas_insert=False),
    "match_cap_1100": dict(match_cap=1100, insert_cap=1100),
    "row_cap_1000": dict(row_cap=1000),
    "row_cap_0": dict(row_cap=0),
    "no_probe_reuse": dict(insert_reuse_probe=False),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_step_with_switches_off_matches_jax(shared, name):
    """One step from the shared state with the kernels on but for the named
    change: the pose to 2e-4 m (rounding only), matches within 2, the same
    overflow counts and the same map by key.  A cap that is no multiple of
    128 sends the JAX package to its XLA path, while the port keeps its
    kernels (their plain versions here), so those cases hold the kernel
    route against JAX's XLA route."""
    kw = dict(STEPS[name])
    row_cap = kw.pop("row_cap", None)
    on = dict(use_pallas=True, use_pallas_match=True, use_pallas_insert=True)
    jscfg = shared["jscfg"]._replace(**{**on, **kw})
    tscfg = shared["tscfg"]._replace(**{**on, **kw})
    if row_cap is not None:
        jscfg = jscfg._replace(map_cfg=jscfg.map_cfg._replace(insert_row_cap=row_cap))
        tscfg = tscfg._replace(map_cfg=tscfg.map_cfg._replace(insert_row_cap=row_cap))
    jpk, tpk = packets(shared, SHARED + 1)
    jc, jo = _JAX_STEP(shared["jc"], jpk, shared["jparams"], jscfg)
    tc, to = t_fd.process_scan_deferred(shared["tc"], tpk, shared["tparams"], tscfg)
    np.testing.assert_allclose(N(to.pos), np.asarray(jo.pos), atol=2e-4)
    np.testing.assert_allclose(N(to.rot), np.asarray(jo.rot), atol=2e-4)
    assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= 2 and int(jo.n_matched) > 100
    np.testing.assert_array_equal(N(to.map_overflow), np.asarray(jo.map_overflow))
    assert_maps_match(jc.vm, tc.vm, 1 << CAPACITY_LOG2, exact_slots=False, mom_rtol=1e-4)


def test_all_switches_off_tracks_jax_scan_by_scan():
    """Every kernel switch off (the leg_fusion.yaml route) from the first
    frame, both packages on the same scans, scan by scan:
    tests/test_torch_slice.py's bound, 4x the JAX package's own spread
    between its two paths (kernels off / on, the same algebra rounded
    differently) plus 0.1 mm, and the first scan from the same map to
    rounding."""
    data = j_sim.simulate(j_sim.SimConfig(duration=0.8, scan_points=2500, seed=11))
    jcfg, tcfg = make_cfg(j_config), make_cfg(t_config)
    for c in (jcfg, tcfg):
        c.tpu.use_pallas = c.tpu.use_pallas_match = c.tpu.use_pallas_insert = False
    jraw, jp = build_packets(j_ds, jcfg, data)
    traw, tp = build_packets(t_ds, tcfg, data)
    jr, tr = j_runner.OdometryRunner(jcfg), t_runner.OdometryRunner(tcfg, device="cpu")
    jr._initialize(jraw[0], jp[0])
    tr._initialize(traw[0], tp[0])
    kern = jr.scfg._replace(use_pallas=True, use_pallas_match=True, use_pallas_insert=True)
    jc = kc = jr.carry
    tc = tr.carry
    spread = 0.0
    for i in range(1, 7):
        jpk = j_ds.to_device_packet(jp[i])
        jc, jo = _JAX_STEP(jc, jpk, jr.params, jr.scfg)
        kc, ko = _JAX_STEP(kc, jpk, jr.params, kern)
        tc, to = t_fd.process_scan_deferred(tc, t_ds.to_device_packet(tp[i], "cpu"), tr.params, tr.scfg)
        spread = max(spread, float(np.abs(np.asarray(ko.pos) - np.asarray(jo.pos)).max()))
        tol = 4 * spread + 1e-4
        np.testing.assert_allclose(N(to.pos), np.asarray(jo.pos), atol=tol, err_msg=f"scan {i}")
        np.testing.assert_allclose(N(to.rot), np.asarray(jo.rot), atol=tol, err_msg=f"scan {i}")
        assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= max(3, 0.03 * int(jo.n_matched))
        if i == 1:
            np.testing.assert_allclose(N(to.pos), np.asarray(jo.pos), atol=5e-5)
    assert int(jo.n_matched) > 100 and spread < 1e-2
