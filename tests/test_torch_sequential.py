"""The sequential pipeline (the JAX package's default) vs the JAX package, on the CPU.

``process_scan`` walks a scan's buckets one after the other: the bucket's
IMU or kinematic events, then predict, match, point update and insert
(KILO.cc:108-233, 373-395).  The port runs it as a Python loop over the
buckets, JAX as a lax.scan.  Held here: one bucket from a shared state,
whole scans scan by scan (IMU and kin), chunked replay against scan-by-scan
stepping, and the runner end to end, with its world clouds.
"""

import jax
import numpy as np
import pytest
import torch

from legkilo_tpu import config as j_config
from legkilo_tpu import runner as j_runner
from legkilo_tpu.core import filter as j_filter
from legkilo_tpu.io import dataset as j_ds
from legkilo_tpu.models import sim as j_sim

from legkilo_torch import config as t_config
from legkilo_torch import convert
from legkilo_torch import runner as t_runner
from legkilo_torch.core import filter as t_filter
from legkilo_torch.io import dataset as t_ds
from legkilo_torch.models import sim as t_sim
from test_torch_slice import CAPACITY_LOG2, build_packets, make_cfg
from torch_util import N, assert_maps_match, cloned, one_thread  # noqa: F401

N_SCANS = 5
_JAX_SCAN = jax.jit(j_filter.process_scan, static_argnums=3)
_JAX_BUCKET = jax.jit(j_filter._point_bucket, static_argnums=2)


def seq_cfg(mod, use_kin=False):
    """tests/test_torch_slice.py's small configuration on the sequential
    pipeline (NB 28, P 64, K 1, three levels of 2^11 slots)."""
    cfg = make_cfg(mod, use_kin)
    cfg.tpu.pipeline = "sequential"
    return cfg


def run_both(use_kin):
    """First frame and N_SCANS sequential scans in both packages from the
    same packets; returns the per-scan outputs and the carries after scan 2."""
    data = j_sim.simulate(j_sim.SimConfig(duration=(N_SCANS + 2) * 0.1, scan_points=2500, seed=11))
    jcfg, tcfg = seq_cfg(j_config, use_kin), seq_cfg(t_config, use_kin)
    jraw, jp = build_packets(j_ds, jcfg, data, use_kin)
    traw, tp = build_packets(t_ds, tcfg, data, use_kin)
    jr, tr = j_runner.OdometryRunner(jcfg), t_runner.OdometryRunner(tcfg, device="cpu")
    jr._initialize(jraw[0], jp[0])
    tr._initialize(traw[0], tp[0])
    jc, tc = jr.carry, cloned(tr.carry)
    out = dict(jp=jp, tp=tp, jr=jr, tr=tr, steps=[])
    for i in range(1, N_SCANS + 1):
        jc, jo = _JAX_SCAN(jc, j_ds.to_device_packet(jp[i]), jr.params, jr.scfg)
        tc, to = t_filter.process_scan_any(tc, t_ds.to_device_packet(tp[i], "cpu"), tr.params, tr.scfg)
        out["steps"].append((jax.tree.map(np.asarray, jo), to))
        if i == 2:
            out["kept"] = jc
    return out


@pytest.fixture(scope="module")
def imu_run():
    return run_both(False)


def test_point_bucket_matches_jax(imu_run):
    """One bucket from the JAX carry after scan 2: predict, match, update
    and insert give the same state to rounding, the same matches, world
    points and map (the claiming insert: the same slots)."""
    jc = imu_run["kept"]
    jr, tr = imu_run["jr"], imu_run["tr"]
    tc = convert.carry_from_numpy([np.asarray(x) for x in jax.tree.leaves(jc)], "cpu")
    params = convert.params_from_numpy([np.asarray(x) for x in jax.tree.leaves(jr.params)], "cpu")
    jpk, tpk = j_ds.to_device_packet(imu_run["jp"][3]), t_ds.to_device_packet(imu_run["tp"][3], "cpu")
    jc = jc._replace(last_predict_t=jc.last_predict_t - jpk.rebase, last_update_t=jc.last_update_t - jpk.rebase)
    tc = tc._replace(last_predict_t=tc.last_predict_t - tpk.rebase, last_update_t=tc.last_update_t - tpk.rebase)
    b = int(np.argmax(imu_run["jp"][3].point_mask.sum(axis=1)))   # the fullest bucket
    jc2, jn, jproc, jpw = _JAX_BUCKET(jc, jr.params, jr.scfg, jpk.bucket_time[b], jpk.bucket_mask[b],
                                      jpk.points[b], jpk.point_mask[b])
    tc2, tn, tproc, tpw = t_filter._point_bucket(tc, params, tr.scfg, tpk.bucket_time[b], tpk.bucket_mask[b],
                                                 tpk.points[b], tpk.point_mask[b])
    assert int(jn) > 5 and int(N(tn)) == int(jn) and int(N(tproc)) == int(jproc)
    np.testing.assert_allclose(N(tc2.state.lin), np.asarray(jc2.state.lin), atol=1e-6)
    np.testing.assert_allclose(N(tc2.state.rot), np.asarray(jc2.state.rot), atol=1e-6)
    np.testing.assert_allclose(N(tc2.cov), np.asarray(jc2.cov), rtol=1e-4, atol=1e-10)
    for f in ("last_predict_t", "last_update_t"):
        np.testing.assert_array_equal(N(getattr(tc2, f)), np.asarray(getattr(jc2, f)))
    np.testing.assert_allclose(N(tpw), np.asarray(jpw), atol=1e-5)
    assert_maps_match(jc2.vm, tc2.vm, 1 << CAPACITY_LOG2)


def check_scan_by_scan(run):
    """The first scan from the same map agrees to rounding (5e-5 m); later
    scans part as rounding differences feed back through the map, as the
    deferred path's do (tests/test_torch_slice.py), so 1 mm."""
    for i, (jo, to) in enumerate(run["steps"], start=1):
        tol = 5e-5 if i == 1 else 1e-3
        np.testing.assert_allclose(N(to.pos), jo.pos, atol=tol, err_msg=f"scan {i}")
        np.testing.assert_allclose(N(to.rot), jo.rot, atol=tol, err_msg=f"scan {i}")
        assert int(N(to.n_points)) == int(jo.n_points)
        assert int(N(to.n_cap_dropped)) == int(jo.n_cap_dropped) == 0
        assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= max(3, 0.03 * int(jo.n_matched))
    assert int(run["steps"][-1][0].n_matched) > 100


def test_process_scan_tracks_jax(imu_run):
    check_scan_by_scan(imu_run)


def test_kin_process_scan_tracks_jax():
    check_scan_by_scan(run_both(True))


def test_process_scan_chunk_is_process_scan_any(imu_run):
    """process_scan_chunk on the sequential pipeline: the same carry and
    outputs as one process_scan_any call a scan, bit for bit."""
    tr = imu_run["tr"]
    pkts = [t_ds.to_device_packet(p, "cpu") for p in imu_run["tp"][1:4]]
    carry0 = tr.carry
    c_chunk, o_chunk = t_filter.process_scan_chunk(cloned(carry0), t_filter.stack_scan_packets(pkts),
                                                   tr.params, tr.scfg)
    c, outs = carry0, []
    for pk in pkts:
        c, o = t_filter.process_scan_any(c, pk, tr.params, tr.scfg)
        outs.append(o)
    for a, b in zip(convert.carry_leaves(c_chunk), convert.carry_leaves(c)):
        assert torch.equal(a, b)
    for k, o in enumerate(outs):
        for name in ("rot", "pos", "n_matched", "n_points", "n_cap_dropped", "map_overflow"):
            assert torch.equal(getattr(o_chunk, name)[k], getattr(o, name)), name
    assert o_chunk.cloud_world is None


def test_runner_on_sequential_pipeline_matches_jax():
    """run_offline on both packages with the sequential pipeline: the same
    scans and valid-point counts, poses within 1 cm over 7 scans (they part
    by millimetres, see check_scan_by_scan), and with return_cloud the same
    registered clouds of the valid points; the escalation latch is off, as
    in the JAX runner, and chunked replay refuses return_cloud."""
    jcfg, tcfg = seq_cfg(j_config), seq_cfg(t_config)
    jdata = j_sim.simulate(j_sim.SimConfig(duration=0.8, scan_points=2000, seed=5))
    tdata = t_sim.simulate(t_sim.SimConfig(duration=0.8, scan_points=2000, seed=5))
    jres = j_runner.run_offline(jcfg, jdata.scans, jdata.imu, return_cloud=True)
    tres = t_runner.run_offline(tcfg, tdata.scans, tdata.imu, device="cpu", return_cloud=True)
    assert len(tres) == len(jres) >= 6
    assert [r.n_points for r in tres] == [r.n_points for r in jres]
    for rt, rj in zip(tres, jres):
        np.testing.assert_allclose(rt.pos, rj.pos, atol=1e-2)
        np.testing.assert_allclose(rt.rot, rj.rot, atol=1e-2)
        if rj.cloud_world is None:   # the first frame
            assert rt.cloud_world is None
            continue
        assert rt.cloud_world.shape == rj.cloud_world.shape and rt.cloud_world.shape[1] == 3
        np.testing.assert_allclose(rt.cloud_world, rj.cloud_world, atol=2e-2)
        assert (rt.intensity is None) == (rj.intensity is None)
    assert not t_runner.OdometryRunner(tcfg, device="cpu")._esc_enabled
    with pytest.raises(ValueError, match="return_cloud"):
        t_runner.run_offline(tcfg, tdata.scans, tdata.imu, device="cpu", chunk=4, return_cloud=True)
