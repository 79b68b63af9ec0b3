"""bench.py's configuration in the port vs the JAX package, on the CPU.

All five kernel switches on (chain, match, insert, pose, refit), streaming
and chunked: the JAX package with its kernels in interpret mode, the port on
their plain versions, the same sim scans through the same packetizer.  Also
chunked replay against per-scan stepping, the constant-velocity match pose,
the map slide inside the scan step, and the CLI's ``--pallas --chunk``.
"""

import json

import numpy as np
import pytest
import torch

import jax

from legkilo_tpu import config as j_config
from legkilo_tpu import runner as j_runner
from legkilo_tpu.core import filter_deferred as j_fd
from legkilo_tpu.io import dataset as j_ds
from legkilo_tpu.models import sim as j_sim

from legkilo_torch import config as t_config
from legkilo_torch import convert
from legkilo_torch import runner as t_runner
from legkilo_torch.core import filter as t_filter
from legkilo_torch.core import filter_deferred as t_fd
from legkilo_torch.io import dataset as t_ds
from legkilo_torch.io.tum import ate_rmse
from legkilo_torch.models import sim as t_sim
from test_torch_slice import CAPACITY_LOG2, _JAX_STEP, _spliced, make_cfg, run_both
from torch_util import N, assert_maps_match, one_thread  # noqa: F401

N_SCANS = 8


@pytest.fixture(scope="module")
def five_run():
    return run_both(False, N_SCANS, keep=(3,), with_spread=True, five=True)


def test_five_kernel_slice_tracks_jax_scan_by_scan(five_run):
    """Eight scans with all five switches on: the bound of
    test_torch_slice.test_slice_tracks_jax_scan_by_scan (4x the JAX
    package's own XLA-vs-kernel spread so far, plus 0.1 mm), the first step
    to rounding, and the ATE against the sim's ground truth under the golden
    0.08 m."""
    spread = np.maximum.accumulate(five_run["spread"])
    for i, (jo, to) in enumerate(five_run["steps"], start=1):
        tol = 4 * spread[i - 1] + 1e-4
        np.testing.assert_allclose(N(to.pos), jo.pos, atol=tol, err_msg=f"scan {i}")
        np.testing.assert_allclose(N(to.rot), jo.rot, atol=tol, err_msg=f"scan {i}")
        assert int(N(to.n_points)) == int(jo.n_points)
        assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= max(3, 0.03 * int(jo.n_matched))
        if i == 1:
            np.testing.assert_allclose(N(to.pos), jo.pos, atol=5e-5)
    assert int(five_run["steps"][-1][0].n_matched) > 100
    assert spread[-1] < 1e-2
    data = five_run["data"]
    _, gt = data.gt_in_filter_frame()
    gtm = {round(t, 6): i for i, t in enumerate(data.gt_times)}
    ends = [round(p.end_time, 6) for p in five_run["tp"][1:N_SCANS + 1]]
    est = np.stack([N(to.pos) for _, to in five_run["steps"]])
    assert ate_rmse(est, np.stack([gt[gtm[t]] for t in ends]), align=False) < 0.08


def _port_steps(run, scfg, start, stop, carry):
    outs = []
    for i in range(start, stop):
        carry, out = t_fd.process_scan_deferred(
            carry, t_ds.to_device_packet(run["tp"][i], "cpu"), run["tr"].params, scfg)
        outs.append(out)
    return carry, outs


def test_process_scan_chunk_equals_per_scan_steps(five_run):
    """K = 4 scans in one process_scan_chunk call: bit-identical on the CPU to
    four process_scan_deferred calls, outputs stacked [K, ...]."""
    tr = five_run["tr"]
    c0 = five_run["init"][1]
    c_seq, outs = _port_steps(five_run, tr.scfg, 1, 5, c0)
    devs = [t_ds.to_device_packet(five_run["tp"][i], "cpu") for i in range(1, 5)]
    stacked = t_filter.stack_scan_packets(devs)
    assert stacked.points.shape[0] == 4 and stacked.rebase.shape == (4,)
    c_chk, out_chk = t_filter.process_scan_chunk(c0, stacked, tr.params, tr.scfg)
    for a, b in zip(convert.carry_to_numpy(c_chk), convert.carry_to_numpy(c_seq)):
        np.testing.assert_array_equal(a, b)
    for f in out_chk._fields:
        np.testing.assert_array_equal(N(getattr(out_chk, f)), np.stack([N(getattr(o, f)) for o in outs]))


def test_const_vel_match_pose_matches_jax(five_run):
    """_predicted_bucket_poses_const_vel from a moving state, and one whole
    step with tpu_match_pose = const_vel from the same carry."""
    jc3, _ = five_run["kept"][3]
    tc3 = convert.carry_from_numpy([np.asarray(x) for x in jax.tree.leaves(jc3)], "cpu")
    jpk = j_ds.to_device_packet(five_run["jp"][4])
    tpk = t_ds.to_device_packet(five_run["tp"][4], "cpu")
    rb_j, pb_j = j_fd._predicted_bucket_poses_const_vel(jc3, jpk)
    rb_t, pb_t = t_fd._predicted_bucket_poses_const_vel(tc3, tpk)
    np.testing.assert_allclose(N(rb_t), np.asarray(rb_j), atol=1e-6)
    np.testing.assert_allclose(N(pb_t), np.asarray(pb_j), atol=1e-6)
    jr, tr = five_run["jr"], five_run["tr"]
    _, jo = _JAX_STEP(jc3, jpk, jr.params, jr.scfg._replace(match_pose="const_vel"))
    _, to = t_fd.process_scan_deferred(tc3, tpk, tr.params, tr.scfg._replace(match_pose="const_vel"))
    np.testing.assert_allclose(N(to.pos), np.asarray(jo.pos), atol=2e-4)   # one step: rounding
    assert abs(int(N(to.n_matched)) - int(jo.n_matched)) <= 2


@pytest.mark.parametrize("thresh,fires", [(0.0, True), (100.0, False)])
def test_map_slide_in_the_scan_step_matches_jax(five_run, thresh, fires):
    """map_sliding_en inside process_scan_deferred, from the same carry: a
    trigger that fires (the map keeps a box of 4 level-0 voxels around the
    pose and last_slide_pos moves) and one that does not."""
    jc3, _ = five_run["kept"][3]
    tc3 = convert.carry_from_numpy([np.asarray(x) for x in jax.tree.leaves(jc3)], "cpu")
    jr, tr = five_run["jr"], five_run["tr"]
    kw = dict(map_sliding_en=True, sliding_thresh=thresh, half_map_size=4)
    jc, jo = _JAX_STEP(jc3, j_ds.to_device_packet(five_run["jp"][4]), jr.params, jr.scfg._replace(**kw))
    tc, to = t_fd.process_scan_deferred(tc3, t_ds.to_device_packet(five_run["tp"][4], "cpu"),
                                        tr.params, tr.scfg._replace(**kw))
    occ_j = int((np.asarray(jc.vm.ptab)[:, 3] > 0).sum())
    occ_0 = int((np.asarray(jc3.vm.ptab)[:, 3] > 0).sum())
    assert (occ_j < occ_0) == fires
    assert_maps_match(jc.vm, tc.vm, 1 << CAPACITY_LOG2, exact_slots=False, mom_rtol=1e-4)
    np.testing.assert_allclose(N(tc.last_slide_pos), np.asarray(jc.last_slide_pos), atol=2e-4)
    assert bool(np.any(N(tc.last_slide_pos) != 0.0)) == fires


@pytest.fixture(scope="module")
def short_sim():
    return t_sim.simulate(t_sim.SimConfig(duration=1.2, scan_points=2000, seed=5))


def _no_latch(cfg):
    cfg.tpu.escalate_after = 0
    return cfg


def test_run_offline_chunked_equals_streaming_and_tracks_jax(short_sim):
    """run_offline(chunk=4) over 12 scans (two full chunks, a shorter last one):
    the port's streaming run with the escalation latch off bit for bit, and
    JAX run_offline(chunk=4) within 1 cm (the bound
    test_run_offline_gap_reset_matches_jax holds over as many scans)."""
    tcfg = _no_latch(make_cfg(t_config, five=True))
    chunked = t_runner.run_offline(tcfg, short_sim.scans, short_sim.imu, device="cpu", chunk=4)
    stream = t_runner.run_offline(tcfg, short_sim.scans, short_sim.imu, device="cpu")
    assert len(chunked) == len(stream) >= 11
    for a, b in zip(chunked, stream):
        assert a.time == b.time and a.n_matched == b.n_matched and a.n_points == b.n_points
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.rot, b.rot)
    jdata = j_sim.simulate(j_sim.SimConfig(duration=1.2, scan_points=2000, seed=5))
    jres = j_runner.run_offline(make_cfg(j_config, five=True), jdata.scans, jdata.imu, chunk=4)
    assert [r.time for r in jres] == [r.time for r in chunked]
    assert [r.n_points for r in jres] == [r.n_points for r in chunked]
    for rt, rj in zip(chunked, jres):
        np.testing.assert_allclose(rt.pos, rj.pos, atol=1e-2)
        np.testing.assert_allclose(rt.rot, rj.rot, atol=1e-2)
    assert chunked[-1].n_matched > 100


def test_chunked_replay_splits_at_a_gap_packet(monkeypatch, caplog):
    """A 20 s sensor gap after scan 4 with chunk = 3: the chunk that would
    hold the gap packet is cut before it (a chunk of one), the soft reset
    lands between the calls, and the trajectory is the streaming run's bit
    for bit."""
    sizes = []
    real = t_runner.process_scan_chunk

    def counting(carry, packets, params, scfg):
        sizes.append(int(packets.points.shape[0]))
        return real(carry, packets, params, scfg)

    monkeypatch.setattr(t_runner, "process_scan_chunk", counting)
    tcfg = _no_latch(make_cfg(t_config, five=True))
    scans, events = _spliced(t_sim, t_ds, 4, 20.0)
    chunked = t_runner.run_offline(tcfg, scans, events, device="cpu", chunk=3)
    assert "soft reset (chunked replay)" in caplog.text
    # Packets 1-3 fill a chunk; packet 4 stands alone before the gap packet 5.
    assert sizes[:3] == [3, 1, 3] and sum(sizes) == len(chunked) - 1 and max(sizes) == 3
    stream = t_runner.run_offline(tcfg, scans, events, device="cpu")
    assert len(stream) == len(chunked)
    for a, b in zip(chunked, stream):
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.rot, b.rot)


def test_cli_sim_pallas_chunk(capsys, tmp_path):
    """``sim --pipeline deferred --pallas --chunk 8`` on the CPU: all five
    switches through the chunked entry (with an insert row cap, which the
    moments kernel needs)."""
    from legkilo_torch import cli

    path = tmp_path / "rowcap.yaml"
    path.write_text("tpu_map_insert_row_cap: 4096\n")
    assert cli.main(["sim", "--device", "cpu", "--pipeline", "deferred", "--pallas", "--chunk", "8",
                     "--config_file", str(path), "--duration", "1.3", "--scan_points", "1500"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["scans"] >= 12 and line["ate_rmse_m"] < 0.08


def test_bench_config_is_bench_py_configuration():
    tp = t_runner.bench_config().tpu
    assert all([tp.use_pallas, tp.use_pallas_match, tp.use_pallas_insert, tp.use_pallas_pose,
                tp.use_pallas_refit])
    scfg = t_runner.make_static_config(t_runner.bench_config())
    assert scfg.use_pallas_pose and scfg.map_cfg.use_pallas_refit and scfg.map_cfg.refit_budget == 1024
    assert torch.get_float32_matmul_precision() == "highest"
